"""DDPM pretraining task: port of ``siss_tpu/tasks/train_unconditional.py``.

ε-MSE (or SNR-weighted sample-prediction) training with EMA, periodic
sample panels, checkpoint bundles with rotation, resume and preemption
handling. ``steps_per_call = K > 1`` runs K steps between the loop's
bookkeeping, as the JAX package's folded steps do, and logs their mean.
``train_batch_size`` is the global batch: under several ranks each loads
its stripe of the index stream (``make_rank_sampler``).
"""

from __future__ import annotations

import time

import torch

from siss_tpu_torch.data import BatchLoader, InfiniteSampler
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.parallel import make_rank_sampler, process_batch_slice, rank_rows, shard_module
from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.train import TrainState, build_optimizer, build_pretrain_step, unet_eps_apply
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard


class TrainUnconditional(Task):
    def run(self) -> None:
        cfg = self.cfg
        tracker = self.make_tracker()
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.random_seed))

        dataset = self.build_dataset(cfg.dataset)
        model, ucfg = self.build_unet()
        sharding = shard_module(model, self.mesh)  # siss_tpu/tasks/train_unconditional.py:44
        schedule = self.build_schedule()

        bs = int(cfg.train_batch_size)
        total_steps = int(cfg.num_epochs) * max(len(dataset) // bs, 1)
        opt, lr_schedule = build_optimizer(cfg.optimizer, model.parameters(),
                                           str(cfg.lr_scheduler), int(cfg.lr_warmup_steps),
                                           total_steps, sharding=sharding)
        use_ema = bool(cfg.ema.use_ema)
        state = TrainState.create(model, opt, lr_schedule, use_ema=use_ema, sharding=sharding)
        step_fn = build_pretrain_step(
            unet_eps_apply, schedule, prediction_type=str(schedule.prediction_type),
            ema_inv_gamma=float(cfg.ema.ema_inv_gamma), ema_power=float(cfg.ema.ema_power),
            ema_max_decay=float(cfg.ema.ema_max_decay))
        random_flip = bool(cfg.get("random_flip"))

        def one_step(batch):
            if random_flip:  # horizontal flip, the reference's torchvision transform
                flip = rank_rows(torch.rand((bs, 1, 1, 1), generator=gen, device=self.device),
                                 mesh=self.mesh) < 0.5
                batch = torch.where(flip, batch.flip(2), batch)
            return step_fn(state, batch, gen)[1]

        steps_per_call = max(int(cfg.get("steps_per_call", 1) or 1), 1)
        ckpt = CheckpointManager(str(cfg.output_dir), cfg.get("checkpoints_total_limit"),
                                 async_save=bool(cfg.get("async_checkpointing", False)))
        global_step = 0
        if cfg.get("resume_from_checkpoint"):
            rpath = str(cfg.resume_from_checkpoint)
            self.restore(state, gen, ckpt.restore_item(rpath, "state"))
            global_step = state.step

        evaluator = Evaluator(unet_eps_apply, schedule,
                              (ucfg.sample_size, ucfg.sample_size, ucfg.in_channels),
                              num_inference_steps=int(cfg.pipeline.num_inference_steps),
                              random_seed=int(cfg.random_seed),
                              solver=str(cfg.pipeline.get("solver", "ddpm")), mesh=self.mesh)
        loader = BatchLoader(dataset, make_rank_sampler(InfiniteSampler, len(dataset),
                                                        seed=int(cfg.random_seed), mesh=self.mesh),
                             process_batch_slice(bs, self.mesh), skip_batches=global_step)
        it = iter(loader)
        guard = PreemptionGuard().install()
        t_last = time.time()
        last_logged_step = global_step
        stop = False
        while global_step < total_steps:
            stop = self.should_stop(guard)
            if stop:
                ckpt.save_bundle(global_step, self.bundle(state, gen))
                print(f"[preemption] saved checkpoint-{global_step}; exiting")
                break
            k_done = min(steps_per_call, total_steps - global_step)
            metrics = [self.timed(self.step_seconds, one_step, self.to_device(next(it)))
                       for _ in range(k_done)]
            prev_step, global_step = global_step, global_step + k_done

            if global_step - last_logged_step >= 50 or last_logged_step == 0:
                dt = time.time() - t_last
                t_last = time.time()
                n_steps = global_step - last_logged_step
                tracker.log({k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
                            | {"images_per_sec": n_steps * bs / dt if last_logged_step > 0 else 0.0},
                            step=global_step)
                last_logged_step = global_step

            if int(cfg.sampling_steps) and boundary_crossed(prev_step, global_step,
                                                            cfg.sampling_steps):
                imgs = self.timed(self.eval_seconds, evaluator.sample_images,
                                  self.eval_model(state), int(cfg.eval_batch_size),
                                  set_generator=True)
                tracker.log_images("Sampled Images", Evaluator.make_grid_from_images(imgs),
                                   step=global_step)
            if boundary_crossed(prev_step, global_step, cfg.get("checkpointing_steps")):
                ckpt.save_bundle(global_step, self.bundle(state, gen))

        if not stop:
            ckpt.save_bundle(global_step, self.bundle(state, gen))
        ckpt.wait()
        tracker.finish()
