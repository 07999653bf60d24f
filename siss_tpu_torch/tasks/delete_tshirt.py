"""MNIST t-shirt unlearning task: port of ``siss_tpu/tasks/delete_tshirt.py``.

Dual keep/forget infinite streams feed the fused deletion train step (SISS
mixture by default, full-range timesteps), starting from the pretrain
bundle's ``unet_ema`` weights. Every ``sampling_steps`` steps it samples
``eval_images`` images, logs a panel and the t-shirt fraction from the L2
detector, and the first step at which that fraction is 0 goes into the
summary as ``deletion_steps``. The likelihood, membership and Inception
Score metrics are not ported yet and raise when configured, as do the loss
functions whose ``superfactor`` decay the JAX task schedules (the step
raises for every loss but the fused SISS one). ``steps_per_call = K`` runs
K steps between the evaluation and checkpoint gates, which fire on
boundary crossings as in the JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from siss_tpu_torch.config import to_dict
from siss_tpu_torch.data import BatchLoader, InfiniteSampler, dual_stream
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.metrics import TShirtClassifier
from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, unet_eps_apply)
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard


def _check_metrics_ported(metrics_cfg) -> None:
    for key in ("likelihood", "membership_loss", "inception_score"):
        if metrics_cfg.get(key):
            raise NotImplementedError(
                f"metrics.{key} is not ported yet (ROADMAP Queue 1 item 9); "
                f"pass metrics.{key}=null")


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path), np.float32) / 255.0
    return img[..., None] if img.ndim == 2 else img


class DeleteTShirt(Task):
    def run(self) -> None:
        cfg = self.cfg
        metrics_cfg = cfg.get("metrics") or {}
        _check_metrics_ported(metrics_cfg)
        tracker = self.make_tracker()
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.random_seed))

        dataset_all = self.build_dataset(cfg.dataset_all)
        dataset_deletion = self.build_dataset(cfg.dataset_deletion)
        model, ucfg = self.build_unet()
        schedule = self.build_schedule()

        # The pretrained start: the bundle's subfolder (unet_ema by default).
        if cfg.get("checkpoint_path"):
            path = str(cfg.checkpoint_path).rstrip("/")
            root, leaf = os.path.split(path)
            mgr = CheckpointManager(root if leaf == "latest" else os.path.dirname(path) or ".")
            subfolder = str(cfg.subfolders.get("unet", "unet"))
            model.load_state_dict(mgr.restore_item("latest" if leaf == "latest" else path,
                                                   subfolder))

        training_steps = int(cfg.training_steps)
        opt, lr_schedule = build_optimizer(cfg.optimizer, model.parameters(),
                                           str(cfg.lr_scheduler), int(cfg.lr_warmup_steps),
                                           training_steps)
        step_cfg = DeletionStepConfig(
            loss_fn=str(cfg.deletion.loss_fn),
            loss_params=tuple(sorted(to_dict(cfg.deletion.get("loss_params") or {}).items())),
            scaling_norm=float(cfg.deletion.get("scaling_norm", 1.0)),
            eta=float(cfg.deletion.get("eta", 1e-3)),
            grad_accum_steps=int(cfg.get("gradient_accumulation_steps", 1)),
            t_min=int(cfg.deletion.get("t_min", 0)),
            t_max=int(cfg.deletion.get("t_max", schedule.num_train_timesteps)),
            use_ema=bool(cfg.ema.use_ema),
            batched_dual_backward=bool(cfg.deletion.get("batched_dual_backward", False)),
            grad_accum_dtype=str(cfg.deletion.get("grad_accum_dtype", "float32")),
            param_cast_dtype=cfg.deletion.get("param_cast_dtype"),
            fused_surgery=bool(cfg.deletion.get("fused_surgery", True)),
        )
        step_fn = build_deletion_train_step(unet_eps_apply, schedule, step_cfg)
        state = TrainState.create(model, opt, lr_schedule, use_ema=step_cfg.use_ema)

        accum = step_cfg.grad_accum_steps
        bs = int(cfg.train_batch_size)
        seed = int(cfg.random_seed)
        keep_loader = BatchLoader(dataset_all, InfiniteSampler(len(dataset_all), seed=seed), bs)
        forget_loader = BatchLoader(dataset_deletion,
                                    InfiniteSampler(len(dataset_deletion), seed=seed + 1), bs)

        evaluator = Evaluator(unet_eps_apply, schedule,
                              (ucfg.sample_size, ucfg.sample_size, ucfg.in_channels),
                              num_inference_steps=int(cfg.pipeline.num_inference_steps),
                              random_seed=seed, solver=str(cfg.pipeline.get("solver", "ddpm")),
                              injection_steps=int(cfg.pipeline.get("injection_steps", 10)))
        # The canonical t-shirt: from its file if present, else the first
        # forget image (synthetic data).
        tshirt_path = str((metrics_cfg.get("classifier") or {}).get("tshirt_path", ""))
        if tshirt_path and os.path.exists(tshirt_path):
            tshirt_img = _read_png(tshirt_path)
        else:
            tshirt_img = (np.asarray(dataset_deletion[0]) + 1.0) / 2.0

        deletion_steps_logged = False
        ckpt = CheckpointManager(str(cfg.output_dir), cfg.get("checkpoints_total_limit"),
                                 async_save=bool(cfg.get("async_checkpointing", False)))

        def log_metrics(step):
            nonlocal deletion_steps_logged
            imgs = self.timed(self.eval_seconds, evaluator.sample_images, self.eval_model(state),
                              int(cfg.eval_images), set_generator=True)
            tracker.log_images("Sampled Images", Evaluator.make_grid_from_images(imgs[:64]),
                               step=step)
            freq, _ = TShirtClassifier.get_tshirt_frequency(imgs, tshirt_img)
            if freq == 0.0 and not deletion_steps_logged:
                tracker.log_summary("deletion_steps", step)
                deletion_steps_logged = True
            tracker.log({"metrics/deletion_class_fraction": freq}, step=step)

        start_step = 0
        if cfg.get("resume_from_checkpoint"):
            self.restore(state, gen, ckpt.restore_item(str(cfg.resume_from_checkpoint), "state"))
            start_step = state.step
            # fast-forward both streams at the sampler level: each step took
            # `accum` microbatches from each loader
            keep_loader.skip_batches = forget_loader.skip_batches = start_step * accum
            print(f"[delete_tshirt] resumed from step {start_step}")
        stream = dual_stream(iter(keep_loader), iter(forget_loader), accum)
        if start_step == 0:
            log_metrics(0)

        def one_step():
            batch = {k: self.to_device(v) for k, v in next(stream).items()}
            return step_fn(state, batch, gen)[1]

        steps_per_call = max(int(cfg.get("steps_per_call", 1) or 1), 1)
        guard = PreemptionGuard().install()
        global_step = start_step
        t_last = time.time()
        while global_step < training_steps:
            if guard.should_stop:
                ckpt.save_bundle(global_step, self.bundle(state, gen))
                print(f"[preemption] saved checkpoint-{global_step}; exiting")
                break
            k_done = min(steps_per_call, training_steps - global_step)
            per_step = [self.timed(self.step_seconds, one_step) for _ in range(k_done)]
            # images_per_sec as the JAX task defines it: the pass's images over
            # the wall time since the previous pass ended, which holds that
            # pass's evaluation and checkpoint. step_seconds keeps each step's
            # synchronised time alone.
            now = time.time()
            dt, t_last = now - t_last, now
            for i, metrics in enumerate(per_step):
                metrics["images_per_sec"] = k_done * bs * accum / dt
                tracker.log(metrics, step=global_step + i + 1)
            prev_step, global_step = global_step, global_step + k_done
            if int(cfg.sampling_steps) and boundary_crossed(prev_step, global_step,
                                                            cfg.sampling_steps):
                log_metrics(global_step)
            if boundary_crossed(prev_step, global_step, cfg.get("checkpointing_steps")):
                ckpt.save_bundle(global_step, self.bundle(state, gen))

        if not guard.should_stop:
            ckpt.save_bundle(training_steps, self.bundle(state, gen))
        ckpt.wait()
        tracker.finish()
