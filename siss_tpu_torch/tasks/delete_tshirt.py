"""MNIST t-shirt unlearning task: port of ``siss_tpu/tasks/delete_tshirt.py``.

Dual keep/forget infinite streams feed the deletion train step (any of the
six ``deletion.loss_fn`` objectives; fused SISS by default, full-range
timesteps), starting from the pretrain bundle's ``unet_ema`` weights. Every
``sampling_steps`` steps it samples ``eval_images`` images, logs a panel and
the t-shirt fraction from the L2 detector, and the first step at which that
fraction is 0 goes into the summary as ``deletion_steps``. Within those
evaluations, each on its own ``step_frequency``: the exact likelihood (RK45
on the probability-flow ODE) of the first forget image, a fresh Hutchinson
probe each time from one generator seeded once, the membership
losses at ``metrics.membership_loss.timesteps``, and the Inception Score of
the samples with the deleted class removed (disabled, with a message, when
the classifier checkpoint is missing or does not fit).

``deletion.loss_params.superfactor`` decays by ``deletion.superfactor_decay``
once per microbatch (an [A] scalar per step), from where a resumed run left
it, and is logged after each step. ``steps_per_call = K`` runs K steps
between the evaluation and checkpoint gates, which fire on boundary
crossings as in the JAX package; with a superfactor it falls back to 1.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from siss_tpu_torch.config import to_dict
from siss_tpu_torch.data import BatchLoader, InfiniteSampler, dual_stream, read_image
from siss_tpu_torch.diffusion.sde import VPSDE
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.metrics import (InceptionScore, LikelihoodEvaluator, MembershipLoss,
                                    TShirtClassifier)
from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, unet_eps_apply)
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard


def _read_png(path: str) -> np.ndarray:
    img = read_image(path).astype(np.float32) / 255.0
    return img[..., None] if img.ndim == 2 else img


class DeleteTShirt(Task):
    def run(self) -> None:
        cfg = self.cfg
        metrics_cfg = cfg.get("metrics") or {}
        #: One record per likelihood evaluation: step, seconds, nfe, bpd.
        self.likelihood_runs = []
        tracker = self.make_tracker()
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.random_seed))

        dataset_all = self.build_dataset(cfg.dataset_all)
        dataset_deletion = self.build_dataset(cfg.dataset_deletion)
        model, ucfg = self.build_unet()
        schedule = self.build_schedule()

        # The pretrained start: the bundle's subfolder (unet_ema by default).
        if cfg.get("checkpoint_path"):
            self.load_bundle_unet(model, str(cfg.checkpoint_path))

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
            fused_siss=bool(cfg.deletion.get("fused_siss", True)),
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

        likelihood_cfg = metrics_cfg.get("likelihood")
        likelihood = None
        if likelihood_cfg:
            likelihood = LikelihoodEvaluator(unet_eps_apply, VPSDE(), schedule=schedule,
                                             method="rk45", random_seed=seed, device=self.device)
        # One probe generator for the run: each evaluation draws a fresh probe.
        likelihood_gen = torch.Generator(device=self.device).manual_seed(seed)

        membership_cfg = metrics_cfg.get("membership_loss")
        membership = None
        if membership_cfg:
            mc = membership_cfg.class_cfg
            membership = MembershipLoss(unet_eps_apply, schedule, dataset_all, dataset_deletion,
                                        int(mc.num_image_samples), int(mc.num_noise_samples),
                                        int(mc.eval_batch_size), seed=seed)
            membership.sample_images()
            membership.sample_noises()

        is_cfg = metrics_cfg.get("inception_score")
        inception = self._inception(cfg) if is_cfg else None
        is_gen = torch.Generator().manual_seed(seed)

        deletion_steps_logged = False
        ckpt = CheckpointManager(str(cfg.output_dir), cfg.get("checkpoints_total_limit"),
                                 async_save=bool(cfg.get("async_checkpointing", False)))

        def log_metrics(step, prev_step=None):
            # The inner step_frequency gates fire on crossings of
            # (prev_step, step]: with steps_per_call > 1 the evaluated step
            # is generally not itself a multiple.
            if prev_step is None:
                prev_step = step - 1
            nonlocal deletion_steps_logged
            model = self.eval_model(state)
            imgs = self.timed(self.eval_seconds, evaluator.sample_images, model,
                              int(cfg.eval_images), set_generator=True)
            tracker.log_images("Sampled Images", Evaluator.make_grid_from_images(imgs[:64]),
                               step=step)
            freq, _ = TShirtClassifier.get_tshirt_frequency(imgs, tshirt_img)
            m = {"metrics/deletion_class_fraction": freq}
            if freq == 0.0 and not deletion_steps_logged:
                tracker.log_summary("deletion_steps", step)
                deletion_steps_logged = True
            if likelihood is not None and boundary_crossed(prev_step, step,
                                                           likelihood_cfg.step_frequency):
                forget_img = self.to_device(np.asarray(dataset_deletion[0])[None])
                seconds = []
                bpd, _, nfe = self.timed(seconds, likelihood.evaluate_likelihood, model,
                                         forget_img, generator=likelihood_gen)
                m["metrics/likelihood"] = float(bpd.mean())
                self.likelihood_runs.append({"step": step, "seconds": seconds[0], "nfe": nfe,
                                             "bpd": m["metrics/likelihood"]})
            if membership is not None and boundary_crossed(prev_step, step,
                                                           membership_cfg.step_frequency):
                timesteps = [int(t) for t in membership_cfg.timesteps]
                for t, (a, d) in zip(timesteps,
                                     membership.compute_membership_losses(model, timesteps)):
                    m[f"membership_loss/all_t={t}"] = a
                    m[f"membership_loss/deletion_t={t}"] = d
                    m[f"membership_loss/ratio_t={t}"] = d / a if a else float("nan")
            if inception is not None and boundary_crossed(prev_step, step, is_cfg.step_frequency):
                n = int(is_cfg.num_imgs_to_generate)
                done = imgs
                while len(done) < n:
                    done = np.concatenate([done, evaluator.sample_images(
                        model, int(is_cfg.batch_size))])
                inception.update(done[:n])
                m["metrics/is_mean"], m["metrics/is_std"] = inception.compute(is_gen)
            tracker.log(m, step=step)

        start_step = 0
        if cfg.get("resume_from_checkpoint"):
            self.restore(state, gen, ckpt.restore_item(str(cfg.resume_from_checkpoint), "state"))
            start_step = state.step
            # fast-forward both streams at the sampler level: each step took
            # `accum` microbatches from each loader
            keep_loader.skip_batches = forget_loader.skip_batches = start_step * accum
            print(f"[delete_tshirt] resumed from step {start_step}")
        stream = dual_stream(iter(keep_loader), iter(forget_loader), accum)

        # superfactor decays once per microbatch; a resumed run starts where
        # the decay left it.
        loss_params = cfg.deletion.get("loss_params") or {}
        superfactor = loss_params.get("superfactor")
        decay = cfg.deletion.get("superfactor_decay")
        if superfactor is not None and decay:
            superfactor = float(superfactor) * float(decay) ** (start_step * accum)
        if start_step == 0:
            log_metrics(0)

        def one_step():
            nonlocal superfactor
            batch = {k: self.to_device(v) for k, v in next(stream).items()}
            dyn = {}
            if superfactor is not None:
                d = float(decay) if decay else 1.0
                dyn = {"superfactor": torch.tensor([superfactor * d ** i for i in range(accum)],
                                                   dtype=torch.float32)}
            metrics = step_fn(state, batch, gen, dyn)[1]
            if superfactor is not None and decay:
                superfactor = superfactor * float(decay) ** accum
                metrics["superfactor"] = superfactor
            return metrics

        steps_per_call = max(int(cfg.get("steps_per_call", 1) or 1), 1)
        if superfactor is not None and steps_per_call > 1:
            print("[delete_tshirt] steps_per_call>1 incompatible with "
                  "superfactor decay; running per-step")
            steps_per_call = 1
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
                log_metrics(global_step, prev_step)
            if boundary_crossed(prev_step, global_step, cfg.get("checkpointing_steps")):
                ckpt.save_bundle(global_step, self.bundle(state, gen))

        if not guard.should_stop:
            ckpt.save_bundle(training_steps, self.bundle(state, gen))
        ckpt.wait()
        tracker.finish()

    def _inception(self, cfg):
        """The Inception Score over ``metrics.classifier_cfg``'s classifier,
        or None (with the JAX package's message) when its checkpoint is
        missing or does not fit."""
        try:
            return InceptionScore(self.build_classifier(),
                                  remove_class=int(cfg.deletion.class_label))
        except Exception as e:
            print(f"[delete_tshirt] inception classifier unavailable ({e}); IS disabled")
            return None
