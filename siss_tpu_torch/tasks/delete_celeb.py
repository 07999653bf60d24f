"""CelebA-HQ-256 celebrity unlearning task: port of
``siss_tpu/tasks/delete_celeb.py``.

Unlearns chosen images of a folder (``deletion.img_name``) from a
``google/ddpm-celebahq-256``-shaped UNet: a port bundle, a diffusers model
directory or a state-dict file with diffusers ``UNet2DModel`` names (the
hub checkpoint's pre-0.18 attention names too), else random weights with a
warning. The keep
set streams from an ``InfiniteSampler``; the forget stream is a
``RepeatedSampler`` that repeats each image ``training_steps × accum × bs``
times, the run lasting ``training_steps × len(img_name)`` optimizer steps
at t ∈ [t_min, t_max) (999 by default). As in the JAX task, the repeat count
takes the multiplied ``training_steps``, so with several forget images the
run draws only the first.

Every ``sampling_steps`` steps it samples ``eval_batch_size`` images and
logs their panel, the deletion-class fraction when a classifier is
configured, and the denoising injections: the target image noised to
``metrics.denoising_injections.timestep`` (noise from a generator seeded
with ``random_seed`` at each evaluation) and reverse-diffused. Each on its
own ``step_frequency``: the likelihood of the target image (one probe
generator for the run), the membership losses and FID over
``num_imgs_to_generate`` samples (``metrics/fid``, or ``metrics/fid_rand``
without InceptionV3 weights).

``deletion.loss_params.superfactor`` decays by ``deletion.superfactor_decay``
once per microbatch; the value a step starts from is logged.
``steps_per_call = K`` runs K steps between the evaluation and checkpoint
gates (boundary crossings, as in the JAX package); with a superfactor it
falls back to 1. ``train_batch_size`` is the global microbatch: under
several ranks each loads its stripe of the keep stream; the forget stream is
not striped (``siss_tpu/tasks/delete_celeb.py:106-112``), so every rank draws
the same forget rows.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from siss_tpu_torch.config import to_dict
from siss_tpu_torch.data import (BatchLoader, InfiniteSampler, RepeatedSampler, dual_stream,
                                 read_image)
from siss_tpu_torch.diffusion import NoiseSchedule, q_sample
from siss_tpu_torch.diffusion.sde import VPSDE
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.metrics import Classifier, LikelihoodEvaluator, MembershipLoss
from siss_tpu_torch.metrics.inception_v3 import build_fid_evaluator
from siss_tpu_torch.parallel import make_rank_sampler, process_batch_slice, shard_module
from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, unet_eps_apply)
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard
from siss_tpu_torch.utils.checkpoint import ITEM_FILE
from siss_tpu_torch.utils.hf_convert import convert_unet2d, import_hf_unet, load_torch_state_dict


def read_target_image(path: str) -> np.ndarray:
    """An image file as float32 [H, W, C] in [−1, 1]."""
    img = np.asarray(read_image(path), np.float32) / 255.0 * 2.0 - 1.0
    return img[..., None] if img.ndim == 2 else img


def denoising_injection(evaluator: Evaluator, schedule: NoiseSchedule, model, timestep: int,
                        clean_image: torch.Tensor, n: int,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """``n`` copies of ``clean_image`` [H, W, C] noised to ``timestep`` (with
    ``noise``, or a draw from ``generator``) and reverse-diffused to 0 by the
    evaluator: numpy NHWC in [0, 1]."""
    if noise is None:
        noise = torch.randn((n, *clean_image.shape), generator=generator,
                            device=generator.device)
    noise = torch.as_tensor(noise, device=clean_image.device)
    ts = torch.full((n,), int(timestep), device=clean_image.device)
    noisy = q_sample(schedule, clean_image.expand(n, *clean_image.shape), noise, ts)
    return evaluator.denoise_images(model, noisy, int(timestep))


class DeleteCeleb(Task):
    def run(self) -> None:
        cfg = self.cfg
        metrics_cfg = cfg.get("metrics") or {}
        #: One record per evaluation: its step and the seconds of each part
        #: (samples, injection, likelihood, membership, FID and FID's host
        #: ``compute``), with the FID value.
        self.eval_records = []
        tracker = self.make_tracker()
        seed = int(cfg.random_seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        dataset_all = self.build_dataset(cfg.dataset_all)
        dataset_deletion = self.build_dataset(cfg.dataset_deletion)
        model, ucfg = self.build_unet()
        schedule = self.build_schedule()
        self._load_pretrained(model)
        sharding = shard_module(model, self.mesh)  # siss_tpu/tasks/delete_celeb.py:69

        n_forget = len(cfg.deletion.img_name)
        training_steps = int(cfg.training_steps) * n_forget
        opt, lr_schedule = build_optimizer(cfg.optimizer, model.parameters(),
                                           str(cfg.lr_scheduler), int(cfg.lr_warmup_steps),
                                           training_steps, sharding=sharding)
        accum = int(cfg.gradient_accumulation_steps)
        bs = int(cfg.train_batch_size)
        step_cfg = DeletionStepConfig(
            loss_fn=str(cfg.deletion.loss_fn),
            loss_params=tuple(sorted(to_dict(cfg.deletion.get("loss_params") or {}).items())),
            scaling_norm=float(cfg.deletion.get("scaling_norm", 1.0)),
            eta=float(cfg.deletion.get("eta", 1e-3)),
            grad_accum_steps=accum,
            t_min=int(cfg.deletion.get("t_min", 999)),
            t_max=int(cfg.deletion.get("t_max", 1000)),
            use_ema=bool(cfg.ema.use_ema),
            batched_dual_backward=bool(cfg.deletion.get("batched_dual_backward", False)),
            grad_accum_dtype=str(cfg.deletion.get("grad_accum_dtype", "float32")),
            param_cast_dtype=cfg.deletion.get("param_cast_dtype"),
            fused_surgery=bool(cfg.deletion.get("fused_surgery", True)),
            fused_siss=bool(cfg.deletion.get("fused_siss", True)),
        )
        step_fn = build_deletion_train_step(unet_eps_apply, schedule, step_cfg)
        state = TrainState.create(model, opt, lr_schedule, use_ema=step_cfg.use_ema,
                                  sharding=sharding)

        bs_local = process_batch_slice(bs, self.mesh)
        keep_loader = BatchLoader(dataset_all,
                                  make_rank_sampler(InfiniteSampler, len(dataset_all), seed=seed,
                                                    mesh=self.mesh), bs_local)
        forget_loader = BatchLoader(dataset_deletion,
                                    RepeatedSampler(len(dataset_deletion),
                                                    training_steps * accum * bs_local), bs_local)

        evaluator = Evaluator(unet_eps_apply, schedule,
                              (ucfg.sample_size, ucfg.sample_size, ucfg.in_channels),
                              num_inference_steps=int(cfg.pipeline.num_inference_steps),
                              random_seed=seed, solver=str(cfg.pipeline.get("solver", "ddpm")),
                              injection_steps=int(cfg.pipeline.get("injection_steps", 10)),
                              mesh=self.mesh)

        inj_cfg = metrics_cfg.get("denoising_injections")
        target_image = None
        if inj_cfg:
            target_image = torch.from_numpy(read_target_image(str(inj_cfg.img_path))).to(
                self.device)

        likelihood_cfg = metrics_cfg.get("likelihood")
        likelihood = None
        if likelihood_cfg:
            likelihood = LikelihoodEvaluator(unet_eps_apply, VPSDE(), schedule=schedule,
                                             random_seed=seed, device=self.device)
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

        fid_cfg = metrics_cfg.get("fid")
        fid_eval = None
        if fid_cfg:
            fid_eval = build_fid_evaluator(to_dict(fid_cfg.class_cfg), dataset_all,
                                           device=self.device)

        classifier = self._classifier() if metrics_cfg.get("classifier_cfg") else None
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
            record, m = {"step": step}, {}

            def timed(part, fn, *args, **kwargs):
                seconds = []
                out = self.timed(seconds, fn, *args, **kwargs)
                record[part] = seconds[0]
                return out

            imgs = timed("samples", evaluator.sample_images, model, int(cfg.eval_batch_size),
                         set_generator=True)
            self.eval_seconds.append(record["samples"])
            tracker.log_images("Sampled Images", Evaluator.make_grid_from_images(imgs), step=step)
            if metrics_cfg.get("fraction_deletion") and classifier is not None:
                frac = classifier.compute_class_frequency(
                    imgs, int(cfg.deletion.get("class_label", 0)))
                m["metrics/deletion_class_fraction"] = frac
                if frac == 0.0 and not deletion_steps_logged:
                    tracker.log_summary("deletion_steps", step)
                    deletion_steps_logged = True
            if inj_cfg:
                t = int(inj_cfg.timestep)
                noise_gen = torch.Generator(device=self.device).manual_seed(seed)
                out = timed("injection", denoising_injection, evaluator, schedule, model, t,
                            target_image, int(cfg.eval_batch_size), generator=noise_gen)
                tracker.log_images(f"Target Image Generations (t={t})",
                                   Evaluator.make_grid_from_images(out), step=step)
            if likelihood is not None and boundary_crossed(prev_step, step,
                                                           likelihood_cfg.step_frequency):
                bpd, _, nfe = timed("likelihood", likelihood.evaluate_likelihood, model,
                                    target_image[None], generator=likelihood_gen)
                m["metrics/likelihood"] = float(bpd[0])
                record["likelihood_nfe"] = nfe
            if membership is not None and boundary_crossed(prev_step, step,
                                                           membership_cfg.step_frequency):
                timesteps = [int(t) for t in membership_cfg.timesteps]
                losses = timed("membership", membership.compute_membership_losses, model,
                               timesteps)
                for t, (a, d) in zip(timesteps, losses):
                    m[f"membership_loss/all_membership_loss_t={t}"] = a
                    m[f"membership_loss/deletion_membership_loss_t={t}"] = d
                    m[f"membership_loss/membership_ratio_t={t}"] = d / a if a else float("nan")
            if fid_eval is not None and boundary_crossed(prev_step, step, fid_cfg.step_frequency):
                def fid_pass():
                    n, batch_n = int(fid_cfg.num_imgs_to_generate), int(fid_cfg.batch_size)
                    for done in range(0, n, batch_n):
                        fid_eval.update(evaluator.sample_images(model, min(batch_n, n - done)))
                    return fid_eval.compute()

                fid, record["fid_compute"] = timed("fid", fid_pass)
                m[fid_eval.metric_key] = record[fid_eval.metric_key] = fid
            self.eval_records.append(record)
            if m:
                tracker.log(m, step=step)

        start_step = 0
        if cfg.get("resume_from_checkpoint"):
            self.restore(state, gen, ckpt.restore_item(str(cfg.resume_from_checkpoint), "state"))
            start_step = state.step
            # fast-forward both streams at the sampler level: each step took
            # `accum` microbatches from each loader
            keep_loader.skip_batches = forget_loader.skip_batches = start_step * accum
            print(f"[delete_celeb] resumed from step {start_step}")
        stream = dual_stream(iter(keep_loader), iter(forget_loader), accum)

        # superfactor decays once per microbatch; a resumed run starts where
        # the decay left it.
        loss_params = cfg.deletion.get("loss_params") or {}
        superfactor = loss_params.get("superfactor")
        decay = cfg.deletion.get("superfactor_decay")
        if superfactor is not None:
            superfactor = float(superfactor) * (float(decay) ** (start_step * accum)
                                                if decay else 1.0)
        if start_step == 0:
            log_metrics(0)

        def one_step():
            nonlocal superfactor
            batch = {k: self.to_device(v) for k, v in next(stream).items()}
            dyn = {}
            logged = superfactor
            if superfactor is not None:
                d = float(decay) if decay else 1.0
                dyn = {"superfactor": torch.tensor([superfactor * d ** i for i in range(accum)],
                                                   dtype=torch.float32)}
                superfactor *= d ** accum
            metrics = step_fn(state, batch, gen, dyn)[1]
            if logged is not None:
                # the value of the step's first microbatch, before its decay
                metrics["superfactor"] = logged
            return metrics

        steps_per_call = max(int(cfg.get("steps_per_call", 1) or 1), 1)
        if superfactor is not None and steps_per_call > 1:
            print("[delete_celeb] steps_per_call>1 incompatible with "
                  "superfactor; running per-step")
            steps_per_call = 1
        guard = PreemptionGuard().install()
        global_step = start_step
        t_last = time.time()
        stop = False
        while global_step < training_steps:
            stop = self.should_stop(guard)
            if stop:
                ckpt.save_bundle(global_step, self.bundle(state, gen))
                print(f"[preemption] saved checkpoint-{global_step}; exiting")
                break
            k_done = min(steps_per_call, training_steps - global_step)
            per_step = [self.timed(self.step_seconds, one_step) for _ in range(k_done)]
            # images_per_sec as the JAX task defines it: the pass's images
            # over the wall time since the previous pass ended.
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

        if not stop:
            ckpt.save_bundle(training_steps, self.bundle(state, gen))
        ckpt.wait()
        tracker.finish()

    def _load_pretrained(self, model: torch.nn.Module) -> None:
        """The start: a port bundle's UNet (a directory holding
        ``<subfolder>/item.pt``, or ``…/latest``), a diffusers model
        directory (or a snapshot holding one as ``unet/``) or a state-dict
        file with diffusers ``UNet2DModel`` names, modern or pre-0.18
        (``utils/hf_convert.py``), or, when ``checkpoint_path`` is none of
        these, random weights."""
        cfg = self.cfg
        path = str(cfg.checkpoint_path)
        subfolder = str((cfg.get("subfolders") or {}).get("unet") or "unet")
        if path.endswith("latest") or os.path.isfile(os.path.join(path, subfolder, ITEM_FILE)):
            self.load_bundle_unet(model, path)
        elif os.path.isdir(path):
            unet_dir = os.path.join(path, "unet")
            import_hf_unet(unet_dir if os.path.isdir(unet_dir) else path, model)
        elif os.path.isfile(path):
            model.load_state_dict(convert_unet2d(load_torch_state_dict(path), model))
        else:
            print(f"[delete_celeb] WARNING: no pretrained weights at {path}; "
                  "using random init (for real runs point checkpoint_path at the "
                  "google/ddpm-celebahq-256 snapshot or its unet/ directory)")

    def _classifier(self) -> Optional[Classifier]:
        """The deletion-class classifier of ``metrics.classifier_cfg``, or
        None (with the JAX package's message) when it cannot be built."""
        try:
            return self.build_classifier()
        except Exception as e:
            print(f"[delete_celeb] classifier unavailable ({e}); fraction metric disabled")
            return None
