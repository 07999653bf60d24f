"""Stable Diffusion 1.x datapoint unlearning: port of
``siss_tpu/tasks/delete_sd.py``.

Unlearns a memorised image from an SD-1.x model: a frozen VAE and CLIP text
tower, a trainable conditional UNet, the SISS step over latents. Weights
come from ``pretrained_model_name_or_path``: ``unet/``, ``vae/`` and
``text_encoder/`` each holding a state dict with diffusers/transformers
names (``diffusion_pytorch_model.bin`` or ``pytorch_model.bin``), else
random weights with a warning. The prompts come from the dataset's side
files (``fill_cfg``); they are encoded once by the text tower with the
checkpoint's ``tokenizer/``, or read from ``.npz``/``.pt`` embedding files;
with neither the run trains on zero conditioning.

Per step, each of the keep and forget streams is turned into latents: with
the latent cache (``cache_latents: auto|true|false``) from moments encoded
once at start-up (``data/latent_cache.py``), otherwise by the VAE encode of
each microbatch inside the step, after the keyed horizontal flip. Both
paths draw from the run's generator in one order (the [A, mb] flip mask,
then one normal per microbatch of the keep stream, then of the forget
stream, then the step's draws), so they train on the same latents.

Every ``validation_steps`` steps, ``eval_batches`` CFG DDIM samples per
prompt (each batch from a generator seeded with ``seed + b``), their panel
and, with ``metrics.noise_norm``, each prompt's text-conditional noise-norm
curve appended to its history and logged as a line series. The SD metrics
score each prompt's samples: ``metrics.fraction_deletion`` (the k-means
classifier's memorised fraction, ``metrics/deletion_fraction_{i}``, and the
``deletion_steps_{i}`` summary in optimizer steps the first time it is 0),
``metrics.sscd`` (SSCD similarity to ``data_files.mem_img_path``, mean and
max: ``metrics/sscd_{i}``, ``metrics/sscd_max_{i}``) and
``metrics.clip_iqa`` (``metrics/clip_iqa_{i}``); SSCD and CLIP-IQA disable
themselves with a message when their weights are missing. Progress is
counted in images: the tracker's step is the image count. The superfactor
decays once per optimizer step.

``train_batch_size`` is the global microbatch, which the ranks must divide
(the shipped 1 × 16 runs on one rank, 2 × 8 on two). Under several ranks
each loads its stripe of the keep stream; the forget stream is not striped
(``siss_tpu/tasks/delete_sd.py:333-340``). The latent draws (flip mask,
moment samples) are the global batch's, each rank keeping its rows. The
latent cache and the validations run whole on every rank, as the JAX task
runs them; rank 0 logs them.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from siss_tpu_torch.config import to_dict
from siss_tpu_torch.data import BatchLoader, InfiniteSampler, RepeatedSampler, SDData, dual_stream
from siss_tpu_torch.data.latent_cache import (build_moment_cache, cache_nbytes,
                                              sample_from_moments)
from siss_tpu_torch.diffusion import spaced_timesteps
from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline, sd_noise_schedule
from siss_tpu_torch.metrics.clip_iqa import CLIPIQA
from siss_tpu_torch.metrics.kmeans_mem import KMeansMemClassifier
from siss_tpu_torch.metrics.sscd import SSCDEvaluator
from siss_tpu_torch.parallel import make_rank_sampler, process_batch_slice, rank_rows, shard_module
from siss_tpu_torch.models import (AutoencoderKLConfig, CLIPTextConfig, UNet2DConditionConfig,
                                   build_clip_text, build_unet_cond, build_vae,
                                   load_clip_tokenizer)
from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, cond_unet_eps_apply)
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard
from siss_tpu_torch.utils.checkpoint import read_weights


class _Images:
    """The images of an ``SDData``, without their labels."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i][0]


class DeleteSD(Task):
    def fill_cfg(self) -> None:
        """``deletion.frac_deletion`` and ``data_files.mem_img_path`` from
        ``clustering_info.json``; the validation prompts from the prompt
        files under ``images_name`` unless given."""
        cfg = self.cfg
        info_path = str(cfg.data_files.clustering_info_path)
        if os.path.exists(info_path):
            with open(info_path) as f:
                info = json.load(f)
            cfg.deletion.frac_deletion = info.get("frac_deletion",
                                                  cfg.deletion.get("frac_deletion"))
            if info.get("mem_img_name"):
                cfg.data_files.mem_img_path = os.path.join(str(cfg.data_files.img_dir),
                                                           info["mem_img_name"])
        if not cfg.get("validation_prompts"):
            prompts = []
            for p in (cfg.get("og_prompts_path"), cfg.get("modified_prompts_path")):
                if p and os.path.exists(str(p)):
                    with open(str(p)) as f:
                        data = json.load(f)
                    name = str(cfg.images_name)
                    if name in data:
                        prompts.append(data[name])
            cfg.validation_prompts = prompts or None
        first = (cfg.validation_prompts or [None])[0]
        cfg.using_augmented_prompt = bool(first and str(first).endswith((".pt", ".npz")))

    def run(self) -> None:
        cfg = self.cfg
        self.fill_cfg()
        metrics_cfg = cfg.get("metrics") or {}
        #: Seconds of the set-up parts (``models``, ``latent_cache``,
        #: ``metrics``), and one record per validation: its step and the
        #: seconds of its parts (``sampling``, ``decode``, ``norms``, and
        #: ``deletion_fraction``, ``sscd``, ``clip_iqa`` for each metric on).
        self.setup_seconds, self.eval_records = {}, []
        tracker = self.make_tracker()
        seed = int(cfg.seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = self.compute_dtype()

        res = int(cfg.resolution)
        img_dir, labels = str(cfg.data_files.img_dir), str(cfg.data_files.labels_path)
        keep_imgs = _Images(SDData("nondeletion", img_dir, labels, resolution=res))
        mem_imgs = _Images(SDData("deletion", img_dir, labels, resolution=res))

        t0 = time.perf_counter()
        unet_cfg, vae_cfg, text_cfg = self._configs()
        unet = build_unet_cond(unet_cfg, seed=seed, dtype=dtype, device=self.device)
        vae = build_vae(vae_cfg, seed=seed + 1, dtype=dtype, device=self.device)
        text = build_clip_text(text_cfg, seed=seed + 2, dtype=dtype, device=self.device)
        for sub, model in (("unet", unet), ("vae", vae), ("text_encoder", text)):
            self._load_weights(sub, model)
        for tower in (vae, text):
            tower.requires_grad_(False).eval()
        sharding = shard_module(unet, self.mesh)  # siss_tpu/tasks/delete_sd.py:123
        self.synchronize()
        self.setup_seconds["models"] = time.perf_counter() - t0

        schedule = sd_noise_schedule(device=self.device)
        tok_dir = os.path.join(str(cfg.pretrained_model_name_or_path), "tokenizer")
        tokenizer = load_clip_tokenizer(tok_dir)
        pipeline = StableDiffusionPipeline(
            unet_apply=cond_unet_eps_apply, unet=unet, vae_decode=vae.decode,
            text_encoder=text, tokenizer=tokenizer, schedule=schedule,
            latent_channels=vae_cfg.latent_channels, vae_scale_factor=vae_cfg.scale_factor)

        # Prompt embeddings, computed once, at the text tower's length (77).
        dim, max_len = text_cfg.hidden_size, text_cfg.max_position_embeddings
        prompt_embeds = []
        for p in list(cfg.get("validation_prompts") or []):
            if str(p).endswith((".pt", ".npz")):
                prompt_embeds.append(pipeline.load_prompt_embeds(str(p), self.device))
            elif tokenizer is not None:
                prompt_embeds.append(pipeline.encode_prompt(str(p), max_len))
        prompt_embeds = [e.reshape(1, -1, dim) for e in prompt_embeds]
        if prompt_embeds:
            train_cond = prompt_embeds[0]
        else:
            print("[delete_sd] WARNING: no prompts/tokenizer; using zero conditioning")
            train_cond = torch.zeros((1, max_len, dim), device=self.device)
        uncond = (pipeline.encode_prompt("", max_len) if tokenizer is not None
                  else torch.zeros_like(train_cond))

        training_steps = int(cfg.training_steps)
        bs = int(cfg.train_batch_size)
        bs_local = process_batch_slice(bs, self.mesh)
        accum = int(cfg.gradient_accumulation_steps)
        opt, lr_schedule = build_optimizer(self._optimizer_cfg(), unet.parameters(),
                                           str(cfg.lr_scheduler), int(cfg.lr_warmup_steps),
                                           training_steps, sharding=sharding)
        step_cfg = DeletionStepConfig(
            loss_fn=str(cfg.deletion.loss_fn),
            loss_params=tuple(sorted(to_dict(cfg.deletion.get("loss_params") or {}).items())),
            scaling_norm=float(cfg.deletion.get("scaling_norm", 1.0)),
            eta=float(cfg.deletion.get("eta", 1e-2)),
            grad_accum_steps=accum,
            t_min=int(cfg.deletion.get("t_min", 999)),
            t_max=int(cfg.deletion.get("t_max", 1000)),
            max_grad_norm=float(cfg.max_grad_norm),
            use_ema=bool(cfg.use_ema),
            noise_offset=float(cfg.get("noise_offset") or 0.0),
            input_perturbation=float(cfg.get("input_perturbation") or 0.0),
            batched_dual_backward=bool(cfg.deletion.get("batched_dual_backward", False)),
            grad_accum_dtype=str(cfg.deletion.get("grad_accum_dtype", "float32")),
            param_cast_dtype=cfg.deletion.get("param_cast_dtype"),
            fused_surgery=bool(cfg.deletion.get("fused_surgery", True)),
            fused_siss=bool(cfg.deletion.get("fused_siss", True)),
        )
        step_fn = build_deletion_train_step(cond_unet_eps_apply, schedule, step_cfg)
        state = TrainState.create(unet, opt, lr_schedule, use_ema=step_cfg.use_ema,
                                  sharding=sharding)
        random_flip = bool(cfg.get("random_flip"))
        sf = float(vae_cfg.scaling_factor)

        use_cache = self._use_latent_cache(len(keep_imgs) + len(mem_imgs), res, vae_cfg,
                                           random_flip)
        keep_src, mem_src = keep_imgs, mem_imgs
        if use_cache:
            t0 = time.perf_counter()
            keep_src = build_moment_cache(vae.encode_moments, keep_imgs, bs, random_flip,
                                          self.device)
            mem_src = build_moment_cache(vae.encode_moments, mem_imgs, bs, random_flip,
                                         self.device)
            self.setup_seconds["latent_cache"] = time.perf_counter() - t0
            print(f"[delete_sd] latent cache: {len(keep_imgs)}+{len(mem_imgs)} images → "
                  f"{(keep_src.nbytes + mem_src.nbytes) / 2**20:.1f} MiB moments "
                  f"({'both orientations' if random_flip else 'one orientation'}); "
                  "per-step VAE encode elided")

        latent_hw = res // vae_cfg.scale_factor

        def normal_rows(mb):
            """This rank's rows of one microbatch's normal latent draw."""
            return rank_rows(torch.randn((mb, latent_hw, latent_hw, vae_cfg.latent_channels),
                                         generator=gen, device=self.device), mesh=self.mesh)

        def latents_of(streams):
            """The step's [A, mb, h, w, C] latents of both streams: the
            global batch's draws, of which this rank keeps its rows."""
            A, mb = streams["all"].shape[:2]
            flip = (rank_rows(torch.rand((A, bs), generator=gen, device=self.device), 1,
                              self.mesh) < 0.5
                    if random_flip else None)
            out = {}
            for k in ("all", "deletion"):
                x = streams[k]
                if use_cache:
                    noise = torch.stack([normal_rows(bs) for _ in range(A)])
                    out[k] = sample_from_moments(x, flip, sf, noise=noise)
                    continue
                if flip is not None:
                    x = torch.where(flip[:, :, None, None, None], x.flip(3), x)
                with torch.no_grad():
                    out[k] = torch.stack([vae.encode_sample(x[a], noise=normal_rows(bs))
                                          for a in range(A)])
            out["conditioning"] = train_cond.expand(A, mb, *train_cond.shape[-2:])
            return out

        keep_loader = BatchLoader(keep_src, make_rank_sampler(InfiniteSampler, len(keep_imgs),
                                                              seed=seed, mesh=self.mesh), bs_local)
        forget_loader = BatchLoader(mem_src, RepeatedSampler(len(mem_imgs),
                                                             training_steps * accum * bs_local),
                                    bs_local)

        t0 = time.perf_counter()
        scorers = self._sd_metrics(metrics_cfg)
        self.setup_seconds["metrics"] = time.perf_counter() - t0

        # Per prompt, the history of its averaged text-conditional noise-norm
        # curves (ascending timesteps), one appended per validation.
        noise_norm_history = [[] for _ in prompt_embeds]
        n_inference = int(cfg.get("num_inference_steps", 50))
        norm_xs = sorted(int(t) for t in spaced_timesteps(schedule.num_train_timesteps,
                                                          n_inference))

        def log_validation(step, img_count):
            model = self.eval_model(state)
            record = {"step": step, "sampling": 0.0, "decode": 0.0, "norms": 0.0,
                      **{name: 0.0 for name in scorers}}
            logs = {}

            def timed(part, fn, *args, **kwargs):
                seconds = []
                out = self.timed(seconds, fn, *args, **kwargs)
                record[part] += seconds[0]
                return out

            for pi, pe in enumerate(prompt_embeds):
                imgs_list, norm_curves = [], []
                for b in range(int(cfg.eval_batches)):
                    sample_gen = torch.Generator(device=self.device).manual_seed(seed + b)
                    latents, norms = timed(
                        "sampling", pipeline.sample_latents, pe, uncond.reshape(1, -1, dim),
                        sample_gen, height=res, width=res, num_inference_steps=n_inference,
                        guidance_scale=float(cfg.get("guidance_scale", 7.5)),
                        track_noise_norm=bool(metrics_cfg.get("noise_norm")), unet=model)
                    imgs_list.append(timed("decode", pipeline.decode_images, latents))
                    if norms is not None:
                        norm_curves.append({k: v.cpu().numpy() for k, v in norms.items()})
                if imgs_list:  # eval_batches 0 samples nothing
                    tracker.log_images(f"Generated Images (prompt {pi})",
                                       np.concatenate(imgs_list)[:8], step=img_count)
                if norm_curves:
                    timed("norms", self._log_norms, tracker, logs, pi, norm_curves,
                          noise_norm_history[pi], norm_xs, img_count)
                if imgs_list:
                    imgs = np.concatenate(imgs_list)
                    for name, score in scorers.items():
                        timed(name, score, logs, pi, imgs)
                    frac = logs.get(f"metrics/deletion_fraction_{pi}")
                    # per-prompt steps to deletion, in optimizer steps
                    if frac == 0.0 and f"deletion_steps_{pi}" not in tracker.summary:
                        tracker.log_summary(f"deletion_steps_{pi}", img_count / (bs * accum))
            tracker.log(logs, step=img_count)
            self.eval_seconds.append(sum(v for k, v in record.items() if k != "step"))
            self.eval_records.append(record)

        ckpt = CheckpointManager(str(cfg.output_dir), cfg.get("checkpoints_total_limit"),
                                 async_save=bool(cfg.get("async_checkpointing", False)))
        global_step = 0
        if cfg.get("resume_from_checkpoint"):
            # "latest" or "<run dir>/latest": the newest bundle of the run
            # (the command line makes the run dir the output dir)
            path = str(cfg.resume_from_checkpoint)
            path = "latest" if os.path.basename(path) == "latest" else path
            self.restore(state, gen, ckpt.restore_item(path, "state"))
            global_step = state.step
            # fast-forward both streams at the sampler level, reading no image
            keep_loader.skip_batches = forget_loader.skip_batches = global_step * accum
            print(f"[delete_sd] resumed from step {global_step}")
        img_count = global_step * bs * accum
        stream = dual_stream(iter(keep_loader), iter(forget_loader), accum)

        # The superfactor decays once per optimizer step; a resumed run starts
        # where the decay left it.
        superfactor = (cfg.deletion.get("loss_params") or {}).get("superfactor")
        decay = cfg.deletion.get("superfactor_decay")
        if superfactor is not None:
            superfactor = float(superfactor) * (float(decay) ** global_step if decay else 1.0)

        def one_step():
            nonlocal superfactor
            streams = {k: self.to_device(v) for k, v in next(stream).items()}
            dyn = {} if superfactor is None else {"superfactor": superfactor}
            metrics = step_fn(state, latents_of(streams), gen, dyn)[1]
            if superfactor is not None:
                metrics["superfactor"] = superfactor
                if decay:
                    superfactor *= float(decay)
            return metrics

        steps_per_call = max(int(cfg.get("steps_per_call", 1) or 1), 1)
        if superfactor is not None and steps_per_call > 1:
            print("[delete_sd] steps_per_call>1 incompatible with superfactor; running per-step")
            steps_per_call = 1
        guard = PreemptionGuard().install()
        images_per_step = bs * accum
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
            # images_per_sec as the JAX task defines it: the pass's images over
            # the wall time since the previous pass ended (its validation too).
            now = time.time()
            dt, t_last = now - t_last, now
            for i, metrics in enumerate(per_step):
                metrics["images_per_sec"] = k_done * images_per_step / dt
                tracker.log(metrics, step=img_count + (i + 1) * images_per_step)
            img_count += k_done * images_per_step
            prev_step, global_step = global_step, global_step + k_done
            if boundary_crossed(prev_step, global_step, int(cfg.get("validation_steps", 1) or 1)):
                log_validation(global_step, img_count)
            if boundary_crossed(prev_step, global_step, cfg.get("checkpointing_steps")):
                ckpt.save_bundle(global_step, self.bundle(state, gen))

        if not stop:
            ckpt.save_bundle(training_steps, self.bundle(state, gen))
        ckpt.wait()
        tracker.finish()

    def _configs(self):
        """The UNet, VAE and text-tower configs of ``model_variant``."""
        cfg = self.cfg
        unet_kw = {
            "gradient_checkpointing": bool(cfg.gradient_checkpointing),
            "attention_impl": str(cfg.get("attention_impl", "auto")),
            "ff_impl": str(cfg.get("ff_impl", "saved")),
            "remat_attention": bool(cfg.get("remat_attention", True)),
            "remat_policy": cfg.get("remat_policy") or None,
        }
        if str(cfg.get("model_variant", "sd_v1")) == "tiny":
            return (UNet2DConditionConfig(**{**UNet2DConditionConfig.tiny().__dict__, **unet_kw}),
                    AutoencoderKLConfig.tiny(), CLIPTextConfig.tiny())
        return (UNet2DConditionConfig.sd_v1(**unet_kw), AutoencoderKLConfig.sd_v1(),
                CLIPTextConfig.sd_v1())

    def _load_weights(self, sub: str, model: torch.nn.Module) -> None:
        """``<pretrained_model_name_or_path>/<sub>/``'s state dict, if any
        (``read_weights``: a bundle item or a diffusers or transformers
        weight file)."""
        path = os.path.abspath(os.path.join(str(self.cfg.pretrained_model_name_or_path), sub))
        sd = read_weights(path)
        if sd is None:
            print(f"[delete_sd] WARNING: no converted weights at {path}; using random init")
            return
        model.load_state_dict(sd)

    def _sd_metrics(self, metrics_cfg):
        """The SD metrics turned on in ``metrics_cfg`` whose models load, by
        record name: each ``score(logs, prompt_index, imgs)`` logs its keys."""
        cfg, scorers = self.cfg, {}
        if metrics_cfg.get("fraction_deletion"):
            classifier = KMeansMemClassifier.load(
                str(metrics_cfg.fraction_deletion.classifier_path), self.device)

            def deletion_fraction(logs, pi, imgs):
                logs[f"metrics/deletion_fraction_{pi}"] = classifier.fraction(imgs)
            scorers["deletion_fraction"] = deletion_fraction
        mem_path = cfg.data_files.get("mem_img_path")
        sscd = (SSCDEvaluator.load(str(metrics_cfg.sscd.model_path), self.device)
                if metrics_cfg.get("sscd") else None)
        if sscd is not None and mem_path and os.path.exists(str(mem_path)):
            from PIL import Image

            mem_img = np.asarray(Image.open(str(mem_path)), np.float32) / 255.0

            def sscd_score(logs, pi, imgs):
                # the reference logs the mean over the samples; the max
                # (worst-case memorisation) under its own key
                sims = sscd.similarities(imgs, mem_img)
                logs[f"metrics/sscd_{pi}"] = float(sims.mean())
                logs[f"metrics/sscd_max_{pi}"] = float(sims.max())
            scorers["sscd"] = sscd_score
        clip_iqa = CLIPIQA.try_load(device=self.device) if metrics_cfg.get("clip_iqa") else None
        if clip_iqa is not None:
            def clip_iqa_score(logs, pi, imgs):
                logs[f"metrics/clip_iqa_{pi}"] = clip_iqa.score(imgs)
            scorers["clip_iqa"] = clip_iqa_score
        return scorers

    def _optimizer_cfg(self) -> dict:
        """The flat ``adam_*`` knobs as an AdamW config, or the ``optimizer:``
        override (its ``lr`` from ``learning_rate`` unless set), which
        replaces every ``adam_*`` knob as in the JAX task."""
        cfg = self.cfg
        if cfg.get("optimizer"):
            opt_cfg = {"lr": float(cfg.learning_rate), **to_dict(cfg.optimizer)}
            print(f"[delete_sd] optimizer override active; effective hyperparameters: "
                  f"{opt_cfg} (lr_scheduler={cfg.lr_scheduler}, warmup={cfg.lr_warmup_steps}; "
                  f"weight_decay defaults to 0 unless set here — the baseline "
                  f"adam_weight_decay={cfg.adam_weight_decay} does NOT carry over)")
            return opt_cfg
        return {"_target_": "torch.optim.AdamW", "lr": float(cfg.learning_rate),
                "betas": [float(cfg.adam_beta1), float(cfg.adam_beta2)],
                "weight_decay": float(cfg.adam_weight_decay), "eps": float(cfg.adam_epsilon),
                "mu_dtype": cfg.get("adam_mu_dtype"), "nu_dtype": cfg.get("adam_nu_dtype")}

    def _use_latent_cache(self, n_images: int, res: int, vae_cfg: AutoencoderKLConfig,
                          random_flip: bool) -> bool:
        """``cache_latents``: ``auto`` caches when the moments fit
        ``cache_latents_budget_mb`` (fp32 on the host), ``true`` always."""
        cfg = self.cfg
        mode = str(cfg.get("cache_latents", "auto")).lower()
        if mode in ("false", "0", "none", "off", ""):
            return False
        nbytes = cache_nbytes(n_images, res, vae_cfg.scale_factor, vae_cfg.latent_channels,
                              random_flip)
        budget = float(cfg.get("cache_latents_budget_mb", 4096) or 4096) * 2**20
        if mode == "auto":
            return nbytes <= budget
        if nbytes > budget:
            print(f"[delete_sd] cache_latents=true: cache is {nbytes / 2**20:.0f} MiB "
                  f"(> budget {budget / 2**20:.0f} MiB); honoring the explicit request")
        return True

    @staticmethod
    def _log_norms(tracker, logs, pi, norm_curves, history, norm_xs, img_count) -> None:
        """Prompt ``pi``'s text-conditional noise-norm curve (mean over
        batches and images, ascending timesteps) appended to its history and
        logged as a line series; for prompt 0 the per-step scalars too."""
        text_curve = np.mean([n["text_norm"] for n in norm_curves], axis=(0, 2))[::-1]
        history.append([float(v) for v in text_curve])
        tracker.log_line_series(f"noise_norms/noise_norms_{pi}", xs=norm_xs, ys=history,
                                keys=list(range(len(history))),
                                title=f"Text-conditional noise norm (prompt {pi})",
                                xname="Timestep", step=img_count)
        if pi == 0:
            uncond_curve = np.mean([n["uncond_norm"] for n in norm_curves], axis=(0, 2))[::-1]
            for si in range(len(text_curve)):
                logs[f"noise_norms/uncond_step{si}"] = float(uncond_curve[si])
                logs[f"noise_norms/text_step{si}"] = float(text_curve[si])
