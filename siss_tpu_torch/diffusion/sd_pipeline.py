"""Stable Diffusion 1.x pipeline with the memorisation diagnostics: port of
``siss_tpu/diffusion/sd_pipeline.py``.

* ``sd_noise_schedule``: the SD-1.x schedule the latent step trains on.
* ``__call__``: CFG DDIM sampling with the optional per-step noise-norm
  curves (‖ε_uncond‖, ‖ε_text − ε_uncond‖ per image), then the VAE decode
  (``sample_latents`` then ``decode_images``).
* ``img2img``: diffusers' ``get_timesteps`` clipping and a partial CFG DDIM
  from noised latents.
* ``get_text_cond_grad``: per-token gradient norms of the text-conditional
  noise norm with respect to the prompt embeddings, at target steps.
* ``aug_prompt``: AdamW on the prompt embeddings to lower the
  text-conditional noise norm (Wen et al.'s inference-time mitigation),
  which builds "augmented prompt" embedding files offline.

Prompts enter as embeddings [B, 77, 768]: ``encode_prompt`` computes them
when a tokenizer and text encoder are given, ``load_prompt_embeds`` reads
precomputed ones. The models enter as callables: ``unet_apply(unet, x, t,
context)`` on NHWC latents (``train.step.cond_unet_eps_apply`` for the
port's ``UNet2DCondition``), ``vae_decode(z)`` and ``text_encoder(ids)``.
Every random draw (start latents, img2img noise) is an argument or comes
from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from siss_tpu_torch.diffusion.sampling import cfg_branches, sample_ddim_cfg
from siss_tpu_torch.diffusion.schedule import NoiseSchedule, ddim_step, spaced_timesteps


def sd_noise_schedule(num_train_timesteps: int = 1000, device="cuda") -> NoiseSchedule:
    """SD-1.x schedule: scaled_linear β ∈ [0.00085, 0.012], no clipping."""
    return NoiseSchedule.create(num_train_timesteps, "scaled_linear", 0.00085, 0.012,
                                clip_sample=False, device=device)


def _to_unit_images(images: torch.Tensor) -> np.ndarray:
    return np.clip((images.float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)


@dataclasses.dataclass
class StableDiffusionPipeline:
    unet_apply: Callable          # (unet, latents NHWC, t [B], context) -> eps NHWC
    unet: Any
    vae_decode: Callable          # latents NHWC -> images NHWC in [-1, 1]
    text_encoder: Optional[Callable] = None   # input_ids [B, L] -> embeds [B, L, D]
    tokenizer: Any = None
    schedule: Optional[NoiseSchedule] = None
    latent_channels: int = 4
    vae_scale_factor: int = 8

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = sd_noise_schedule()

    @property
    def device(self) -> torch.device:
        return self.schedule.gamma.device

    # ------------------------------------------------------------- prompts
    @torch.no_grad()
    def encode_prompt(self, prompt: str, max_length: int = 77) -> torch.Tensor:
        if self.tokenizer is None or self.text_encoder is None:
            raise RuntimeError(
                "No tokenizer/text encoder available; pass precomputed prompt "
                "embeddings (load_prompt_embeds) instead.")
        ids = self.tokenizer(prompt, padding="max_length", max_length=max_length,
                             truncation=True, return_tensors="np").input_ids
        return self.text_encoder(torch.from_numpy(ids).to(self.device))

    def uncond_embeds(self, batch_size: int = 1) -> torch.Tensor:
        e = self.encode_prompt("")
        return e.expand(batch_size, *e.shape[-2:])

    @staticmethod
    def load_prompt_embeds(path: str, device="cpu") -> torch.Tensor:
        """Precomputed prompt embeddings: an ``.npz`` holding ``embeds``, or
        a tensor saved with ``torch.save`` (the augmented-prompt files)."""
        if str(path).endswith(".npz"):
            with np.load(path) as data:
                t = torch.from_numpy(np.array(data["embeds"]))
        else:
            t = torch.load(path, map_location="cpu", weights_only=True)
        return t.detach().to(device=device, dtype=torch.float32)

    # ------------------------------------------------------------ sampling
    def _latent_shape(self, batch: int, height: int, width: int) -> Tuple[int, ...]:
        return (batch, height // self.vae_scale_factor, width // self.vae_scale_factor,
                self.latent_channels)

    def _eps_fn(self, unet):
        return lambda x, t, context: self.unet_apply(unet, x, t, context)

    def sample_latents(self, prompt_embeds: torch.Tensor, uncond_embeds: torch.Tensor,
                       generator: Optional[torch.Generator] = None, height: int = 512,
                       width: int = 512, num_inference_steps: int = 50,
                       guidance_scale: float = 7.5, track_noise_norm: bool = False,
                       unet: Any = None, x_init: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """CFG DDIM latents of a batch of prompt embeddings, and the noise
        norms [steps, B] or None. The start latents are ``x_init`` or a
        draw from ``generator``."""
        unet = self.unet if unet is None else unet
        shape = self._latent_shape(prompt_embeds.shape[0], height, width)
        return sample_ddim_cfg(
            self._eps_fn(unet), self.schedule, shape, prompt_embeds, uncond_embeds,
            guidance_scale=guidance_scale, num_inference_steps=num_inference_steps,
            track_noise_norm=track_noise_norm, generator=generator, x_init=x_init)

    @torch.inference_mode()
    def decode_images(self, latents: torch.Tensor) -> np.ndarray:
        """Latents → numpy NHWC images in [0, 1]."""
        return _to_unit_images(self.vae_decode(latents))

    def __call__(self, prompt_embeds: torch.Tensor, uncond_embeds: torch.Tensor,
                 generator: Optional[torch.Generator] = None, height: int = 512,
                 width: int = 512, num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 track_noise_norm: bool = False, unet: Any = None,
                 x_init: Optional[torch.Tensor] = None,
                 ) -> Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]:
        """Sample a batch of prompt embeddings: (images [0, 1] NHWC, the
        noise norms [steps, B] or None)."""
        latents, norms = self.sample_latents(prompt_embeds, uncond_embeds, generator, height,
                                             width, num_inference_steps, guidance_scale,
                                             track_noise_norm, unet, x_init)
        images = self.decode_images(latents)
        if norms is None:
            return images, None
        return images, {k: v.cpu().numpy() for k, v in norms.items()}

    # ------------------------------------------------------------- img2img
    def get_timesteps(self, num_inference_steps: int, strength: float):
        """diffusers' img2img timestep clipping."""
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_timestep, 0)
        ts = spaced_timesteps(self.schedule.num_train_timesteps, num_inference_steps)
        return ts[t_start:], num_inference_steps - t_start

    @torch.inference_mode()
    def img2img(self, init_latents: torch.Tensor, prompt_embeds: torch.Tensor,
                uncond_embeds: torch.Tensor, generator: Optional[torch.Generator] = None,
                strength: float = 0.8, num_inference_steps: int = 50,
                guidance_scale: float = 7.5, unet: Any = None,
                noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """``prepare_latents_img2img`` and a partial CFG DDIM: the latents
        noised to the first kept timestep with ``noise`` (or a draw from
        ``generator``), then denoised; images [0, 1] NHWC."""
        unet = self.unet if unet is None else unet
        ts, _ = self.get_timesteps(num_inference_steps, strength)
        if noise is None:
            noise = torch.randn(init_latents.shape, generator=generator,
                                dtype=init_latents.dtype, device=init_latents.device)
        t0 = int(ts[0])
        x = self.schedule.gamma[t0] * init_latents + self.schedule.sigma[t0] * noise
        both = torch.cat([uncond_embeds, prompt_embeds], dim=0)
        prev = np.concatenate([ts[1:], [-1]])
        for t, p in zip(ts, prev):
            eps_uncond, delta = cfg_branches(self._eps_fn(unet), x, int(t), both)
            x = ddim_step(self.schedule, x, eps_uncond + guidance_scale * delta, int(t), int(p))
        return _to_unit_images(self.vae_decode(x))

    # --------------------------------------------- memorisation diagnostics
    def _text_norm_loss(self, unet, latents, t: int, prompt_embeds, uncond_embeds):
        """‖ε_text − ε_uncond‖ over the whole batch, and (ε_uncond, delta)."""
        B = latents.shape[0]
        both = torch.cat([uncond_embeds.expand(B, *uncond_embeds.shape[-2:]),
                          prompt_embeds.expand(B, *prompt_embeds.shape[-2:])])
        eps_uncond, delta = cfg_branches(self._eps_fn(unet), latents, int(t), both)
        return torch.sqrt(torch.sum(delta.float() ** 2)), (eps_uncond, delta)

    def _advance(self, unet, latents, t: int, p: int, embeds, uncond_embeds, guidance_scale):
        with torch.no_grad():
            _, (eps_uncond, delta) = self._text_norm_loss(unet, latents, t, embeds,
                                                          uncond_embeds)
            return ddim_step(self.schedule, latents, eps_uncond + guidance_scale * delta, t, p)

    def _start_latents(self, generator, height, width, latents):
        if latents is not None:
            return latents
        return torch.randn(self._latent_shape(1, height, width), generator=generator,
                           device=self.device)

    def get_text_cond_grad(self, prompt_embeds: torch.Tensor, uncond_embeds: torch.Tensor,
                           generator: Optional[torch.Generator] = None, height: int = 512,
                           width: int = 512, num_inference_steps: int = 50,
                           guidance_scale: float = 7.5, target_steps: Sequence[int] = (0,),
                           unet: Any = None, latents: Optional[torch.Tensor] = None
                           ) -> np.ndarray:
        """Mean over the target steps of the per-token L2 norm of
        ∂‖ε_text − ε_uncond‖/∂embeds: [L] token-gradient magnitudes. The
        start latents are ``latents`` or a draw from ``generator``."""
        unet = self.unet if unet is None else unet
        ts = spaced_timesteps(self.schedule.num_train_timesteps, num_inference_steps)
        prev = np.concatenate([ts[1:], [-1]])
        latents = self._start_latents(generator, height, width, latents)
        grads = []
        target = set(int(s) for s in target_steps)
        for i, (t, p) in enumerate(zip(ts, prev)):
            if i in target:
                with torch.enable_grad():
                    e = prompt_embeds.detach().clone().requires_grad_(True)
                    val, _ = self._text_norm_loss(unet, latents, int(t), e, uncond_embeds)
                    (g,) = torch.autograd.grad(val, e)
                grads.append(torch.sqrt(torch.sum(g.float() ** 2, dim=-1)).mean(dim=0))
            if i == max(target):
                break
            latents = self._advance(unet, latents, int(t), int(p), prompt_embeds, uncond_embeds,
                                    guidance_scale)
        return torch.stack(grads).mean(dim=0).cpu().numpy()

    def aug_prompt(self, prompt_embeds: torch.Tensor, uncond_embeds: torch.Tensor,
                   generator: Optional[torch.Generator] = None, height: int = 512,
                   width: int = 512, num_inference_steps: int = 50,
                   guidance_scale: float = 7.5, target_steps: Sequence[int] = (0,),
                   lr: float = 0.1, optim_iters: int = 10, target_loss: Optional[float] = None,
                   optim_epsilon: Optional[float] = None, alpha: float = 0.5, unet: Any = None,
                   latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Lower ‖ε_text − ε_uncond‖ at the first target step by AdamW on the
        embeddings (weight decay 0.01): the BOS token's gradient zeroed, an
        L2 anchor to the initial embeddings mixed in while their drift
        exceeds ``optim_epsilon``, and a stop before the step whose current
        norm is at most ``target_loss``."""
        unet = self.unet if unet is None else unet
        ts = spaced_timesteps(self.schedule.num_train_timesteps, num_inference_steps)
        prev = np.concatenate([ts[1:], [-1]])
        latents = self._start_latents(generator, height, width, latents)
        first_target = min(int(s) for s in target_steps)
        for i in range(first_target):
            latents = self._advance(unet, latents, int(ts[i]), int(prev[i]), prompt_embeds,
                                    uncond_embeds, guidance_scale)
        t = int(ts[first_target])
        init = prompt_embeds.detach()
        embeds = init.clone().requires_grad_(True)
        opt = torch.optim.AdamW([embeds], lr=lr, weight_decay=0.01)
        for _ in range(optim_iters):
            with torch.enable_grad():
                norm, _ = self._text_norm_loss(unet, latents, t, embeds, uncond_embeds)
                loss = norm
                if optim_epsilon is not None:
                    # double where: sqrt'(0) = inf would turn the unselected
                    # branch's gradient into NaN at zero drift (the first step)
                    sq = torch.sum((embeds[:, 1:] - init[:, 1:]).float() ** 2, dim=-1)
                    pos = sq > 0.0
                    safe = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
                    drift = torch.where(pos, safe, torch.zeros_like(safe)).mean()
                    loss = torch.where(drift > optim_epsilon,
                                       alpha * norm + (1 - alpha) * drift, norm)
                (g,) = torch.autograd.grad(loss, embeds)
            # the current norm is checked before the step is taken, so an
            # iterate already at the target comes back unchanged
            if target_loss is not None and float(norm.detach()) <= target_loss:
                break
            g[:, 0] = 0.0  # BOS frozen
            embeds.grad = g
            opt.step()
        return embeds.detach()
