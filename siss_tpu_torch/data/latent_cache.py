"""Frozen-VAE latent-moment cache of the SD task: port of
``siss_tpu/data/latent_cache.py``.

The VAE encoder is frozen and deterministic, and both SISS streams draw
from finite image sets, so each image's posterior moments (mean, logvar)
do not change from step to step: only the reparameterisation noise does.
The task encodes every image once at start-up and samples

    z = (mean + exp(½·logvar)·noise) · scaling_factor

in the step, which is what encoding in the step gives: the moments are the
same per-sample values (the encoder has no cross-sample operation) and the
normal draws are taken in the same order. ``random_flip`` flips the pixels
before the encode, and the VAE is not flip-equivariant, so the cache keeps
both orientations (axis 1: unflipped, flipped) and the step picks one per
sample with the flip mask it would have applied to the pixels. The cache is
host numpy in fp32: the encoder's outputs in the compute dtype, widened.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


@torch.no_grad()
def build_moment_cache(encode_moments: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                       dataset, microbatch: int, random_flip: bool,
                       device="cuda") -> np.ndarray:
    """Every image of ``dataset`` (NHWC numpy) through ``encode_moments``
    once, in batches of ``microbatch`` on ``device`` (the ragged tail padded
    with the first image of its batch). Returns fp32 ``[N, O, h, w, 2C]``:
    O = 2 with ``random_flip`` (index 1 the W-flipped image) else 1, the
    last axis ``concat(mean, logvar)``."""
    n = len(dataset)
    microbatch = max(1, min(int(microbatch), n))
    out = None
    for start in range(0, n, microbatch):
        idx = range(start, min(start + microbatch, n))
        imgs = np.stack([np.asarray(dataset[i], np.float32) for i in idx])
        pad = microbatch - len(imgs)
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[:1], pad, axis=0)])
        x = torch.from_numpy(imgs).to(device)
        variants = [x, x.flip(2)] if random_flip else [x]  # NHWC: flip W
        moms = [torch.cat(encode_moments(v), dim=-1).float().cpu().numpy() for v in variants]
        m = np.stack(moms, axis=1)  # [mb, O, h, w, 2C]
        if out is None:
            out = np.empty((n, *m.shape[1:]), np.float32)
        out[start:start + len(idx)] = m[:len(idx)]
    return out


def cache_nbytes(n_images: int, resolution: int, vae_scale_factor: int, latent_channels: int,
                 random_flip: bool) -> int:
    """Host bytes of ``build_moment_cache`` for ``n_images`` (fp32)."""
    hw = resolution // vae_scale_factor
    orient = 2 if random_flip else 1
    return n_images * orient * hw * hw * 2 * latent_channels * 4


def sample_from_moments(moments: torch.Tensor, flip: Optional[torch.Tensor],
                        scaling_factor: float, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[A, mb, O, h, w, 2C]`` cached moments → ``[A, mb, h, w, C]`` latents.

    ``flip`` is the step's one [A, mb] boolean mask (or None without
    ``random_flip``), the same for the keep and forget streams. The normal
    draws are ``noise`` [A, mb, h, w, C], or one draw of the latent shape per
    accumulation microbatch from ``generator``, as ``encode_sample`` takes
    them microbatch by microbatch in the uncached step."""
    sel = moments[:, :, 0]
    if flip is not None:
        sel = torch.where(flip.reshape(*flip.shape[:2], 1, 1, 1), moments[:, :, 1], sel)
    mean, logvar = sel.float().chunk(2, dim=-1)
    if noise is None:
        noise = torch.stack([torch.randn(mean.shape[1:], generator=generator, device=mean.device)
                             for _ in range(mean.shape[0])])
    return (mean + torch.exp(0.5 * logvar) * noise) * scaling_factor
