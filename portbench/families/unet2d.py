"""The unconditional DDPM UNet: the port's ``UNet2D`` and the reference
``portbench.reference.unet2d`` beside it."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import unet2d as reference


def _port_config(cls, unet: dict, knobs: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in unet.items() if k in fields}
    return cls(**kw, **knobs)


def build_port(unet: dict, knobs: dict, dtype: torch.dtype, device):
    """The port's model with uninitialised parameters on ``device`` (the
    harness loads its weights), and its ε function on NHWC inputs."""
    from siss_tpu_torch.models import UNet2DConfig
    from siss_tpu_torch.models.unet2d import UNet2D
    from siss_tpu_torch.train import unet_eps_apply

    with torch.device("meta"):
        model = UNet2D(_port_config(UNet2DConfig, unet, knobs), dtype=dtype)
    return model.to_empty(device=device), unet_eps_apply


def reference_eps(unet: dict):
    """``eps(P, x_nhwc, t, cond)`` of the reference."""
    def eps(P, x, t, cond):
        return reference.forward(P, unet, x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)
    return eps


def image_shape(unet: dict):
    return (unet["sample_size"], unet["sample_size"], unet["in_channels"])


def conditioning(unet: dict, rows: int, generator, device):
    return None


def flash_sites(unet: dict):
    """(heads, N, d) of each self-attention the flash kernels' scope covers: none
    here (the 16×16 attention has one head of 512 channels)."""
    return []
