"""The Stable Diffusion 1.x UNet: the port's ``UNet2DCondition`` and the
reference ``portbench.reference.unet2d_cond`` beside it."""

from __future__ import annotations

import torch

from portbench.families.unet2d import _port_config
from portbench.reference import unet2d_cond as reference

CONTEXT_TOKENS = 77


def build_port(unet: dict, knobs: dict, dtype: torch.dtype, device):
    from siss_tpu_torch.models import UNet2DConditionConfig
    from siss_tpu_torch.models.unet2d_cond import UNet2DCondition
    from siss_tpu_torch.train import cond_unet_eps_apply

    knobs = {"num_attention_heads": unet["attention_head_dim"], **knobs}
    with torch.device("meta"):
        model = UNet2DCondition(_port_config(UNet2DConditionConfig, unet, knobs), dtype=dtype)
    return model.to_empty(device=device), cond_unet_eps_apply


def reference_eps(unet: dict):
    def eps(P, x, t, cond):
        return reference.forward(P, unet, x.permute(0, 3, 1, 2), t, cond).permute(0, 2, 3, 1)
    return eps


def image_shape(unet: dict):
    return (unet["sample_size"], unet["sample_size"], unet["in_channels"])


def conditioning(unet: dict, rows: int, generator, device):
    """``rows`` prompt embeddings [rows, 77, cross_attention_dim], as the
    CLIP text tower's last hidden state would give them (unit scale)."""
    return torch.randn((rows, CONTEXT_TOKENS, unet["cross_attention_dim"]), generator=generator,
                       device=device)


def flash_sites(unet: dict):
    """(heads, N, d) of each self-attention in the flash kernels' scope (N a
    multiple of 128, d ≤ 128) at one UNet call: the 64×64 and 32×32 grids'
    transformers, down and up."""
    heads, size = unet["attention_head_dim"], unet["sample_size"]
    n_down = unet["layers_per_block"]
    n_up = unet["layers_per_block"] + 1
    sites = []
    for i, kind in enumerate(unet["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            sites += [(size // 2 ** i, unet["block_out_channels"][i] // heads)] * n_down
    last = len(unet["block_out_channels"]) - 1
    for i, kind in enumerate(unet["up_block_types"]):
        if kind == "CrossAttnUpBlock2D":
            level = last - i
            sites += [(size // 2 ** level, unet["block_out_channels"][level] // heads)] * n_up
    return [(heads, hw * hw, d) for hw, d in sites if (hw * hw) % 128 == 0 and d <= 128]
