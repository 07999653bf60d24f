"""UNet building blocks (NCHW): port of ``siss_tpu/models/layers.py``.

Same math as the flax blocks, with diffusers module names so an exported
flax param tree loads with ``strict=True``. Activations are NCHW; on the
card the model runs in ``channels_last`` memory format, and attention reads
its [B, HW, C] view straight from that layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False, downscale_freq_shift: float = 1.0,
                           scale: float = 1.0, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers ``get_timestep_embedding``
    semantics (incl. the ``freq_shift`` quirk of google/ddpm-* models)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.to(torch.float32)[:, None]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Linear → SiLU → Linear projection of the sinusoidal embedding."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """GroupNorm → SiLU → Conv, time-emb add, GroupNorm → SiLU → Conv, +skip.
    A channel change goes through a 1×1 ``conv_shortcut``."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 groups: int = 32, eps: float = 1e-6, output_scale_factor: float = 1.0):
        super().__init__()
        self.output_scale_factor = output_scale_factor
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return (h + residual) / self.output_scale_factor


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Materialised attention over [..., N, d]: fp32 logits and softmax,
    then P cast to v's type before P·V, as the flax blocks do."""
    with torch.autocast(q.device.type, enabled=False):
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


class SpatialAttention(nn.Module):
    """Self-attention over the H×W grid (diffusers ``Attention`` inside
    Attn{Down,Up,Mid}Block2D). Logits and softmax are fp32, then cast to
    v's dtype, as in the flax block; plain matmuls, no fused kernel."""

    def __init__(self, channels: int, num_heads: int = 1, groups: int = 32, eps: float = 1e-6,
                 rescale_output_factor: float = 1.0):
        super().__init__()
        self.num_heads = num_heads
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        residual = x
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        head_dim = C // self.num_heads

        def split(a):
            return a.reshape(B, H * W, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = split(self.to_q(h)), split(self.to_k(h)), split(self.to_v(h))
        out = attention_core(q, k, v, 1.0 / math.sqrt(head_dim))
        out = out.transpose(1, 2).reshape(B, H * W, C)
        out = self.to_out[0](out)
        out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return (out + residual) / self.rescale_output_factor


class Downsample2D(nn.Module):
    """Stride-2 conv downsample. ``padding=0`` is the DDPM asymmetric
    (0,1,0,1) pad of google/ddpm-* checkpoints; ``padding=1`` symmetric."""

    def __init__(self, channels: int, out_channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2× upsample + 3×3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
