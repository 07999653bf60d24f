"""UNet building blocks (NCHW): port of ``siss_tpu/models/layers.py``.

Same math as the flax blocks, with diffusers module names so an exported
flax param tree loads with ``strict=True``. Activations are NCHW; on the
card the model runs in ``channels_last`` memory format, and attention reads
its [B, HW, C] view straight from that layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siss_tpu_torch.parallel.tensor import (TensorSplit, block, copy, local_size, reduce, row_conv,
                                            row_linear)


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
    A channel change goes through a 1×1 ``conv_shortcut``.

    ``dropout`` > 0 puts inverted dropout between ``norm2``'s SiLU and
    ``conv2``, as the flax block does, and only with ``deterministic=False``
    (never by ``module.training``: no caller of the JAX package passes
    False, so its train step drops nothing). The keep mask is ``mask`` when
    given, else drawn from ``generator``.

    Under a ``tensor`` axis (``set_tensor_split``) ``conv1``,
    ``time_emb_proj`` and ``norm2`` hold this rank's block of the output
    channels (and of the groups), ``conv2`` its block of the input channels:
    its partial output is summed over the tensor ranks, then its bias added
    once. ``norm1`` and the shortcut stay whole."""

    tensor_split = None

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 groups: int = 32, eps: float = 1e-6, output_scale_factor: float = 1.0,
                 dropout: float = 0.0):
        super().__init__()
        self.output_scale_factor = output_scale_factor
        self.dropout = dropout
        self.groups, self.out_channels = groups, out_channels
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def set_tensor_split(self, split: Optional[TensorSplit]) -> Tuple[str, ...]:
        """Run on this rank's channels under ``split`` (None: whole again);
        ``norm2`` then normalises groups/tp groups of channels/tp channels.
        Returns the whole parameters used in a slice: none."""
        self.norm2.num_groups = local_size(self.groups, split, "groups", "ResnetBlock2D")
        self.norm2.num_channels = local_size(self.out_channels, split, "channels", "ResnetBlock2D")
        self.tensor_split = split
        return ()

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        split = self.tensor_split
        h = self.conv1(copy(F.silu(self.norm1(x)), split))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(copy(F.silu(temb), split))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if self.dropout > 0.0 and not deterministic:
            h = inverted_dropout(h, self.dropout, generator, mask)
        h = row_conv(h, self.conv2, split)
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return (h + residual) / self.output_scale_factor


def inverted_dropout(h: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − rate
    (``mask`` True, or a draw from ``generator``) and scale it by
    1 / (1 − rate); zero the rest."""
    if rate >= 1.0:
        return torch.zeros_like(h)
    if mask is None:
        mask = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
    return torch.where(mask, h / (1.0 - rate), torch.zeros_like(h))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   split: Optional[TensorSplit] = None) -> torch.Tensor:
    """Materialised attention over [..., N, d]: fp32 logits and softmax,
    then P cast to v's type before P·V, as the flax blocks do. Under
    ``split`` q and k hold this rank's part of each head's dimension: the
    logits are summed over the tensor ranks before the softmax."""
    with torch.autocast(q.device.type, enabled=False):
        attn = reduce(torch.matmul(q.float(), k.float().transpose(-1, -2)), split) * scale
        attn = copy(torch.softmax(attn, dim=-1), split)
    return torch.matmul(attn.to(v.dtype), v)


class SpatialAttention(nn.Module):
    """Self-attention over the H×W grid (diffusers ``Attention`` inside
    Attn{Down,Up,Mid}Block2D). Logits and softmax are fp32, then cast to
    v's dtype, as in the flax block; plain matmuls, no fused kernel.

    Under a ``tensor`` axis (``set_tensor_split``) ``to_q``/``to_k``/``to_v``
    hold this rank's block of output channels and use the same slice of
    their whole biases, ``to_out`` its block of input channels. When the
    ranks divide the heads each rank runs heads/tp whole heads; one head (the
    celeb UNet's) is split along its dimension, so each rank's q·kᵀ is a
    partial sum of the fp32 logits, summed over the tensor ranks before the
    softmax."""

    tensor_split = None

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

    def set_tensor_split(self, split: Optional[TensorSplit]) -> Tuple[str, ...]:
        """Run on this rank's heads (or its part of the one head) under
        ``split`` (None: whole again). Returns the whole parameters used in
        a slice: the q, k and v biases."""
        if split is not None and self.num_heads > 1:
            local_size(self.num_heads, split, "heads", "SpatialAttention")
        self.tensor_split = split
        return () if split is None else ("to_q.bias", "to_k.bias", "to_v.bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        split = self.tensor_split
        residual = x
        h = copy(self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C), split)
        head_dim = C // self.num_heads
        # This rank's heads; one head is split along its dimension instead.
        heads = local_size(self.num_heads, split if self.num_heads > 1 else None, "heads",
                           "SpatialAttention")

        def project(lin):   # [B, N, heads·d] → a [B, heads, N, d] view
            a = F.linear(h, lin.weight, block(lin.bias, split))
            return a.reshape(B, H * W, heads, -1).transpose(1, 2)

        out = attention_core(project(self.to_q), project(self.to_k), project(self.to_v),
                             1.0 / math.sqrt(head_dim), split if self.num_heads == 1 else None)
        out = row_linear(out.transpose(1, 2).reshape(B, H * W, -1), self.to_out[0], split)
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
