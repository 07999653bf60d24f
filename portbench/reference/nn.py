"""Parameters and layers of the reference UNets.

``Params`` hands each layer its tensors by name. Made without tensors it
records the name, shape and kind of each parameter a forward asks for and
hands out meta tensors instead, so a forward on meta inputs lists the
model's parameters (``parameter_shapes``) and counts its FLOPs without
computing. With ``precision="float8"`` (the control) every matrix product
and convolution computes as bf16 autocast does, a step lower: its operands
and its result, in the forward and in the backward, are rounded to float8
e4m3 with one scale per tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (amax to 448),
    back in float32."""
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Fp8Conv(torch.autograd.Function):
    """conv2d in float8: its operands and its results, forward and
    backward, rounded (where bf16 autocast keeps them in bf16)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        xq, wq = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, b is not None)
        return round_fp8(F.conv2d(xq, wq, b, stride, padding))

    @staticmethod
    def backward(ctx, go):
        xq, wq = ctx.saved_tensors
        stride, padding, has_bias = ctx.conf
        gq = round_fp8(go)
        gx = round_fp8(torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding))
        gw = round_fp8(torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding))
        gb = round_fp8(go.sum((0, 2, 3))) if has_bias else None
        return gx, gw, gb, None, None


class _Fp8Matmul(torch.autograd.Function):
    """a·b in float8: its operands and its results, forward and backward,
    rounded."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(aq, bq)
        return round_fp8(torch.matmul(aq, bq))

    @staticmethod
    def backward(ctx, go):
        aq, bq = ctx.saved_tensors
        gq = round_fp8(go)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        gb = torch.matmul(aq.transpose(-1, -2), gq)
        # Sum the broadcast leading dims back to each operand's shape.
        while ga.ndim > aq.ndim:
            ga = ga.sum(0)
        while gb.ndim > bq.ndim:
            gb = gb.sum(0)
        return round_fp8(ga), round_fp8(gb)


class Params:
    """Parameters by name. ``tensors`` None: record shapes (meta tensors)."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None,
                 precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tensors = tensors
        self.shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        self.fp8 = precision == "float8"

    def get(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.tensors is None:
            self.shapes[name] = (shape, kind)
            return torch.empty(shape, device="meta")
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        return t



def conv(P: Params, x, name, cin, cout, k, stride=1, padding=0, bias=True):
    w = P.get(f"{name}.weight", (cout, cin, k, k), "weight")
    b = P.get(f"{name}.bias", (cout,), "bias") if bias else None
    if P.fp8:
        return _Fp8Conv.apply(x, w, b, stride, padding)
    return F.conv2d(x, w, b, stride, padding)


def linear(P: Params, x, name, cin, cout, bias=True):
    w = P.get(f"{name}.weight", (cout, cin), "weight")
    b = P.get(f"{name}.bias", (cout,), "bias") if bias else None
    out = matmul(P, x, w.t())
    return out if b is None else out + b


def matmul(P: Params, a, b):
    return _Fp8Matmul.apply(a, b) if P.fp8 else torch.matmul(a, b)


def group_norm(P: Params, x, name, groups, ch, eps):
    return F.group_norm(x, groups, P.get(f"{name}.weight", (ch,), "norm_weight"),
                        P.get(f"{name}.bias", (ch,), "norm_bias"), eps)


def layer_norm(P: Params, x, name, ch, eps):
    return F.layer_norm(x, (ch,), P.get(f"{name}.weight", (ch,), "norm_weight"),
                        P.get(f"{name}.bias", (ch,), "norm_bias"), eps)


def attention(P: Params, q, k, v, scale):
    """softmax(q·kᵀ·scale)·v over [..., N, d]."""
    return matmul(P, torch.softmax(matmul(P, q, k.transpose(-1, -2)) * scale, dim=-1), v)


def timestep_embedding(t, dim, flip_sin_to_cos, freq_shift, max_period=10000.0):
    """Sinusoidal embedding (DDPM / diffusers convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def resnet(P: Params, x, temb, name, cin, cout, temb_ch, groups, eps, out_scale=1.0):
    h = conv(P, F.silu(group_norm(P, x, f"{name}.norm1", groups, cin, eps)), f"{name}.conv1",
             cin, cout, 3, padding=1)
    h = h + linear(P, F.silu(temb), f"{name}.time_emb_proj", temb_ch, cout)[:, :, None, None]
    h = F.silu(group_norm(P, h, f"{name}.norm2", groups, cout, eps))
    h = conv(P, h, f"{name}.conv2", cout, cout, 3, padding=1)
    skip = conv(P, x, f"{name}.conv_shortcut", cin, cout, 1) if cin != cout else x
    return (h + skip) / out_scale


def downsample(P: Params, x, name, ch, padding):
    if padding == 0:   # the asymmetric (0, 1, 0, 1) pad of the google/ddpm-* UNets
        x = F.pad(x, (0, 1, 0, 1))
    return conv(P, x, f"{name}.conv", ch, ch, 3, stride=2, padding=padding)


def upsample(P: Params, x, name, ch):
    return conv(P, F.interpolate(x, scale_factor=2.0, mode="nearest"), f"{name}.conv", ch, ch, 3,
                padding=1)


def parameter_shapes(forward, *inputs) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of every parameter ``forward(P, *inputs)`` asks
    for, in the order it asks; ``inputs`` are meta tensors."""
    P = Params()
    forward(P, *inputs)
    return P.shapes
