"""The yardstick: one H100's published peaks, and the least time each
measured piece of work could take on it.

Peaks are NVIDIA's data sheet for the H100 SXM part, dense, at its 700 W
limit. A bound is the larger of operations over the peak of the type the
configuration computes in and bytes over the HBM rate, with each input byte
read once and each output byte written once. Operations count 2 per
multiply-add and are counted from the configuration's shapes, never from an
implementation: attention by the products it needs (no recomputation), a
training step as 5 forwards (one forward and two backward pulls of twice a
forward each).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
TRAIN_FORWARDS = 5


def peak(config: dict) -> float:
    """The peak rate of the configuration's compute type."""
    return PEAK_FLOPS[config["compute_dtype"]]


def bound_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)


def attention_fwd(B, H, N, d, esize, flops_per_s):
    """O = softmax(Q·Kᵀ)·V: S and P·V; reads Q, K, V, writes O and the
    fp32 row log-sum-exp."""
    return bound_s(4 * B * H * N * N * d, 4 * B * H * N * d * esize + 4 * B * H * N, flops_per_s)


def attention_bwd(B, H, N, d, esize, flops_per_s):
    """dV = Pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q (S is the forward's
    product and not counted again); reads Q, K, V, O, dO and the row
    log-sum-exp, writes dQ, dK, dV."""
    return bound_s(8 * B * H * N * N * d, 8 * B * H * N * d * esize + 4 * B * H * N, flops_per_s)


def siss_reduce(rows, pixels, esize=4):
    """Four [rows, pixels] reads (ε̂, x_t, x, a), four [rows] fp32 sums out."""
    return bound_s(0, 4 * rows * pixels * esize + 16 * rows, 1.0)


def siss_bwd(rows, pixels, esize=4):
    """Four [rows, pixels] reads and one fp32 [rows, pixels] gradient out."""
    return bound_s(0, 4 * rows * pixels * esize + 4 * rows * pixels, 1.0)
