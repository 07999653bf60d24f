"""Fused SISS mixture-loss epilogue: port of ``siss_tpu/ops/siss_pallas.py``.

Per sample, the SISS objective needs the squared distances of the mixture
latent to both clean latents (for the importance weights) and the two
ε-MSE sums. Here one pass over the four big tensors computes them all:

    dist_x[b] = Σ (mix − γ·x_og)²          dist_a[b] = Σ (mix − γ·a_og)²
    lx[b]     = Σ (preds − (mix − γ·x_og)/σ)²
    la[b]     = Σ (preds − (mix − γ·a_og)/σ)²

The [B]-sized importance-weight math stays torch ops, and the backward
recomputes ε on the fly in one elementwise pass, so neither ε tensors nor
weighted-loss tensors are ever stored.

Two kernels carry it on the card, written in CUDA C++ for sm_90a
(``csrc/siss_reduce.cu``, ``csrc/siss_bwd.cu``). Each has a plain PyTorch
version beside it (``siss_reduce_plain``, ``siss_grad_preds_plain``); the
wrappers take the plain version only for tensors on the CPU, and for CUDA
tensors launch the kernel or raise. ``launch_counts`` counts the launches.
"""

from __future__ import annotations

import math

import torch

#: Kernel launches since the last ``reset_launch_counts()``, by kernel name.
launch_counts = {"siss_reduce": 0, "siss_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Target number of reduce blocks: about four per SM of a 132-SM H100.
_REDUCE_BLOCKS = 4 * 132
# Chunk lengths are multiples of this, a multiple of every vector width.
_CHUNK_ALIGN = 2048


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --- plain PyTorch versions ------------------------------------------------

def siss_reduce_plain(p2, m2, x2, a2, gamma, inv_sigma):
    """Plain version of the reduce kernel: [B, P] inputs → four fp32 [B]."""
    p2, m2, x2, a2 = (t.float() for t in (p2, m2, x2, a2))
    g = gamma.float()[:, None]
    inv_s = inv_sigma.float()[:, None]
    resid_x = m2 - g * x2
    resid_a = m2 - g * a2
    ex = p2 - resid_x * inv_s
    ea = p2 - resid_a * inv_s
    return ((resid_x * resid_x).sum(1), (resid_a * resid_a).sum(1),
            (ex * ex).sum(1), (ea * ea).sum(1))


def siss_grad_preds_plain(p2, m2, x2, a2, gamma, inv_sigma, cx, ca):
    """Plain version of the backward kernel: fp32 [B, P] ∂/∂preds."""
    p2, m2, x2, a2 = (t.float() for t in (p2, m2, x2, a2))
    g = gamma.float()[:, None]
    inv_s = inv_sigma.float()[:, None]
    ex = p2 - (m2 - g * x2) * inv_s
    ea = p2 - (m2 - g * a2) * inv_s
    return 2.0 * (cx.float()[:, None] * ex + ca.float()[:, None] * ea)


# --- kernel wrappers -------------------------------------------------------

def _check_big(tensors):
    p2 = tensors[0]
    if p2.ndim != 2:
        raise ValueError(f"expected [B, P] tensors, got shape {tuple(p2.shape)}")
    if p2.dtype not in _DTYPE_CODES:
        raise TypeError(f"SISS kernels take float32 or bfloat16, got {p2.dtype}")
    for t in tensors:
        if t.device != p2.device or t.dtype != p2.dtype or t.shape != p2.shape:
            raise ValueError("preds, mix, x_og and a_og must share device, dtype and shape; got "
                             f"{[(str(u.device), u.dtype, tuple(u.shape)) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError("SISS kernel inputs must be contiguous")


def _row_scalars(rows, B, device):
    out = []
    for r in rows:
        if r.shape != (B,) or r.device != device:
            raise ValueError(f"per-row scalars must be [{B}] on {device}, got "
                             f"{tuple(r.shape)} on {r.device}")
        out.append(r.to(torch.float32).contiguous())
    return out


def _vectorized(tensors, P, elem_size):
    """16-byte loads need 16-byte-aligned row starts in every tensor."""
    vec = 16 // elem_size
    return int(P % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def siss_reduce(p2, m2, x2, a2, gamma, inv_sigma):
    """(dist_x, dist_a, lx, la), each fp32 [B], from [B, P] inputs."""
    if not p2.is_cuda:
        return siss_reduce_plain(p2, m2, x2, a2, gamma, inv_sigma)
    from siss_tpu_torch.ops.build import load

    big = (p2, m2, x2, a2)
    _check_big(big)
    B, P = p2.shape
    gamma, inv_sigma = _row_scalars((gamma, inv_sigma), B, p2.device)
    n_target = max(1, math.ceil(_REDUCE_BLOCKS / B))
    chunk = math.ceil(math.ceil(P / n_target) / _CHUNK_ALIGN) * _CHUNK_ALIGN
    n_chunks = math.ceil(P / chunk)
    partials = torch.empty((4, B, n_chunks), dtype=torch.float32, device=p2.device)
    out = torch.empty((4, B), dtype=torch.float32, device=p2.device)
    stream = torch.cuda.current_stream(p2.device).cuda_stream
    err = load().siss_reduce(
        *(t.data_ptr() for t in big), gamma.data_ptr(), inv_sigma.data_ptr(),
        partials.data_ptr(), out.data_ptr(), B, P, chunk, n_chunks,
        _DTYPE_CODES[p2.dtype], _vectorized(big, P, p2.element_size()), stream)
    _raise_on(err, "siss_reduce")
    launch_counts["siss_reduce"] += 1
    return tuple(out.unbind(0))


def siss_grad_preds(p2, m2, x2, a2, gamma, inv_sigma, cx, ca):
    """fp32 [B, P] gradient of cx·lx + ca·la summed over rows, w.r.t. preds."""
    if not p2.is_cuda:
        return siss_grad_preds_plain(p2, m2, x2, a2, gamma, inv_sigma, cx, ca)
    from siss_tpu_torch.ops.build import load

    big = (p2, m2, x2, a2)
    _check_big(big)
    B, P = p2.shape
    gamma, inv_sigma, cx, ca = _row_scalars((gamma, inv_sigma, cx, ca), B, p2.device)
    grad = torch.empty((B, P), dtype=torch.float32, device=p2.device)
    vec = _vectorized(big, P, p2.element_size()) and _vectorized((grad,), P, p2.element_size())
    stream = torch.cuda.current_stream(p2.device).cuda_stream
    err = load().siss_bwd(
        *(t.data_ptr() for t in big), gamma.data_ptr(), inv_sigma.data_ptr(),
        cx.data_ptr(), ca.data_ptr(), grad.data_ptr(), B, P,
        _DTYPE_CODES[p2.dtype], int(vec), stream)
    _raise_on(err, "siss_bwd")
    launch_counts["siss_bwd"] += 1
    return grad


# --- the epilogue ------------------------------------------------------------

def _iw_from_dists(dist_x_raw, dist_a_raw, sigma, lambd):
    """Importance weights from raw squared distances (logaddexp-stable form)."""
    f32 = torch.float32
    denom = 2.0 * sigma.to(f32) ** 2
    d = (dist_x_raw - dist_a_raw) / denom
    lam = torch.tensor(lambd, dtype=f32, device=d.device)
    log_l = torch.log(lam)
    log_1ml = torch.log1p(-lam)
    iw_x = torch.exp(-torch.logaddexp(log_1ml, log_l + d))
    iw_a = torch.exp(-torch.logaddexp(log_1ml - d, log_l))
    return iw_x, iw_a


class SissCore(torch.autograd.Function):
    """Equal to ``_siss_core`` of the JAX package: (wlx_sum, wla_sum) with a
    gradient for ``preds`` only, plus the non-differentiable per-sample
    iw_x, iw_a, lx_mean and la_mean. A ``None`` cotangent (the output the
    current ``autograd.grad`` pull does not differentiate) counts as 0."""

    @staticmethod
    def forward(ctx, p2, m2, x2, a2, gamma, sigma, lambd, pixels):
        inv_sigma = 1.0 / sigma.to(torch.float32)
        dist_x, dist_a, lx, la = siss_reduce(p2, m2, x2, a2, gamma, inv_sigma)
        iw_x, iw_a = _iw_from_dists(dist_x, dist_a, sigma, lambd)
        wlx = torch.sum(iw_x * lx)
        wla = torch.sum(iw_a * la)
        aux = (iw_x, iw_a, lx / pixels, la / pixels)
        ctx.mark_non_differentiable(*aux)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(p2, m2, x2, a2, gamma, inv_sigma, iw_x, iw_a)
        return (wlx, wla) + aux

    @staticmethod
    def backward(ctx, cot_x, cot_a, *_aux):
        p2, m2, x2, a2, gamma, inv_sigma, iw_x, iw_a = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=p2.device)
        cx = (zero if cot_x is None else cot_x) * iw_x
        ca = (zero if cot_a is None else cot_a) * iw_a
        g2 = siss_grad_preds(p2, m2, x2, a2, gamma, inv_sigma, cx, ca)
        return (g2.to(p2.dtype),) + (None,) * 7


def siss_weighted_sums(preds, mix, x_og, a_og, gamma, sigma, lambd):
    """Fused SISS epilogue.

    Args: image-shaped tensors [B, ...] (fp32 or bf16, all the same type),
    gamma/sigma [B]. Returns (wlx_sum, wla_sum, aux) with per-sample iw_x,
    iw_a, lx_mean and la_mean. Only ``preds`` carries a gradient.
    """
    B = preds.shape[0]
    pixels = math.prod(preds.shape[1:])
    flat = [t.reshape(B, -1).contiguous() for t in (preds, mix, x_og, a_og)]
    wlx, wla, iw_x, iw_a, lx_mean, la_mean = SissCore.apply(
        *flat, gamma, sigma, float(lambd), pixels)
    aux = {"iw_x": iw_x, "iw_a": iw_a, "lx_mean": lx_mean, "la_mean": la_mean}
    return wlx, wla, aux


def siss_weighted_sums_reference(preds, mix, x_og, a_og, gamma, sigma, lambd):
    """Plain reference, the same math as the JAX package's
    ``siss_weighted_sums_reference``, differentiable by autograd."""
    f32 = torch.float32
    shape = (-1,) + (1,) * (preds.ndim - 1)
    g = gamma.reshape(shape).to(f32)
    s = sigma.reshape(shape).to(f32)
    preds, mix, x_og, a_og = (t.to(f32) for t in (preds, mix, x_og, a_og))
    resid_x = mix - g * x_og
    resid_a = mix - g * a_og
    ex = preds - resid_x / s
    ea = preds - resid_a / s
    dims = tuple(range(1, preds.ndim))
    dist_x_raw = (resid_x ** 2).sum(dims)
    dist_a_raw = (resid_a ** 2).sum(dims)
    iw_x, iw_a = _iw_from_dists(dist_x_raw, dist_a_raw, sigma, lambd)
    lx = (ex ** 2).sum(dims)
    la = (ea ** 2).sum(dims)
    pixels = math.prod(preds.shape[1:])
    aux = {"iw_x": iw_x, "iw_a": iw_a, "lx_mean": lx / pixels, "la_mean": la / pixels}
    return torch.sum(iw_x * lx), torch.sum(iw_a * la), aux
