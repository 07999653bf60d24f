"""Flash attention: port of the JAX library's Pallas TPU flash-attention
kernels (``jax/experimental/pallas/ops/tpu/flash_attention.py``), which the
SD UNet runs at its ``attention_impl="flash"`` self-attention sites.

O = softmax(Q Kᵀ·scale)·V over [B, H, N, d] operands, with fp32 logits and
P cast to V's type before P·V, and its gradient. Three kernels, written in
CUDA C++ for sm_90a, carry it on the card:

- ``flash_fwd``: O and the row log-sum-exp ``lse`` (the residual);
- ``flash_bwd_dkv`` and ``flash_bwd_dq``: dK and dV in one kernel, dQ in
  another, from q, k, v, lse, dO and di = rowsum(O·dO).

Each C entry point dispatches on the operands' type (``kernel_impl``), and
every kernel runs on the tensor cores. bf16 runs ``wgmma`` with TMA tile
copies (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``,
``csrc/flash_bwd_dq_sm90.cu``). fp32 runs ``tf32x3``
(``csrc/flash_fwd_tf32x3.cu``, ``csrc/flash_bwd_dkv_tf32x3.cu``,
``csrc/flash_bwd_dq_tf32x3.cu``): ``mma.sync`` with each operand split into
two TF32 parts and each product issued three times, so the products keep
fp32 accuracy; ``split_tf32``, ``flash_attention_tf32x3_emulated``,
``flash_bwd_dkv_tf32x3_emulated`` and ``flash_bwd_dq_tf32x3_emulated`` model
their arithmetic.

Each has a plain PyTorch version beside it (``flash_attention_plain``,
``flash_bwd_dkv_plain``, ``flash_bwd_dq_plain``; ``flash_attention_bwd_plain``
is the whole backward). The wrappers take the plain version only for
tensors on the CPU; for CUDA tensors they launch the kernel or raise.
``launch_counts`` counts the launches.

The kernels read their operands through strides, so q, k and v may be the
[B, H, N, d] views of the projections' [B, N, H, d] outputs, and o and the
gradients come back as such views: no transpose copies. Scope: non-causal
self-attention, N a multiple of 128, d ≤ 128, fp32 or bf16. The bf16
tensor-core kernels copy tiles with TMA in 16-byte column groups, so in
bf16 d must be a multiple of 8 and each operand's base address and batch,
head and sequence strides multiples of 16 bytes.
"""

from __future__ import annotations

import ctypes

import torch

from siss_tpu_torch.ops.batched import rebatch, unbatch

#: Kernel launches since the last ``reset_launch_counts()``, by kernel name.
launch_counts = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernels are built for (FLASH_HEAD_DIMS in csrc/flash_common.cuh);
# d is padded up to the next one.
_HEAD_DIMS = (8, 16, 40, 64, 80, 128)
# The sequence length must be a multiple of every block's row count.
_SEQ_MULTIPLE = 128
# What each C entry point runs for each operand type.
_IMPLS = {"flash_fwd": {torch.float32: "tf32x3", torch.bfloat16: "wgmma"},
          "flash_bwd_dkv": {torch.float32: "tf32x3", torch.bfloat16: "wgmma"},
          "flash_bwd_dq": {torch.float32: "tf32x3", torch.bfloat16: "wgmma"}}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --- plain PyTorch versions ------------------------------------------------

def flash_attention_plain(q, k, v, scale):
    """Plain version of the forward kernel: (o in q's type, fp32 lse [B, H, N])."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        lse = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1).to(v.dtype).float()
        o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse


def _probs(q, k, v, lse, do, di, scale):
    """fp32 P and dS, as both backward kernels recompute them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (dp - di[..., None]) * p * scale
    return p, ds


def flash_bwd_dkv_plain(q, k, v, lse, do, di, scale):
    """Plain version of the dK/dV kernel: (dk, dv) in q's type."""
    with torch.autocast(q.device.type, enabled=False):
        p, ds = _probs(q, k, v, lse, do, di, scale)
        dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
        dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, lse, do, di, scale):
    """Plain version of the dQ kernel: dq in q's type."""
    with torch.autocast(q.device.type, enabled=False):
        _, ds = _probs(q, k, v, lse, do, di, scale)
        dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def row_dot(o, do):
    """di = rowsum(O·dO) in fp32, [B, H, N]: the backward's one input that
    the TPU version also computes outside its kernels."""
    return (o.float() * do.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale):
    """The whole backward, written out (no autograd): (dq, dk, dv)."""
    di = row_dot(o, do)
    dk, dv = flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    return flash_bwd_dq_plain(q, k, v, lse, do, di, scale), dk, dv


# --- models of the 3xTF32 kernel's arithmetic -------------------------------

def split_tf32(x):
    """(hi, lo) of fp32 ``x`` as the 3xTF32 kernel's ``split`` forms them,
    bit for bit: hi = rna(x) and lo = rna(x − hi), where rna rounds to TF32
    (10 mantissa bits, the low 13 bits of the fp32 pattern zero) to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` does. The kernel rounds
    hi by integer operations on the bits (sign and magnitude: add half a
    TF32 ulp, 0x1000, and clear the low 13 bits; a carry moves into the
    exponent as it should, and subnormals round the same way), which gives
    cvt's bits for every x but NaN (at padded head dim 80 it rounds hi by
    cvt too), and lo by cvt itself. x − hi is exact in fp32, so
    |x − hi − lo| ≤ 2⁻²²·|x|. ±inf gives hi = ±inf and lo = NaN
    (inf − inf); a NaN gives lo = NaN, so the products stay NaN, whatever hi
    its bits round to (a NaN with the top mantissa bits set rounds to ∓0).
    An inf or NaN operand makes its rows NaN in the plain version too."""
    x = x.float()
    hi = _rna_bits(x)
    r = x - hi
    return hi, torch.where(torch.isnan(r), r, _rna_bits(r))


def _rna_bits(x):
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3_steps(acc, a, b, chained=False):
    """acc + a·b as the kernel forms it: over the contraction in 8-deep
    k-steps (``mma.sync`` m16n8k8), each step's a_lo·b_hi, a_hi·b_lo and then
    a_hi·b_hi, small terms first (lo·lo is dropped), summed into a zeroed
    accumulator and added to acc in fp32 (``mma3_add``), or with ``chained``
    added to acc one product at a time (``mma3``). Each product of TF32
    parts is exact in fp32; the sum inside a product is the tensor core's
    there and torch's here."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        step = acc if chained else 0.0
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            step = step + torch.matmul(x[..., ks], y[..., ks, :])
        acc = step if chained else acc + step
    return acc


def flash_attention_tf32x3_emulated(q, k, v, scale, keys_per_tile=64):
    """A plain model of the fp32 3xTF32 forward kernel's arithmetic: (o,
    lse) fp32. Per tile of ``keys_per_tile`` keys: S = Q·Kᵀ from split
    operands (``_mm3_steps``), scaled; the running row max m, rescale
    α = exp(m_old − m), P = exp(S − m), the row sum l = l·α + ΣP; O = O·α +
    P·V from split P and V. At padded head dims 64 and 80 the kernel sums a
    tile's P·V in one fresh accumulator before adding it to O, and runs two
    key groups, each over its half of the keys, merged at the end: m =
    max(m₀, m₁), l and O as l₀·e^(m₀−m) + l₁·e^(m₁−m). Then o = O / l,
    lse = m + log l. For the tests and ``chip_smoke.py``; nothing on the
    port's path calls it."""
    with torch.autocast(q.device.type, enabled=False):
        q, k, v = (t.float() for t in (q, k, v))
        d, N = q.shape[-1], k.shape[-2]
        pad = (0, -d % 8)  # the kernel's padded head dim: zeros add nothing
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
        groups = _tf32x3_groups(d)
        parts = [_online_softmax_pv(q, k[..., n0:n0 + N // groups, :],
                                    v[..., n0:n0 + N // groups, :], scale, keys_per_tile,
                                    pv_per_tile=groups == 2)
                 for n0 in range(0, N, N // groups)]
        m, l, acc = parts[0]
        if groups == 2:
            m1, l1, acc1 = parts[1]
            m_new = torch.maximum(m, m1)
            a0, a1 = torch.exp(m - m_new), torch.exp(m1 - m_new)
            l, acc, m = l * a0 + l1 * a1, acc * a0[..., None] + acc1 * a1[..., None], m_new
        return (acc / l[..., None])[..., :d], m + torch.log(l)


def flash_bwd_dkv_tf32x3_emulated(q, k, v, lse, do, di, scale):
    """A plain model of the fp32 3xTF32 dK/dV kernel's arithmetic: (dk, dv)
    fp32. Key-major, as the kernel: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ from split
    operands (``_mm3_steps``), Sᵀ scaled; P = exp(Sᵀ − lse) and dS = (dPᵀ −
    di)·P·scale, lse and di indexed by query; then dV = Σ P·dO and dK =
    Σ dS·Q over the queries in 8-deep steps, each added in fp32 (dS, signed,
    split as any operand). At padded head dims 64 and 80 the kernel runs
    two query groups, each over its half of the queries, and adds the
    second's dK and dV to the first's at the end. Tiling the queries does
    not change the sums: each group adds its steps in query order. For the
    tests and ``chip_smoke.py``; nothing on the port's path calls it."""
    with torch.autocast(q.device.type, enabled=False):
        q, k, v, do = (t.float() for t in (q, k, v, do))
        d, N = q.shape[-1], q.shape[-2]
        pad = (0, -d % 8)  # the kernel's padded head dim: zeros add nothing
        q, k, v, do = (torch.nn.functional.pad(t, pad) for t in (q, k, v, do))
        p = torch.exp(_mm3_steps(0.0, k, q.transpose(-1, -2)) * scale - lse[..., None, :])
        ds = (_mm3_steps(0.0, v, do.transpose(-1, -2)) - di[..., None, :]) * p * scale
        span = N // _tf32x3_groups(d)  # queries per group
        parts = [(_mm3_steps(torch.zeros_like(k), ds[..., m0:m0 + span], q[..., m0:m0 + span, :]),
                  _mm3_steps(torch.zeros_like(v), p[..., m0:m0 + span], do[..., m0:m0 + span, :]))
                 for m0 in range(0, N, span)]
        dk, dv = parts[0]
        for dk1, dv1 in parts[1:]:
            dk, dv = dk + dk1, dv + dv1
        return dk[..., :d], dv[..., :d]


def flash_bwd_dq_tf32x3_emulated(q, k, v, lse, do, di, scale):
    """A plain model of the fp32 3xTF32 dQ kernel's arithmetic: dq fp32.
    Query-major, as the kernel: S = Q·Kᵀ and dP = dO·Vᵀ from split operands
    (``_mm3_steps``), S scaled; P = exp(S − lse) and dS = (dP − di)·P·scale,
    lse and di indexed by query; then dQ = Σ dS·K over the keys in 8-deep
    steps, each added in fp32 (dS, signed, split as any operand). At padded
    head dims 64 and 80 the kernel runs two key groups, each over its half
    of the keys, and adds the second's dQ to the first's at the end. Tiling
    the keys does not change the sums: each group adds its steps in key
    order. For the tests and ``chip_smoke.py``; nothing on the port's path
    calls it."""
    with torch.autocast(q.device.type, enabled=False):
        q, k, v, do = (t.float() for t in (q, k, v, do))
        d, N = q.shape[-1], k.shape[-2]
        pad = (0, -d % 8)  # the kernel's padded head dim: zeros add nothing
        q, k, v, do = (torch.nn.functional.pad(t, pad) for t in (q, k, v, do))
        p = torch.exp(_mm3_steps(0.0, q, k.transpose(-1, -2)) * scale - lse[..., None])
        ds = (_mm3_steps(0.0, do, v.transpose(-1, -2)) - di[..., None]) * p * scale
        span = N // _tf32x3_groups(d)  # keys per group
        parts = [_mm3_steps(torch.zeros_like(q), ds[..., n0:n0 + span], k[..., n0:n0 + span, :])
                 for n0 in range(0, N, span)]
        dq = parts[0]
        for dq1 in parts[1:]:
            dq = dq + dq1
        return dq[..., :d]


def _tf32x3_groups(d):
    """Key groups of the 3xTF32 forward and dQ, query groups of its dK/dV:
    two at padded head dims 64 and 80, else one."""
    return 2 if padded_head_dim(d) in (64, 80) else 1


def _online_softmax_pv(q, k, v, scale, keys_per_tile, pv_per_tile):
    """One key group's pass of the kernel: (m, l, unnormalised O)."""
    rows = q.shape[:-1]
    m = torch.full(rows, -torch.inf, device=q.device)
    l = torch.zeros(rows, device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for n0 in range(0, k.shape[-2], keys_per_tile):
        kt, vt = k[..., n0:n0 + keys_per_tile, :], v[..., n0:n0 + keys_per_tile, :]
        s = _mm3_steps(0.0, q, kt.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if pv_per_tile:
            acc = acc * alpha[..., None] + _mm3_steps(torch.zeros_like(acc), p, vt, chained=True)
        else:
            acc = _mm3_steps(acc * alpha[..., None], p, vt)
        m = m_new
    return m, l, acc


# --- kernel wrappers -------------------------------------------------------

def padded_head_dim(d: int) -> int:
    for D in _HEAD_DIMS:
        if d <= D:
            return D
    raise ValueError(f"the flash-attention kernels take head_dim <= {_HEAD_DIMS[-1]}, got {d}")


def kernel_impl(name: str, dtype: torch.dtype) -> str:
    """Which kernel the C entry point ``name`` launches for ``dtype``
    operands: "wgmma" (bf16 tensor cores) or "tf32x3" (fp32 on the tensor
    cores, three TF32 products each)."""
    return _IMPLS[name][dtype]


def _check_tma_alignment(tensors):
    """The bf16 tensor-core kernels copy [B, H, N, d] tiles with TMA in
    16-byte column groups: d must be a multiple of 8, and the base address and
    the batch, head and sequence strides multiples of 16 bytes."""
    d = tensors[0].shape[3]
    if d % 8:
        raise ValueError(f"the bf16 flash-attention kernels need head_dim % 8 == 0 "
                         f"(16-byte column groups), got {d}")
    for t in tensors:
        size = t.element_size()
        strides = [s * size for s in t.stride()[:3]]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError("the bf16 flash-attention kernels copy tiles with TMA, which needs a "
                             "16-byte aligned base address and batch, head and sequence strides "
                             f"that are multiples of 16 bytes; got base address % 16 = "
                             f"{t.data_ptr() % 16} and strides {strides} bytes")


def _operands(*tensors):
    """Check the [B, H, N, d] operands; give each a contiguous head dim."""
    q = tensors[0]
    if q.ndim != 4:
        raise ValueError(f"flash attention takes [B, H, N, d] tensors, got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash-attention kernels take float32 or bfloat16, got {q.dtype}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash attention operands must share shape, dtype and device "
                             "(self-attention only); got "
                             f"{[(tuple(u.shape), u.dtype, str(u.device)) for u in tensors]}")
    N, d = q.shape[2], q.shape[3]
    if N % _SEQ_MULTIPLE:
        raise ValueError(f"the flash-attention kernels need N % {_SEQ_MULTIPLE} == 0, got N={N}")
    padded_head_dim(d)
    tensors = [t if t.stride(-1) == 1 else t.contiguous() for t in tensors]
    if q.dtype == torch.bfloat16:
        _check_tma_alignment(tensors)
    return tensors


def _empty_like_bnhd(q):
    """An uninitialised [B, H, N, d] view of a contiguous [B, N, H, d] tensor."""
    B, H, N, d = q.shape
    return torch.empty((B, N, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _f32_rows(t, shape, name):
    """lse or di: contiguous fp32 [B, H, N], 16-byte aligned (the bf16 dK/dV
    kernel copies its rows with bulk copies)."""
    if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous, 16-byte aligned float32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} at address % 16 = {t.data_ptr() % 16}")
    return t


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd(q, k, v, scale):
    """(o, lse): o [B, H, N, d] in q's type, lse fp32 [B, H, N]."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    from siss_tpu_torch.ops.build import load

    q, k, v = _operands(q, k, v)
    B, H, N, d = q.shape
    o = _empty_like_bnhd(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = load().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           lse.data_ptr(), B, H, N, d, padded_head_dim(d), _DTYPE_CODES[q.dtype],
                           _strides(q, k, v, o), float(scale),
                           torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return o, lse


def flash_bwd_dkv(q, k, v, lse, do, di, scale):
    """(dk, dv), each [B, H, N, d] in q's type."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    from siss_tpu_torch.ops.build import load

    q, k, v, do = _operands(q, k, v, do)
    B, H, N, d = q.shape
    lse, di = (_f32_rows(t, (B, H, N), n) for t, n in ((lse, "lse"), (di, "di")))
    dk, dv = _empty_like_bnhd(q), _empty_like_bnhd(q)
    err = load().flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                               do.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               B, H, N, d, padded_head_dim(d), _DTYPE_CODES[q.dtype],
                               _strides(q, k, v, do, dk, dv), float(scale),
                               torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dkv")
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, lse, do, di, scale):
    """dq [B, H, N, d] in q's type."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, lse, do, di, scale)
    from siss_tpu_torch.ops.build import load

    q, k, v, do = _operands(q, k, v, do)
    B, H, N, d = q.shape
    lse, di = (_f32_rows(t, (B, H, N), n) for t, n in ((lse, "lse"), (di, "di")))
    dq = _empty_like_bnhd(q)
    err = load().flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                              do.data_ptr(), di.data_ptr(), dq.data_ptr(),
                              B, H, N, d, padded_head_dim(d), _DTYPE_CODES[q.dtype],
                              _strides(q, k, v, do, dq), float(scale),
                              torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_bwd_dq")
    launch_counts["flash_bwd_dq"] += 1
    return dq


class FlashAttention(torch.autograd.Function):
    """softmax(Q Kᵀ·scale)·V with the flash kernels forward and backward.
    Saves q, k, v, o and lse; the backward computes di, then dK/dV and dQ."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do, level = unbatch(do)
        if level is None:
            di = row_dot(o, do)
            dk, dv = flash_bwd_dkv(q, k, v, lse, do, di, ctx.scale)
            dq = flash_bwd_dq(q, k, v, lse, do, di, ctx.scale)
            return dq, dk, dv, None
        # A stack of S cotangents (``autograd.grad(..., is_grads_batched=True)``):
        # folded into the batch, so each backward kernel launches once, at
        # (S·B, H, N, d), on S contiguous copies of q, k, v, o and lse.
        S, (B, H, N, d) = do.shape[0], q.shape
        q2, k2, v2, o2, lse2 = (torch.cat([t] * S) for t in (q, k, v, o, lse))
        do2 = do.reshape(S * B, H, N, d)
        di = row_dot(o2, do2)
        dk, dv = flash_bwd_dkv(q2, k2, v2, lse2, do2, di, ctx.scale)
        dq = flash_bwd_dq(q2, k2, v2, lse2, do2, di, ctx.scale)
        return tuple(rebatch(g.reshape(S, B, H, N, d), level) for g in (dq, dk, dv)) + (None,)


def flash_attention(q, k, v, scale: float):
    """Self-attention over [B, H, N, d] q, k, v (any strides with a
    contiguous head dim): o [B, H, N, d] in q's type, differentiable."""
    return FlashAttention.apply(q, k, v, float(scale))
