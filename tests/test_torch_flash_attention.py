"""The port's flash attention (siss_tpu_torch.ops.flash_attention) against
the JAX library's flash-attention reference, and the port's wiring rules.

Two JAX sides. The whole attention is ``mha_reference_no_custom_vjp`` and its
``jax.vjp`` (``mha_reference``'s own custom backward raises for sm_scale ≠
1). The backward kernels are also held to the Pallas TPU kernels themselves,
``_flash_attention_bwd_dq`` and ``_flash_attention_bwd_dkv``, which run on
the CPU under ``pltpu.force_tpu_interpret_mode()`` (about a second a case at
N = 256), in bf16 and fp32. On the CPU the port's wrappers run the kernels'
plain versions; the CUDA kernels are held against those on the card by
chip_smoke.py. Tolerances, fp32: outputs atol 2e-6 and lse 2e-6 relative
(sums of N ≤ 256 terms of O(1) in another order), gradients atol 1e-5
(their sums run over N terms of products of O(1) values and of the softmax
weights, both orders differing). bf16 gradients against the Pallas kernels:
one bf16 ulp of |want| (2⁻⁷·|want|, the final rounding of two nearby fp32
sums) plus atol 2⁻¹² (both round P or dS to bf16 before the second product,
but from P = exp(s − m)/l there and exp(s − lse) here, so a few terms round
the other way by one ulp of their own size).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu_torch import ops
from siss_tpu_torch.ops import flash_attention as fa
from siss_tpu_torch.ops import siss
from siss_tpu_torch.models.unet2d_cond import CrossAttention

SHAPES = [(N, d) for N in (128, 256) for d in (8, 40, 80)]
B, H = 2, 3


def inputs(N, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4)]


def bnhd_view(x):
    """The [B, H, N, d] view of a contiguous [B, N, H, d] copy: the layout
    the UNet hands the kernels."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)


@pytest.mark.parametrize("N,d", SHAPES)
def test_plain_forward_matches_jax(N, d):
    q, k, v, _ = inputs(N, d)
    scale = 1.0 / math.sqrt(d)
    want, l, m = mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), sm_scale=scale,
                                             save_residuals=True)
    o, lse = fa.flash_attention_plain(*map(bnhd_view, (q, k, v)), scale)
    assert o.dtype == torch.float32 and lse.shape == (B, H, N)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)), rtol=2e-6, atol=0)


@pytest.mark.parametrize("N,d", SHAPES)
def test_plain_backward_matches_jax_vjp(N, d):
    q, k, v, do = inputs(N, d, seed=1)
    scale = 1.0 / math.sqrt(d)
    out, vjp = jax.vjp(lambda *a: mha_reference_no_custom_vjp(*a, sm_scale=scale),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(bnhd_view, (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, scale)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


# (dtype, d) of the cases held to the Pallas backward kernels, at B, H, N = 1, 2, 256.
PALLAS_CASES = [(dtype, d) for dtype in ("bfloat16", "float32") for d in (8, 40, 80)]


def pallas_case(dtype, d, seed):
    """q, k, v, dO in ``dtype`` (numpy normals, rounded), l and m from
    ``mha_reference_no_custom_vjp`` on fp32 copies, di = rowsum(O·dO) with O
    in ``dtype``: the residuals both backward versions take."""
    rng = np.random.default_rng(seed)
    ops_t = [torch.from_numpy(rng.standard_normal((1, 2, 256, d)).astype(np.float32))
             .to(getattr(torch, dtype)) for _ in range(4)]
    f32 = [t.float().numpy() for t in ops_t]
    scale = 1.0 / math.sqrt(d)
    o, l, m = mha_reference_no_custom_vjp(*map(jnp.asarray, f32[:3]), sm_scale=scale,
                                          save_residuals=True)
    di = fa.row_dot(torch.from_numpy(np.array(o)).to(ops_t[0].dtype), ops_t[3])
    jax_ops = [jnp.asarray(x, getattr(jnp, dtype)) for x in f32]
    port_ops = [bnhd_view(x).to(ops_t[0].dtype) for x in f32]
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    return jax_ops, l, m, jnp.asarray(di.numpy()), port_ops, lse, di, scale


def assert_close_to_pallas(got, want, dtype, name):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_less(np.abs(got - want), 2.0 ** -7 * np.abs(want) + 2.0 ** -12,
                                     err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype,d", PALLAS_CASES)
def test_dq_matches_the_pallas_kernel(dtype, d):
    """flash_bwd_dq (its plain version on the CPU) against the TPU kernel
    _flash_attention_dq_kernel, run in TPU interpret mode."""
    jax_ops, l, m, j_di, port_ops, lse, di, scale = pallas_case(dtype, d, seed=4)
    q, k, v, do = jax_ops
    with pltpu.force_tpu_interpret_mode():
        want, _ = jfa._flash_attention_bwd_dq(
            q, k, v, None, None, l, m, do, j_di, block_q_major=128, block_k_major=128,
            block_k=128, sm_scale=scale, causal=False, mask_value=jfa.DEFAULT_MASK_VALUE,
            debug=False)
    got = fa.flash_bwd_dq(*port_ops[:3], lse, port_ops[3], di, scale)
    assert got.dtype == port_ops[0].dtype
    assert_close_to_pallas(got, want, dtype, "dq")


@pytest.mark.parametrize("dtype,d", PALLAS_CASES)
def test_dkv_matches_the_pallas_kernel(dtype, d):
    """flash_bwd_dkv (its plain version on the CPU) against the TPU kernel
    _flash_attention_dkv_kernel, run in TPU interpret mode."""
    jax_ops, l, m, j_di, port_ops, lse, di, scale = pallas_case(dtype, d, seed=5)
    q, k, v, do = jax_ops
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_attention_bwd_dkv(
            q, k, v, None, None, l, m, do, j_di, block_q_major=128, block_q=128,
            block_k_major=128, block_k=128, sm_scale=scale, causal=False,
            mask_value=jfa.DEFAULT_MASK_VALUE, debug=False)
    got = fa.flash_bwd_dkv(*port_ops[:3], lse, port_ops[3], di, scale)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert g.dtype == port_ops[0].dtype
        assert_close_to_pallas(g, w, dtype, name)


def test_autograd_function_uses_the_explicit_backward():
    """flash_attention's gradient is the written-out backward, bit for bit,
    and equals autograd through the plain forward to fp32 rounding."""
    q, k, v, do = inputs(128, 40, seed=2)
    scale = 1.0 / math.sqrt(40)
    tq, tk, tv = (bnhd_view(x).requires_grad_(True) for x in (q, k, v))
    tdo = bnhd_view(do)
    o = fa.flash_attention(tq, tk, tv, scale)
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    o_p, lse = fa.flash_attention_plain(tq, tk, tv, scale)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, o_p, lse, tdo, scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref = torch.softmax(tq @ tk.transpose(-1, -2) * scale, dim=-1) @ tv
    for g, w in zip(got, torch.autograd.grad(ref, (tq, tk, tv), tdo)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def test_plain_bf16_casts_p_to_v_dtype():
    """bf16 operands: logits and softmax in fp32, P rounded to bf16 before
    P·V, output in bf16 (the TPU kernel's casts)."""
    q, k, v, _ = inputs(128, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, 0.25)
    s = (tq.float() @ tk.float().transpose(-1, -2)) * 0.25
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, (p @ tv.float()).to(torch.bfloat16))


def test_ops_launch_counts_cover_every_kernel():
    """ops.launch_counts reads every kernel module's counts; one reset clears all."""
    fa.launch_counts["flash_bwd_dq"] += 2
    siss.launch_counts["siss_bwd"] += 1
    assert set(ops.launch_counts) == {"siss_reduce", "siss_bwd", "flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq"}
    assert ops.launch_counts["flash_bwd_dq"] >= 2 and ops.launch_counts["siss_bwd"] >= 1
    ops.reset_launch_counts()
    assert dict(ops.launch_counts) == dict.fromkeys(ops.launch_counts, 0)
    assert fa.launch_counts["flash_bwd_dq"] == 0 and siss.launch_counts["siss_bwd"] == 0


@pytest.mark.parametrize("d,D", [(8, 8), (16, 16), (24, 40), (40, 40), (64, 64), (72, 80),
                                 (80, 80), (128, 128)])
def test_padded_head_dim(d, D):
    assert fa.padded_head_dim(d) == D


@pytest.mark.parametrize("shape,match", [((1, 2, 200, 40), "N % 128"),
                                         ((1, 2, 128, 136), "head_dim <= 128"),
                                         ((2, 128, 40), r"\[B, H, N, d\]")])
def test_kernel_operands_are_checked(shape, match):
    """What the kernels cannot take raises before any launch."""
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        fa._operands(x, x, x)


def test_kernel_operands_keep_strided_views():
    x = torch.zeros(1, 256, 2, 40).transpose(1, 2)
    assert fa._operands(x, x, x)[0] is x
    with pytest.raises(ValueError, match="share shape"):
        fa._operands(x, x.double(), x)


def _bf16_view(B, H, N, d, offset=0, width=None):
    """A [B, H, N, d] bf16 view of a [B, N, H, width] buffer, ``offset``
    elements past a 16-byte aligned base."""
    width = width or d
    flat = torch.zeros(B * N * H * width + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:offset + B * N * H * width].view(B, N, H, width)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("offset,width,d,match", [
    (1, None, 40, "16-byte aligned base address"),  # the base one element off
    (0, 12, 8, "multiples of 16 bytes"),            # head and sequence strides of 24 and 48 bytes
    (0, None, 12, r"head_dim % 8 == 0"),            # no whole 16-byte column groups
])
def test_bf16_operands_follow_the_tma_rule(offset, width, d, match):
    """The bf16 tensor-core kernels copy tiles with TMA: what breaks its
    16-byte rule raises before any launch."""
    x = _bf16_view(1, 2, 128, d, offset, width)
    with pytest.raises(ValueError, match=match):
        fa._operands(x, x, x)


def test_bf16_operands_aligned_views_pass():
    """The UNet's layout (strided [B, H, N, d] views) keeps the TMA rule at
    the SD head dims, and the view is handed on as it is."""
    for d in (8, 24, 40, 80, 128):
        x = _bf16_view(2, 3, 128, d)
        assert fa._operands(x, x, x)[0] is x


def test_fp32_operands_skip_the_tma_rule():
    """fp32 skips the TMA rule: the 3xTF32 kernels copy their tiles with
    4-byte cp.async where a view is not 16-byte aligned, and the dQ reads
    its Q and dO rows element by element. An unaligned fp32 view is
    taken."""
    flat = torch.zeros(1 * 128 * 2 * 40 + 1)
    x = flat[1:].view(1, 128, 2, 40).transpose(1, 2)
    assert fa._operands(x, x, x)[0] is x


def test_lse_rows_must_be_aligned():
    rows = torch.zeros(2 * 128 + 1)
    fa._f32_rows(rows[:256].view(1, 2, 128), (1, 2, 128), "lse")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._f32_rows(rows[1:].view(1, 2, 128), (1, 2, 128), "lse")


def test_kernel_impl_dispatches_by_dtype():
    """bf16 forward, dK/dV and dQ run on the tensor cores; the fp32 forward,
    dK/dV and dQ run on them too, in three TF32 products per product (plain
    TF32 would break their parity)."""
    assert fa.kernel_impl("flash_fwd", torch.bfloat16) == "wgmma"
    assert fa.kernel_impl("flash_bwd_dkv", torch.bfloat16) == "wgmma"
    assert fa.kernel_impl("flash_bwd_dq", torch.bfloat16) == "wgmma"
    assert {fa.kernel_impl(k, torch.float32) for k in ("flash_fwd", "flash_bwd_dkv")} == {"tf32x3"}
    assert fa.kernel_impl("flash_bwd_dq", torch.float32) == "tf32x3"


def test_flash_wiring_rules():
    """The port of tests/test_flash_attention.py::test_flash_wiring_rules:
    flash only on self-attention with 128-divisible N and head_dim ≤ 128;
    auto never picks flash off a TPU, which the port always is."""
    att = CrossAttention(320, 8, 40, impl="flash")
    assert att._use_flash(is_self=True, n_q=4096)
    assert att._use_flash(is_self=True, n_q=128)
    assert not att._use_flash(is_self=False, n_q=4096)
    assert not att._use_flash(is_self=True, n_q=77)
    assert not CrossAttention(2048, 8, 160, impl="flash")._use_flash(True, 4096)
    assert not CrossAttention(320, 8, 40, impl="einsum")._use_flash(True, 4096)
    assert not CrossAttention(320, 8, 40, impl="einsum_remat")._use_flash(True, 4096)
    assert not CrossAttention(320, 8, 40, impl="auto")._use_flash(True, 4096)
    assert not CrossAttention(640, 8, 80, impl="auto")._use_flash(True, 4096)
    assert not CrossAttention(1024, 8, 128, impl="auto")._use_flash(True, 4096)
    with pytest.raises(ValueError, match="Unknown attention impl"):
        CrossAttention(320, 8, 40, impl="typo")._use_flash(True, 4096)
