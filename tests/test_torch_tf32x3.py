"""The fp32 flash-attention kernels' 3xTF32 arithmetic, without a card.

The CUDA kernels (``csrc/flash_fwd_tf32x3.cu``, ``csrc/flash_bwd_dkv_tf32x3.cu``,
``csrc/flash_bwd_dq_tf32x3.cu``) split every fp32 operand x into TF32 parts
hi = rna(x), lo = rna(x − hi) and form each product as lo·hi + hi·lo + hi·hi
on the tensor cores. ``split_tf32`` forms hi and lo bit for bit as the
kernels do (``cvt.rna.tf32.f32``'s rounding), and
``flash_attention_tf32x3_emulated``, ``flash_bwd_dkv_tf32x3_emulated`` and
``flash_bwd_dq_tf32x3_emulated`` repeat the kernels' arithmetic in plain
PyTorch. These tests hold the split to its rounding rule, the product to its
derived error bound, and each emulated kernel to ``chip_smoke.py``'s fp32
bound against a float64 reference and to the JAX library's Pallas kernel
(TPU interpret mode). On the card, ``chip_smoke.py`` holds the kernels
themselves to the same bound.

The per-product bound. With u = 2⁻¹¹, the unit roundoff of TF32's 11
significant bits: hi = a − δa with |δa| ≤ u|a|, lo = δa − ε with
|ε| ≤ u|δa| ≤ u²|a|. Then a·b − (lo_a·hi_b + hi_a·lo_b + hi_a·hi_b)
= hi_a·ε_b + hi_b·ε_a + δa·δb, at most (3 + 2u)·u²·|a·b| = (3 + 2⁻¹⁰)·2⁻²²·|a·b|:
the dropped lo·lo and the roundings of the two lo parts. Each of the three
products of TF32 parts is exact in fp32 (11 × 11 bits), so over a dot
product of length d only the fp32 sum of its 3d terms adds to that, at most
(3d − 1)·2⁻²⁴ of the sum of their magnitudes, which is (1 + 2u + u²)·Σ|a·b|
at most.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

import chip_smoke
import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu_torch.ops import flash_attention as fa

U = 2.0 ** -11  # TF32's unit roundoff


def bits(x):
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


def from_bits(patterns):
    return torch.tensor(np.array(patterns, dtype=np.uint32).view(np.int32)).view(torch.float32)


def wide_range(n, seed, lo=-30, hi=30):
    """fp32 values with random signs and mantissas over 2^lo..2^hi."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1, 2, n) * 2.0 ** rng.integers(lo, hi, n) * rng.choice([-1, 1], n)
    return torch.from_numpy(x.astype(np.float32))


def test_split_parts_are_tf32_and_reconstruct_x():
    """hi and lo carry no bits below TF32's 10-bit mantissa, and hi + lo is x
    to within 2⁻²²·|x| (the rounding of lo; x − hi itself is exact)."""
    x = wide_range(100_000, seed=0)
    hi, lo = fa.split_tf32(x)
    assert not bool((bits(hi) & 0x1FFF).any()) and not bool((bits(lo) & 0x1FFF).any())
    assert bool((hi.double() - x.double()).abs().le(U * x.double().abs()).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float(err.max()) > 0  # lo is rounded: the bound is not vacuous


@pytest.mark.parametrize("x,rna", [
    (0x3F801000, 0x3F802000),   # 1 + 2⁻¹¹, a tie: away from zero (to-even would give 1.0)
    (0xBF801000, 0xBF802000),   # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F803000, 0x3F804000),   # a tie above an odd mantissa: away
    (0x3FFFF000, 0x40000000),   # the carry moves into the exponent: 2.0
    (0x00001000, 0x00002000),   # a subnormal tie rounds the same way
    (0x00000FFF, 0x00000000),   # a subnormal below half a TF32 ulp: zero
])
def test_split_rounds_to_nearest_ties_away(x, rna):
    """cvt.rna's rule on hand-picked fp32 bit patterns."""
    hi, _ = fa.split_tf32(from_bits([x]))
    assert int(bits(hi)[0]) & 0xFFFFFFFF == rna


def test_split_special_values():
    """0 and −0 split into themselves and +0; ±inf keeps hi and gets lo = NaN
    (inf − inf, as in the kernel, where such a row is NaN as in the plain
    version); a NaN keeps lo NaN, so its products stay NaN, whether its hi
    rounds to NaN (0x7FC00000) or, with the top mantissa bits set
    (0x7FFFFFFF), carries into the sign (−0); subnormals keep hi + lo within
    2⁻¹³⁷ (lo's rounding, at the fixed subnormal exponent, loses at most 2¹²
    units of 2⁻¹⁴⁹) and hi is TF32."""
    x = torch.cat([torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan]),
                   from_bits([0x7FFFFFFF])])
    hi, lo = fa.split_tf32(x)
    assert hi[0] == 0 and lo[0] == 0 and not torch.signbit(hi[0])
    assert hi[1] == 0 and torch.signbit(hi[1]) and lo[1] == 0
    assert hi[2] == math.inf and hi[3] == -math.inf and bool(lo[2:4].isnan().all())
    assert bool(hi[4].isnan()) and bool(lo[4:].isnan().all())
    assert int(bits(hi)[5]) & 0xFFFFFFFF == 0x80000000
    sub = from_bits(np.random.default_rng(1).integers(1, 0x007FFFFF, 1000, dtype=np.uint32))
    hi, lo = fa.split_tf32(sub)
    assert not bool((bits(hi) & 0x1FFF).any())
    assert bool(((hi.double() + lo.double() - sub.double()).abs() <= 2.0 ** -137).all())


def test_three_products_are_within_the_derived_bound():
    """One product a·b formed as lo·hi + hi·lo + hi·hi (exact here, in
    float64) is within (3 + 2⁻¹⁰)·2⁻²²·|a·b| of a·b, over 2⁻³⁰..2³⁰; the
    bound is met with less than a factor 2 to spare, and dropping the two
    cross terms (one TF32 product) misses it by more than 2⁸."""
    a, b = wide_range(100_000, seed=2), wide_range(100_000, seed=3)
    (ah, al), (bh, bl) = (tuple(p.double() for p in fa.split_tf32(t)) for t in (a, b))
    exact = a.double() * b.double()
    bound = (3 + 2.0 ** -10) * 2.0 ** -22 * exact.abs()
    ratio = (al * bh + ah * bl + ah * bh - exact).abs() / bound
    assert float(ratio.max()) <= 1 and float(ratio.max()) > 0.5
    assert float(((ah * bh - exact).abs() / bound).max()) > 2.0 ** 8


@pytest.mark.parametrize("d", [40, 80])
def test_dot_products_meet_the_bound_and_one_tf32_pass_does_not(d):
    """Dot products of length d over 2⁻²⁰..2²⁰, formed as the kernel forms
    them (8-deep k-steps of three fp32-accumulated products), against
    float64: within (3 + 2⁻¹⁰)·2⁻²² + (3d − 1)·2⁻²⁴·(1 + 2⁻¹⁰) of Σ|a·b|.
    One TF32 product per term on the same data breaks chip_smoke.flash_bound's
    fp32 budget, (2 + 32·log2 N)·2⁻²⁴ of Σ|a·b|, even at N = 4096, its most
    generous SD shape: the reason for three passes."""
    rows = 2000
    a = wide_range(rows * d, seed=d, lo=-20, hi=20).reshape(rows, d)
    b = wide_range(rows * d, seed=d + 1, lo=-20, hi=20).reshape(rows, d)
    got = fa._mm3_steps(torch.zeros(rows, 1, 1), a[:, None, :], b[:, :, None]).reshape(rows)
    terms = a.double() * b.double()
    exact, mag = terms.sum(1), terms.abs().sum(1)
    bound = ((3 + 2.0 ** -10) * 2.0 ** -22 + (3 * d - 1) * 2.0 ** -24 * (1 + 2.0 ** -10)) * mag
    assert bool(((got.double() - exact).abs() <= bound).all())
    ah, bh = fa.split_tf32(a)[0].double(), fa.split_tf32(b)[0].double()
    one_pass = (ah * bh).sum(1)
    budget = (2 + 32 * math.log2(4096)) * 2.0 ** -24 * mag
    assert float(((one_pass - exact).abs() / budget).max()) > 1


def float64_reference(q, k, v, scale):
    """flash_attention_plain's formula in float64: (o, lse)."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, -1), v.double()), torch.logsumexp(s, -1)


def attention_inputs(d, seed=0, N=256):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, N, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_forward_within_flash_bound_of_float64(d):
    """The kernel's arithmetic at (1, 2, 256, d), 64-key tiles and the online
    softmax, is within chip_smoke.flash_bound (fp32) of the float64
    reference in o and lse: the bound the card holds the kernel to. The same
    forward with one TF32 pass per product (hi·hi only) breaks it."""
    q, k, v = map(torch.from_numpy, attention_inputs(d))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_tf32x3_emulated(q, k, v, scale)
    o64, lse64 = float64_reference(q, k, v, scale)
    terms = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * scale, -1) @ v.double().abs()
    bound_o = chip_smoke.flash_bound(torch, o64, terms, torch.float32, 256)
    bound_lse = chip_smoke.flash_bound(torch, lse64, lse64.abs(), torch.float32, 256)
    assert o.dtype == lse.dtype == torch.float32 and o.shape == q.shape and lse.shape == (1, 2, 256)
    assert bool(((o.double() - o64).abs() <= bound_o).all())
    assert bool(((lse.double() - lse64).abs() <= bound_lse).all())

    qh, kh, vh = (fa.split_tf32(t)[0] for t in (q, k, v))
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, -1)
    one_pass = fa.split_tf32(p)[0] @ vh
    assert not bool(((one_pass.double() - o64).abs() <= bound_o).all())


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_forward_matches_the_pallas_kernel(d):
    """The kernel's arithmetic against the JAX library's Pallas forward
    kernel _flash_attention_kernel (through _flash_attention_impl, in TPU
    interpret mode, 128-row blocks): both fp32 with sums in other orders,
    so outputs atol 2e-6 and lse 2e-6 relative, as
    tests/test_torch_flash_attention.py holds the plain forward."""
    q, k, v = attention_inputs(d, seed=1)
    scale = 1.0 / math.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want, l, m = jfa._flash_attention_impl(
            *map(jnp.asarray, (q, k, v)), None, None, True, False, scale, 1, 128, 128, 128, False)
    o, lse = fa.flash_attention_tf32x3_emulated(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)), rtol=2e-6, atol=0)


def test_emulated_forward_pads_the_head_dim_and_tiles_keys():
    """d = 24 (the kernels pad it to 40 with zeros) and 128 keys in two
    tiles: the same o and lse as one 128-key tile to fp32 rounding, and
    within flash_bound of float64."""
    q, k, v = map(torch.from_numpy, attention_inputs(24, seed=2, N=128))
    scale = 1.0 / math.sqrt(24)
    o, lse = fa.flash_attention_tf32x3_emulated(q, k, v, scale)
    o1, lse1 = fa.flash_attention_tf32x3_emulated(q, k, v, scale, keys_per_tile=128)
    torch.testing.assert_close(o, o1, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, lse1, rtol=2e-6, atol=0)
    o64, lse64 = float64_reference(q, k, v, scale)
    terms = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * scale, -1) @ v.double().abs()
    assert bool(((o.double() - o64).abs()
                 <= chip_smoke.flash_bound(torch, o64, terms, torch.float32, 128)).all())


# --- the fp32 dK/dV kernel's arithmetic (csrc/flash_bwd_dkv_tf32x3.cu) ---

def dkv_inputs(d, seed, N=256):
    """q, k, v, dO (numpy normals, [1, 2, N, d]), lse from the plain forward,
    di = rowsum(O·dO), and the scale: what the dK/dV kernel takes."""
    q, k, v, do = (torch.from_numpy(x) for x in attention_inputs(d, seed, N)
                   + [np.random.default_rng(seed + 100).standard_normal((1, 2, N, d))
                      .astype(np.float32)])
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_plain(q, k, v, scale)
    return q, k, v, do, lse, fa.row_dot(o, do), scale


def float64_dkv(q, k, v, do, lse, di, scale):
    """flash_bwd_dkv_plain's formula in float64 (lse and di cast up): dk,
    dv and the sums of their terms' magnitudes, Σ|dS|·|q| and Σ P·|dO|."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse.double()[..., None])
    ds = ((do @ v.transpose(-1, -2)) - di.double()[..., None]) * p * scale
    return (ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do,
            ds.abs().transpose(-1, -2) @ q.abs(), p.transpose(-1, -2) @ do.abs())


def within_flash_bound(got, want, terms, N):
    return bool(((got.double() - want).abs()
                 <= chip_smoke.flash_bound(torch, want, terms, torch.float32, N)).all())


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_dkv_within_flash_bound_of_float64(d):
    """The dK/dV kernel's arithmetic at (1, 2, 256, d), key-major with every
    8-deep step added in fp32 (and two query groups at d = 80), is within
    chip_smoke.flash_bound (fp32) of the float64 reference in dk and dv:
    the bound the card holds the kernel to. The same products with one TF32
    pass each (hi·hi only) break it."""
    q, k, v, do, lse, di, scale = dkv_inputs(d, seed=3)
    dk, dv = fa.flash_bwd_dkv_tf32x3_emulated(q, k, v, lse, do, di, scale)
    dk64, dv64, terms_dk, terms_dv = float64_dkv(q, k, v, do, lse, di, scale)
    assert dk.dtype == dv.dtype == torch.float32 and dk.shape == dv.shape == q.shape
    assert within_flash_bound(dk, dk64, terms_dk, 256) and within_flash_bound(dv, dv64, terms_dv, 256)

    qh, kh, vh, doh = (fa.split_tf32(t)[0] for t in (q, k, v, do))
    p = torch.exp((kh @ qh.transpose(-1, -2)) * scale - lse[..., None, :])
    ds = ((vh @ doh.transpose(-1, -2)) - di[..., None, :]) * p * scale
    one_pass = (fa.split_tf32(ds)[0] @ qh, fa.split_tf32(p)[0] @ doh)
    assert not (within_flash_bound(one_pass[0], dk64, terms_dk, 256)
                and within_flash_bound(one_pass[1], dv64, terms_dv, 256))


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_dkv_matches_the_pallas_kernel(d):
    """The dK/dV kernel's arithmetic against the JAX library's Pallas kernel
    _flash_attention_dkv_kernel (through _flash_attention_bwd_dkv, in TPU
    interpret mode, 128-row blocks) at fp32: gradients atol 1e-5, as
    tests/test_torch_flash_attention.py holds the plain dK/dV."""
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((1, 2, 256, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, l, m = jfa.mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), sm_scale=scale,
                                              save_residuals=True)
    di = fa.row_dot(torch.from_numpy(np.array(o)), torch.from_numpy(do))
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_attention_bwd_dkv(
            *map(jnp.asarray, (q, k, v)), None, None, l, m, jnp.asarray(do), jnp.asarray(di.numpy()),
            block_q_major=128, block_q=128, block_k_major=128, block_k=128, sm_scale=scale,
            causal=False, mask_value=jfa.DEFAULT_MASK_VALUE, debug=False)
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    got = fa.flash_bwd_dkv_tf32x3_emulated(*map(torch.from_numpy, (q, k, v)), lse,
                                           torch.from_numpy(do), di, scale)
    for name, g, w in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("d,N", [(24, 128), (80, 128), (80, 384)])
def test_emulated_dkv_pads_the_head_dim_and_splits_the_queries(d, N, monkeypatch):
    """As the kernel runs it: d = 24 padded to the built head dim 40 with
    zero columns gives the same bits (the zero products add exact zeros);
    at d = 80 two query groups, each over its half of the N queries (64
    and 192 queries each at N = 128 and 384), added at the end, give
    one group's dk and dv to fp32 rounding. Each within flash_bound of
    float64."""
    q, k, v, do, lse, di, scale = dkv_inputs(d, seed=4, N=N)
    dk, dv = fa.flash_bwd_dkv_tf32x3_emulated(q, k, v, lse, do, di, scale)
    dk64, dv64, terms_dk, terms_dv = float64_dkv(q, k, v, do, lse, di, scale)
    assert within_flash_bound(dk, dk64, terms_dk, N) and within_flash_bound(dv, dv64, terms_dv, N)
    if d == 24:
        q40, k40, v40, do40 = (torch.nn.functional.pad(t, (0, 40 - d)) for t in (q, k, v, do))
        dk40, dv40 = fa.flash_bwd_dkv_tf32x3_emulated(q40, k40, v40, lse, do40, di, scale)
        assert torch.equal(dk40[..., :d], dk) and torch.equal(dv40[..., :d], dv)
        assert not bool(dk40[..., d:].any()) and not bool(dv40[..., d:].any())
    else:
        assert fa._tf32x3_groups(d) == 2
        monkeypatch.setattr(fa, "_tf32x3_groups", lambda d: 1)
        dk1, dv1 = fa.flash_bwd_dkv_tf32x3_emulated(q, k, v, lse, do, di, scale)
        assert not torch.equal(dk1, dk)  # the groups' sums do take another order
        torch.testing.assert_close(dk, dk1, atol=2e-6, rtol=0)
        torch.testing.assert_close(dv, dv1, atol=2e-6, rtol=0)


def test_split_of_a_signed_ds_reconstructs_it():
    """dS = (dP − di)·P·scale is signed and unbounded, unlike P ∈ [0, 1]: its
    split (hi by the bits, lo by cvt.rna's rule, as the kernel's acc_frag
    forms them) keeps the sign in hi, carries no bits below TF32's mantissa,
    and reconstructs dS within 2⁻²²·|dS| for both signs."""
    q, k, v, do, lse, di, scale = dkv_inputs(40, seed=6, N=128)
    p = torch.exp((k @ q.transpose(-1, -2)) * scale - lse[..., None, :])
    ds = ((v @ do.transpose(-1, -2)) - di[..., None, :]) * p * scale
    ds = ds[ds != 0]
    assert bool((ds < 0).any()) and bool((ds > 0).any())
    assert float(ds.abs().max() / ds.abs().min()) > 2.0 ** 20  # many binades
    hi, lo = fa.split_tf32(ds)
    assert not bool((bits(hi) & 0x1FFF).any()) and not bool((bits(lo) & 0x1FFF).any())
    assert bool((torch.signbit(hi) == torch.signbit(ds)).all())
    err = (hi.double() + lo.double() - ds.double()).abs()
    for sign in (ds < 0, ds > 0):
        assert bool((err[sign] <= 2.0 ** -22 * ds[sign].double().abs()).all())
    assert float(err.max()) > 0


# --- the fp32 dQ kernel's arithmetic (csrc/flash_bwd_dq_tf32x3.cu) ---

def float64_dq(q, k, v, do, lse, di, scale):
    """flash_bwd_dq_plain's formula in float64 (lse and di cast up): dq and
    the sums of its terms' magnitudes, Σ|dS|·|k|."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse.double()[..., None])
    ds = ((do @ v.transpose(-1, -2)) - di.double()[..., None]) * p * scale
    return ds @ k, ds.abs() @ k.abs()


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_dq_within_flash_bound_of_float64(d):
    """The dQ kernel's arithmetic at (1, 2, 256, d), query-major with every
    8-deep step added in fp32 (and two key groups at d = 80), is within
    chip_smoke.flash_bound (fp32) of the float64 reference: the bound the
    card holds the kernel to. The same products with one TF32 pass each
    (hi·hi only) break it."""
    q, k, v, do, lse, di, scale = dkv_inputs(d, seed=7)
    dq = fa.flash_bwd_dq_tf32x3_emulated(q, k, v, lse, do, di, scale)
    dq64, terms = float64_dq(q, k, v, do, lse, di, scale)
    assert dq.dtype == torch.float32 and dq.shape == q.shape
    assert within_flash_bound(dq, dq64, terms, 256)

    qh, kh, vh, doh = (fa.split_tf32(t)[0] for t in (q, k, v, do))
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse[..., None])
    ds = ((doh @ vh.transpose(-1, -2)) - di[..., None]) * p * scale
    assert not within_flash_bound(fa.split_tf32(ds)[0] @ kh, dq64, terms, 256)


@pytest.mark.parametrize("d", [40, 80])
def test_emulated_dq_matches_the_pallas_kernel(d):
    """The dQ kernel's arithmetic against the JAX library's Pallas kernel
    _flash_attention_dq_kernel (through _flash_attention_bwd_dq, in TPU
    interpret mode, 128-row blocks) at fp32: dq atol 1e-5, as
    tests/test_torch_flash_attention.py holds the plain dQ."""
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal((1, 2, 256, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, l, m = jfa.mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), sm_scale=scale,
                                              save_residuals=True)
    di = fa.row_dot(torch.from_numpy(np.array(o)), torch.from_numpy(do))
    with pltpu.force_tpu_interpret_mode():
        want, _ = jfa._flash_attention_bwd_dq(
            *map(jnp.asarray, (q, k, v)), None, None, l, m, jnp.asarray(do),
            jnp.asarray(di.numpy()), block_q_major=128, block_k_major=128, block_k=128,
            sm_scale=scale, causal=False, mask_value=jfa.DEFAULT_MASK_VALUE, debug=False)
    lse = torch.from_numpy(np.array(m + jnp.log(l)))
    got = fa.flash_bwd_dq_tf32x3_emulated(*map(torch.from_numpy, (q, k, v)), lse,
                                          torch.from_numpy(do), di, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,N", [(24, 128), (80, 128), (80, 384)])
def test_emulated_dq_pads_the_head_dim_and_splits_the_keys(d, N, monkeypatch):
    """As the kernel runs it: d = 24 padded to the built head dim 40 with
    zero columns gives the same bits (the zero products add exact zeros);
    at d = 80 two key groups, each over its half of the N keys (64 and 192
    keys each at N = 128 and 384), added at the end, give one group's dq to
    fp32 rounding. Each within flash_bound of float64."""
    q, k, v, do, lse, di, scale = dkv_inputs(d, seed=9, N=N)
    dq = fa.flash_bwd_dq_tf32x3_emulated(q, k, v, lse, do, di, scale)
    dq64, terms = float64_dq(q, k, v, do, lse, di, scale)
    assert within_flash_bound(dq, dq64, terms, N)
    if d == 24:
        q40, k40, v40, do40 = (torch.nn.functional.pad(t, (0, 40 - d)) for t in (q, k, v, do))
        dq40 = fa.flash_bwd_dq_tf32x3_emulated(q40, k40, v40, lse, do40, di, scale)
        assert torch.equal(dq40[..., :d], dq) and not bool(dq40[..., d:].any())
    else:
        assert fa._tf32x3_groups(d) == 2
        monkeypatch.setattr(fa, "_tf32x3_groups", lambda d: 1)
        dq1 = fa.flash_bwd_dq_tf32x3_emulated(q, k, v, lse, do, di, scale)
        assert not torch.equal(dq1, dq)  # the groups' sums do take another order
        torch.testing.assert_close(dq, dq1, atol=2e-6, rtol=0)
