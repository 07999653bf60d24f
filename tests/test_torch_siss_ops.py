"""The port's SISS epilogue (siss_tpu_torch.ops.siss) against the JAX
package's Pallas epilogue (interpret mode on the CPU) and its jnp reference.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py. Tolerances follow tests/test_pallas_ops.py: per-sample sums
at rtol 1e-5, importance weights 1e-3, bf16 inputs 1e-2, gradients rtol 1e-3
/ atol 1e-6. iw = exp(−logaddexp(…, d)) with d = (dist_x − dist_a)/2σ², a
difference of two fp32 sums of hundreds to thousands, so d moves by 1e-5 to
1e-4 with the summation order and a small iw moves by that much relative:
that is why iw is held at 1e-3. The weighted sums Σ iw·l inherit iw's
relative error, so against JAX they are held at 1e-3 too, and within the
port to Σ iw·l of its own iw and l at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.ops import siss_pallas
from siss_tpu.ops import siss_weighted_sums as jax_fused
from siss_tpu.ops import siss_weighted_sums_reference as jax_reference
from siss_tpu_torch.ops import siss as port

PORT_FNS = {"fused": port.siss_weighted_sums, "reference": port.siss_weighted_sums_reference}
JAX_FNS = {"pallas": jax_fused, "reference": jax_reference}


def make_inputs(shape, seed=0, lo=0.1, hi=0.9):
    """Four [B, ...] tensors and gamma ~ U(lo, hi), sigma = sqrt(1 - gamma²)."""
    rng = np.random.default_rng(seed)
    tensors = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    gamma = rng.uniform(lo, hi, shape[0]).astype(np.float32)
    sigma = np.sqrt(1 - gamma**2).astype(np.float32)
    return tensors, gamma, sigma


def run_jax(fn, tensors, gamma, sigma, dtype=jnp.float32):
    return fn(*(jnp.asarray(t, dtype) for t in tensors), jnp.asarray(gamma), jnp.asarray(sigma), 0.5)


def run_port(fn, tensors, gamma, sigma, dtype=torch.float32):
    return fn(*(torch.from_numpy(t).to(dtype) for t in tensors), torch.from_numpy(gamma),
              torch.from_numpy(sigma), 0.5)


@pytest.mark.parametrize("jax_name", sorted(JAX_FNS))
@pytest.mark.parametrize("port_name", sorted(PORT_FNS))
@pytest.mark.parametrize("case", [((4, 10, 10, 3), 0, 0.1, 0.9), ((3, 28, 28, 1), 1, 0.3, 0.7)],
                         ids=["10x10x3", "28x28x1"])
def test_forward_parity(port_name, jax_name, case):
    """The inputs of tests/test_pallas_ops.py: 10×10×3, and the MNIST-sized
    28×28×1 (784 px, not a multiple of the TPU tile) with gamma in [0.3, 0.7]."""
    tensors, gamma, sigma = make_inputs(*case)
    wlx_j, wla_j, aux_j = run_jax(JAX_FNS[jax_name], tensors, gamma, sigma)
    wlx_t, wla_t, aux_t = run_port(PORT_FNS[port_name], tensors, gamma, sigma)
    np.testing.assert_allclose(float(wlx_t), float(wlx_j), rtol=1e-3)
    np.testing.assert_allclose(float(wla_t), float(wla_j), rtol=1e-3)
    pixels = float(np.prod(case[0][1:]))
    for w, iw, l in ((wlx_t, "iw_x", "lx_mean"), (wla_t, "iw_a", "la_mean")):
        own = float((aux_t[iw].double() * aux_t[l].double() * pixels).sum())
        np.testing.assert_allclose(float(w), own, rtol=1e-6)
    for k in ("iw_x", "iw_a"):
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(aux_j[k]), rtol=1e-3)
    for k in ("lx_mean", "la_mean"):
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(aux_j[k]), rtol=1e-5)


@pytest.mark.parametrize("which", [0, 1], ids=["pull_x", "pull_a"])
@pytest.mark.parametrize("port_name", sorted(PORT_FNS))
@pytest.mark.parametrize("shape", [(4, 10, 10, 3), (3, 28, 28, 1)], ids=["10x10x3", "28x28x1"])
def test_gradient_each_pull(port_name, which, shape):
    """One pull differentiates one output; autograd hands the Function a
    None cotangent for the other, which must count as 0."""
    tensors, gamma, sigma = make_inputs(shape)
    rest = [jnp.asarray(t) for t in tensors[1:]]
    g_j = jax.grad(lambda p: jax_fused(p, *rest, jnp.asarray(gamma), jnp.asarray(sigma), 0.5)[which])(
        jnp.asarray(tensors[0]))
    preds = torch.from_numpy(tensors[0]).requires_grad_(True)
    outs = PORT_FNS[port_name](preds, *(torch.from_numpy(t) for t in tensors[1:]),
                               torch.from_numpy(gamma), torch.from_numpy(sigma), 0.5)
    (g_t,) = torch.autograd.grad(outs[which], preds)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-6)


def test_two_pulls_from_one_forward():
    """The train step's pattern: both pulls from one forward (retain_graph),
    each equal to the reference's separate gradient."""
    tensors, gamma, sigma = make_inputs((4, 10, 10, 3), seed=2)
    preds = torch.from_numpy(tensors[0]).requires_grad_(True)
    rest = [torch.from_numpy(t) for t in tensors[1:]]
    g, s = torch.from_numpy(gamma), torch.from_numpy(sigma)
    wlx, wla, _ = port.siss_weighted_sums(preds, *rest, g, s, 0.5)
    (gx,) = torch.autograd.grad(wlx, preds, retain_graph=True)
    (ga,) = torch.autograd.grad(wla, preds)
    for out_idx, got in ((0, gx), (1, ga)):
        ref = port.siss_weighted_sums_reference(preds, *rest, g, s, 0.5)[out_idx]
        (want,) = torch.autograd.grad(ref, preds)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-6)


def test_bf16_inputs():
    tensors, gamma, sigma = make_inputs((4, 10, 10, 3))
    wlx_j, wla_j, _ = run_jax(jax_fused, tensors, gamma, sigma, jnp.bfloat16)
    wlx_t, wla_t, _ = run_port(port.siss_weighted_sums, tensors, gamma, sigma, torch.bfloat16)
    np.testing.assert_allclose(float(wlx_t), float(wlx_j), rtol=1e-2)
    np.testing.assert_allclose(float(wla_t), float(wla_j), rtol=1e-2)
    preds = torch.from_numpy(tensors[0]).to(torch.bfloat16).requires_grad_(True)
    wlx, _, _ = port.siss_weighted_sums(
        preds, *(torch.from_numpy(t).to(torch.bfloat16) for t in tensors[1:]),
        torch.from_numpy(gamma), torch.from_numpy(sigma), 0.5)
    (g,) = torch.autograd.grad(wlx, preds)
    assert g.dtype == torch.bfloat16  # the gradient comes back in preds' dtype


def _padded(tensors, B):
    return [jnp.pad(jnp.asarray(t.reshape(B, -1)), ((0, 0), (0, (-t[0].size) % siss_pallas._TILE)))
            for t in tensors]


def test_reduce_plain_matches_pallas_reduce():
    """The reduce kernel's plain version against the Pallas kernel itself."""
    tensors, gamma, sigma = make_inputs((3, 28, 28, 1), seed=4)
    want = siss_pallas._siss_reduce(*_padded(tensors, 3), jnp.asarray(gamma), jnp.asarray(sigma))
    got = port.siss_reduce(*(torch.from_numpy(t.reshape(3, -1)) for t in tensors),
                           torch.from_numpy(gamma), 1.0 / torch.from_numpy(sigma))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_grad_plain_matches_pallas_bwd():
    """The backward kernel's plain version against the Pallas kernel itself."""
    tensors, gamma, sigma = make_inputs((3, 28, 28, 1), seed=5)
    rng = np.random.default_rng(6)
    cx, ca = (rng.uniform(0.0, 2.0, 3).astype(np.float32) for _ in range(2))
    want = siss_pallas._siss_grad_preds(*_padded(tensors, 3), jnp.asarray(gamma), jnp.asarray(sigma),
                                        jnp.asarray(cx), jnp.asarray(ca))[:, :784]
    got = port.siss_grad_preds(*(torch.from_numpy(t.reshape(3, -1)) for t in tensors),
                               torch.from_numpy(gamma), 1.0 / torch.from_numpy(sigma),
                               torch.from_numpy(cx), torch.from_numpy(ca))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    """On the CPU the wrappers take the plain versions: no launch is counted."""
    port.reset_launch_counts()
    tensors, gamma, sigma = make_inputs((2, 4, 4, 3))
    preds = torch.from_numpy(tensors[0]).requires_grad_(True)
    wlx, _, _ = port.siss_weighted_sums(preds, *(torch.from_numpy(t) for t in tensors[1:]),
                                        torch.from_numpy(gamma), torch.from_numpy(sigma), 0.5)
    torch.autograd.grad(wlx, preds)
    assert port.launch_counts == {"siss_reduce": 0, "siss_bwd": 0}
