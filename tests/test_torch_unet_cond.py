"""The port's conditional UNet (siss_tpu_torch.models.unet2d_cond) against
the flax UNet2DCondition.

The tiny config runs at sample_size 16, so its level-0 self-attention has
256 tokens and the port's ``flash`` impl takes the flash path (the kernels'
plain versions, on the CPU). JAX's own ``flash`` runs only on a TPU, so JAX
runs ``einsum``. Tolerances, fp32: ε atol 2e-5 (outputs of O(1) through
~20 layers whose sums run in other orders); gradients of the scalar loss
Σε² rtol 1e-4 with atol 1e-4·max|g| per tensor (the same sums, once more
through the backward). Checkpointing recomputes the same ops on the same
inputs, so on vs off is held bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from torch_parity import CELEB_LIKE, TINY_UNET
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxConfig
from siss_tpu.utils.export import export_diffusers_state_dict
from siss_tpu_torch.models import (UNet2D, UNet2DCondition, UNet2DConditionConfig, UNet2DConfig,
                                   build_unet, build_unet_cond)
from siss_tpu_torch.models.unet2d import init_weights
from siss_tpu_torch.ops import flash_attention as fa
from siss_tpu_torch.utils.convert import params_from_flax, torch_key

TINY16 = dict(UNet2DConditionConfig.tiny().__dict__, sample_size=16)
CTX_LEN = 7


def flax_cond_unet(seed=0, **kw):
    model = FlaxUNet(FlaxConfig(**dict(TINY16, attention_impl="einsum", **kw)))
    init = jax.jit(functools.partial(model.init_params, batch_size=2, context_len=CTX_LEN))
    return model, init(jax.random.PRNGKey(seed))


def port_cond_unet(params, **kw):
    model = UNet2DCondition(UNet2DConditionConfig(**dict(TINY16, **kw)))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def model_inputs(seed=0, n=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 999, 500, 17][:n], np.int32)
    ctx = rng.normal(size=(n, CTX_LEN, 32)).astype(np.float32)
    return x, t, ctx


def port_eps(model, x, t, ctx):
    return model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
                 torch.from_numpy(ctx)).permute(0, 2, 3, 1)


def test_weight_carry_matches_exporter():
    _, params = flax_cond_unet()
    ours = params_from_flax(jax.tree.map(np.asarray, params))
    theirs = export_diffusers_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    assert any(".transformer_blocks.0.ff.net.0.proj." in k for k in ours)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = UNet2DCondition(UNet2DConditionConfig(**TINY16))
    model.load_state_dict(ours, strict=True)  # raises on a missing or extra key


def test_sd_v1_layout_matches_flax():
    """The full-width sd_v1 config builds the flax model's parameter set
    (names and shapes), 859,520,964 parameters, with neither side
    materialised: flax through jax.eval_shape, the port on the meta device."""
    fmodel = FlaxUNet(FlaxConfig.sd_v1())
    shapes = jax.eval_shape(lambda: fmodel.init_params(jax.random.PRNGKey(0), batch_size=1))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", getattr(p, "name", None))) for p in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        want[torch_key(names)] = shape
    with torch.device("meta"):
        ours = UNet2DCondition(UNet2DConditionConfig.sd_v1())
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == want
    assert sum(p.numel() for p in ours.parameters()) == 859_520_964


@pytest.mark.parametrize("impl", ["flash", "einsum", "einsum_remat"])
def test_eps_parity(impl):
    fmodel, params = flax_cond_unet(seed=1)
    model = port_cond_unet(params, attention_impl=impl)
    x, t, ctx = model_inputs()
    want = np.asarray(fmodel.apply({"params": params}, *map(jnp.asarray, (x, t, ctx))))
    fa.reset_launch_counts()
    with torch.no_grad():
        got = port_eps(model, x, t, ctx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert fa.launch_counts["flash_fwd"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_gradient_parity(impl):
    fmodel, params = flax_cond_unet(seed=2)
    model = port_cond_unet(params, attention_impl=impl)
    x, t, ctx = model_inputs(seed=3)

    def loss(p):
        return jnp.sum(fmodel.apply({"params": p}, *map(jnp.asarray, (x, t, ctx))) ** 2)

    want = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    (port_eps(model, x, t, ctx) ** 2).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = 1e-4 * float(w.abs().max()) + 1e-7
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("knobs", [dict(remat_attention=False), dict(remat_attention=True),
                                   dict(remat_attention=True, ff_impl="remat")])
def test_checkpointing_matches_saved(knobs):
    """gradient_checkpointing (and ff remat) changes what is saved, not the
    math: g_x and g_a of one forward with two pulls, as the SISS step takes
    them, are bit for bit those of the model without checkpointing."""
    _, params = flax_cond_unet(seed=4)
    x, t, ctx = model_inputs(seed=5)
    grads = {}
    for tag, kw in (("saved", {}), ("remat", dict(gradient_checkpointing=True, **knobs))):
        model = port_cond_unet(params, attention_impl="flash", **kw)
        eps = port_eps(model, x, t, ctx)
        ps = list(model.parameters())
        g_x = torch.autograd.grad((eps[0] ** 2).sum(), ps, retain_graph=True)
        g_a = torch.autograd.grad((eps[1] ** 2).sum(), ps)
        grads[tag] = g_x + g_a
    for a, b in zip(grads["saved"], grads["remat"]):
        assert torch.equal(a, b)


def test_bf16_autocast_output_is_fp32():
    _, params = flax_cond_unet()
    model = UNet2DCondition(UNet2DConditionConfig(**dict(TINY16, attention_impl="flash")),
                            dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    x, t, ctx = model_inputs()
    with torch.no_grad():
        out = port_eps(model, x, t, ctx)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("kw,exc,match", [
    (dict(gradient_checkpointing=True, remat_policy="dots"), None, None),
    (dict(gradient_checkpointing=True, remat_policy="dots_no_batch"), None, None),
    (dict(gradient_checkpointing=True, remat_policy="typo"), ValueError, "unknown remat_policy"),
    (dict(ff_impl="typo"), ValueError, "Unknown ff impl"),
])
def test_unported_and_unknown_knobs_raise(kw, exc, match):
    """Unknown knobs raise; the remat policies, which raised until they were
    ported, build (tests/test_torch_sd_options.py checks them)."""
    cfg = dataclasses.replace(UNet2DConditionConfig.tiny(), **kw)
    if exc is None:
        assert UNet2DCondition(cfg).config.remat_policy == kw["remat_policy"]
        return
    with pytest.raises(exc, match=match):
        UNet2DCondition(cfg)


@pytest.mark.parametrize("kind", ["cond", "multi", "single"])
def test_builders_draw_the_weights_init_weights_draws(kind):
    """``build_unet_cond`` and ``build_unet`` build the module on the meta
    device, skipping torch's default initialisation: every parameter must
    still be ``init_weights``' own, bit for bit, as when the module is built
    on the host first."""
    if kind == "cond":
        cfg = UNet2DConditionConfig(**TINY16)
        built, cls = build_unet_cond(cfg, seed=3, device="cpu"), UNet2DCondition
    else:
        cfg = UNet2DConfig(**(TINY_UNET if kind == "multi" else CELEB_LIKE))
        built, cls = build_unet(cfg, seed=3, device="cpu"), UNet2D
    want = init_weights(cls(cfg), torch.Generator().manual_seed(3)).state_dict()
    got = built.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
