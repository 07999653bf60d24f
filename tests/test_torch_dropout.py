"""UNet dropout in the port (``UNet2DConfig.dropout`` > 0) against the JAX
package.

In the flax UNet dropout sits in each resnet between ``norm2``'s SiLU and
``conv2`` and acts only with ``deterministic=False``, which no caller in the
JAX package passes: its train steps, samplers, evaluator and server all run
the default, so a config with dropout 0.1 trains exactly as with 0. The
port must do the same: its forward drops nothing by default, whatever
``module.training`` says, and its train step with dropout equals JAX's and
its own step without dropout. JAX's own mask comes from flax's folding of
the ``dropout`` rng and cannot be handed in without editing the JAX
package, so the port's active dropout is held to the hand-computed
``mask·h/(1−p)`` with an injected mask, and its drawn masks to the rate.

Tolerances: ε against JAX at rtol 1e-5 plus atol 1e-5 for outputs near
zero (the mnist-like UNet's fp32 sums run in other orders); the train step
at test_torch_pretrain_step.py's SGD tolerances; the port against itself
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

import torch_parity
from test_torch_pretrain_step import assert_metrics_match, assert_params_match, jax_draws
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_pretrain_step as jax_build_pretrain_step
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.models.layers import ResnetBlock2D
from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from siss_tpu_torch.train import TrainState, build_optimizer, build_pretrain_step, unet_eps_apply

DROPOUT = dict(torch_parity.MNIST_LIKE, dropout=0.1)


def flax_unet(kwargs, seed):
    """(flax module, params, numpy params): the flax UNet's param shapes
    (``jax.eval_shape``, no init run) with values drawn from ``seed``:
    kernels ~ N(0, 1/fan_in), scales ~ 1 + N(0, 0.1²), biases ~ N(0, 0.1²)."""
    from siss_tpu.models.unet2d import UNet2D as FlaxUNet2D
    from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig

    fmodel = FlaxUNet2D(FlaxConfig(**kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: fmodel.init_params(jax.random.PRNGKey(0))))
    return fmodel, jax.tree.map(jnp.asarray, np_params), np_params


def test_deterministic_forward_equals_jax_and_no_dropout():
    fmodel, params, np_params = flax_unet(DROPOUT, seed=2)
    model = torch_parity.torch_unet(DROPOUT, np_params).train()   # training mode: still no drop
    plain = torch_parity.torch_unet(torch_parity.MNIST_LIKE, np_params)
    x = np.random.default_rng(0).normal(size=(3, 8, 8, 1)).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    want = np.asarray(jax.jit(fmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    xt, tt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t)
    with torch.no_grad():
        got = model(xt, tt)
        assert torch.equal(got, plain(xt, tt))
        assert torch.equal(got, model(xt, tt, deterministic=True,
                                      generator=torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def sgd_step(kwargs, np_params, batch, key):
    model = torch_parity.torch_unet(kwargs, np_params)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 0.1}, model.parameters())
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    return step(TrainState.create(model, opt, sched), torch.from_numpy(batch),
                draws=jax_draws(key, batch.shape))


def test_train_step_with_dropout_equals_jax_and_drops_nothing():
    fmodel, params, np_params = flax_unet(DROPOUT, seed=4)
    batch = np.random.default_rng(0).uniform(-1, 1, size=(4, 8, 8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jstep = jax.jit(jax_build_pretrain_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
                                            JaxSchedule.create(1000, "linear"), optax.sgd(0.1)))
    jstate, jm = jstep(JaxState.create(params, optax.sgd(0.1)), jnp.asarray(batch), key)
    state, m = sgd_step(DROPOUT, np_params, batch, key)
    assert_metrics_match([(m, jm)])
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=1e-6)
    plain, m0 = sgd_step(torch_parity.MNIST_LIKE, np_params, batch, key)
    assert float(m["loss"]) == float(m0["loss"])
    for k, v in plain.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k


def block(rate):
    torch.manual_seed(0)
    return ResnetBlock2D(8, 8, 16, groups=4, dropout=rate)


def test_injected_mask_is_inverted_dropout_before_conv2():
    b = block(0.25)
    x, temb = torch.randn(2, 8, 6, 6), torch.randn(2, 16)
    mask = torch.rand(2, 8, 6, 6, generator=torch.Generator().manual_seed(1)) < 0.75
    with torch.no_grad():
        h = b.conv1(F.silu(b.norm1(x))) + b.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(b.norm2(h))
        want = b.conv2(mask * h / (1 - 0.25)) + x
        got = b(x, temb, deterministic=False, mask=mask)
        assert torch.equal(b(x, temb, mask=mask), b(x, temb))   # deterministic by default
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_drawn_masks_keep_the_rate_and_follow_the_generator():
    b = block(0.5)
    x, temb = torch.randn(4, 8, 16, 16), torch.randn(4, 16)
    kept = []
    b.conv2.register_forward_hook(lambda mod, inp, out: kept.append((inp[0] != 0).float().mean()))
    with torch.no_grad():
        a = b(x, temb, deterministic=False, generator=torch.Generator().manual_seed(5))
        again = b(x, temb, deterministic=False, generator=torch.Generator().manual_seed(5))
        other = b(x, temb, deterministic=False, generator=torch.Generator().manual_seed(6))
        assert torch.equal(a, again) and not torch.equal(a, other)
        assert torch.equal(block(1.0)(x, temb, deterministic=False), block(1.0).conv2(
            torch.zeros(4, 8, 16, 16)) + x)
    assert all(abs(float(k) - 0.5) < 0.03 for k in kept[:3])


def test_unet_dropout_acts_only_when_asked():
    model = UNet2D(UNet2DConfig(**DROPOUT))
    x, t = torch.randn(2, 1, 8, 8), torch.tensor([3, 900])
    with torch.no_grad():
        base = model(x, t)
        dropped = model(x, t, deterministic=False, generator=torch.Generator().manual_seed(0))
        again = model(x, t, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(dropped, again) and not torch.allclose(dropped, base)
