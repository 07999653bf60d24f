"""The port's DDPM pretraining step (siss_tpu_torch.train.build_pretrain_step)
against the JAX package's, on the tiny mnist-like UNet (block_out_channels
(16, 32)) with the flax weights carried over and JAX's draws injected.

Tolerances are test_torch_train_step.py's: loss and gradient norm rtol 1e-4;
params rtol 1e-4 / atol 1e-6 after SGD (the update is the clipped gradient,
whose fp32 sums run in other orders), atol 0.25·lr after AdamW (which moves
a parameter whose gradient is ~0 by symmetry in a rounding-noise direction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import MNIST_LIKE, flax_unet, torch_unet
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_pretrain_step as jax_build_pretrain_step
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.train import TrainState, build_optimizer, build_pretrain_step, unet_eps_apply
from siss_tpu_torch.utils.convert import params_from_flax

B, HW = 4, 8


def jax_draws(key, shape):
    """The JAX pretrain step's draws: split(key) into noise and t."""
    k_noise, k_t = jax.random.split(key)
    noise = jax.random.normal(k_noise, shape, dtype=jnp.float32)
    t = jax.random.randint(k_t, (shape[0],), 0, 1000)
    return {"noise": torch.from_numpy(np.array(noise)),
            "t": torch.from_numpy(np.array(t).astype(np.int64))}


def run_steps(opt_cfg, jax_tx, keys, prediction_type="epsilon", use_ema=False,
              max_grad_norm=1.0):
    fmodel, params, np_params = flax_unet(MNIST_LIKE, seed=4)
    batch = np.random.default_rng(0).uniform(-1, 1, size=(B, HW, HW, 1)).astype(np.float32)
    jstep = jax.jit(jax_build_pretrain_step(
        lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
        JaxSchedule.create(1000, "linear", prediction_type=prediction_type), jax_tx,
        prediction_type=prediction_type, max_grad_norm=max_grad_norm))
    jstate = JaxState.create(params, jax_tx, use_ema=use_ema)
    model = torch_unet(MNIST_LIKE, np_params)
    opt, sched = build_optimizer(opt_cfg, model.parameters())
    state = TrainState.create(model, opt, sched, use_ema=use_ema)
    step = build_pretrain_step(unet_eps_apply,
                               NoiseSchedule.create(1000, prediction_type=prediction_type,
                                                    device="cpu"),
                               prediction_type=prediction_type, max_grad_norm=max_grad_norm)
    pairs = []
    for key in keys:
        jstate, jm = jstep(jstate, jnp.asarray(batch), key)
        state, m = step(state, torch.from_numpy(batch), draws=jax_draws(key, batch.shape))
        pairs.append((m, jm))
    return jstate, state, pairs


def assert_params_match(torch_params, jax_params, rtol, atol):
    want = params_from_flax(jax.tree.map(np.asarray, jax_params))
    assert sorted(torch_params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(torch_params[k].detach().numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def assert_metrics_match(pairs):
    for m, jm in pairs:
        assert sorted(m) == sorted(jm) == ["gradient/pre_clip_norm", "loss"]
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
@pytest.mark.parametrize("max_grad_norm", [1.0, 1e9], ids=["clip", "no_clip"])
def test_one_step_sgd_matches_jax(prediction_type, max_grad_norm):
    jstate, state, pairs = run_steps({"_target_": "sgd", "lr": 0.1}, optax.sgd(0.1),
                                     [jax.random.PRNGKey(3)], prediction_type,
                                     max_grad_norm=max_grad_norm)
    assert_metrics_match(pairs)
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=1e-6)
    assert state.step == int(jstate.step) == 1


def test_two_steps_adamw_ema_match_jax():
    lr = 1e-3
    cfg = {"_target_": "torch.optim.AdamW", "lr": lr, "betas": [0.95, 0.999],
           "weight_decay": 1e-6, "eps": 1e-8}
    tx = optax.adamw(lr, b1=0.95, b2=0.999, eps=1e-8, weight_decay=1e-6)
    jstate, state, pairs = run_steps(cfg, tx, [jax.random.PRNGKey(1), jax.random.PRNGKey(2)],
                                     use_ema=True)
    assert_metrics_match(pairs)
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=0.25 * lr)
    assert_params_match(state.ema_state_dict(), jstate.ema.params, rtol=1e-4, atol=0.25 * lr)
    assert state.ema.step == int(jstate.ema.step) == 2


def test_generator_draws_and_bad_prediction_type():
    model = torch_unet(MNIST_LIKE, flax_unet(MNIST_LIKE, seed=0)[2])
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 0.1}, model.parameters())
    step = build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"))
    batch = torch.zeros(B, HW, HW, 1)
    state, m = step(TrainState.create(model, opt, sched), batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError):
        step(state, batch)  # neither a generator nor draws
    with pytest.raises(ValueError):
        build_pretrain_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"),
                            prediction_type="v_prediction")
