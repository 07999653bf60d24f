"""A gradient norm of exactly 0 in the SD step, in both packages.

At t = 999 the SD schedule keeps γ = 0.0683 of the clean latent, and over
sd_v1's 64 × 64 × 4 latents the two sets' squared distances to x_t differ by
d·2σ² with |d| ≈ 60–95. A set from which no sample of the step was drawn
then has importance weights of about e^−|d| (1e-24 to 1e-41): its gradient
tree's squared entries (~1e-60) underflow fp32 and its norm is exactly 0;
when that set is the forget set, the scaling factor scaling_norm/‖g_a‖ is
infinite and the guard makes it 0. The one-process fp32 sd_v1 step of
``chip_smoke.py`` 9(h) meets this whenever every sample of a step comes from
one set.

Here TinyEps (tests/torch_parity.py) stands in for the UNet at those latents
and that schedule, at 9(h)'s cut (one microbatch of two), with JAX keys
chosen so that both of a step's samples come from the keep set (u > λ), or
both from the forget set: the port's step and the JAX step give the same
exact 0 for that set's norm (and, for the forget set, the scaling factor),
and the other metrics and the parameters after SGD agree at the
one-process parity tolerances (rtol 1e-4; params atol 1e-6).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import TinyEps, jax_tiny_apply, tiny_apply, tiny_params
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch.diffusion import sd_noise_schedule
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer)
from test_torch_train_step import assert_metrics_match

A, MB, SHAPE = 1, 2, (64, 64, 4)   # 9(h)'s cut, sd_v1's latents
LAMBD = 0.5
STEP_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", LAMBD),),
               scaling_norm=750.0, max_grad_norm=1.0, grad_accum_steps=A, t_min=999,
               t_max=1000)


def jax_draws(key):
    """The JAX fused step's draws at this cut, as torch tensors."""
    out = {"noise": [], "t": [], "u": []}
    for k in jax.random.split(key, A):
        k_noise, k_t, k_loss, _, _ = jax.random.split(k, 5)
        out["noise"].append(jax.random.normal(k_noise, (MB,) + SHAPE, dtype=jnp.float32))
        out["t"].append(jax.random.randint(k_t, (MB,), 999, 1000))
        out["u"].append(jax.random.uniform(k_loss, (MB,)))
    draws = {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}
    draws["t"] = draws["t"].long()
    return draws


def key_drawing_only(from_keep: bool):
    """The first key whose draws take every sample from the keep set (u >
    λ), or every one from the forget set."""
    for i in itertools.count():
        key = jax.random.PRNGKey(i)
        u = jax_draws(key)["u"]
        if bool(((u > LAMBD) if from_keep else (u <= LAMBD)).all()):
            return key


@pytest.mark.parametrize("from_keep,empty", [(True, "gradient/norm_loss_a"),
                                             (False, "gradient/norm_loss_x")],
                         ids=["all_keep", "all_forget"])
def test_the_norm_of_a_set_without_samples_is_zero_in_both(from_keep, empty):
    key = key_drawing_only(from_keep)
    params = tiny_params(3, channels=SHAPE[-1])
    rng = np.random.default_rng(4)
    batch = {k: rng.normal(size=(A, MB) + SHAPE).astype(np.float32) for k in ("all", "deletion")}
    tx = optax.sgd(1.0)
    jstep = jax.jit(jax_build_step(jax_tiny_apply, jax_sd_schedule(), tx,
                                   JaxStepConfig(**STEP_KW)))
    jstate, jm = jstep(JaxState.create(jax.tree.map(jnp.asarray, params), tx),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key, {})
    model = TinyEps(params)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(tiny_apply, sd_noise_schedule(device="cpu"),
                                     DeletionStepConfig(**STEP_KW))
    _, m = step(TrainState.create(model, opt, sched),
                {k: torch.from_numpy(v) for k, v in batch.items()}, draws=jax_draws(key))
    assert float(jm[empty]) == 0.0 and float(m[empty]) == 0.0
    if from_keep:   # scaling_norm / 0, guarded
        assert float(jm["gradient/scaling_factor"]) == 0.0 == float(m["gradient/scaling_factor"])
    other = "gradient/norm_loss_x" if from_keep else "gradient/norm_loss_a"
    assert float(m[other]) > 0.0
    assert_metrics_match(m, jm)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
