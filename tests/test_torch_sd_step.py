"""The port's SD-1.x latent SISS step against the JAX step: the tiny
conditional UNet at sample_size 16, 2 accumulation microbatches of 4, with
[A, mb, 7, 32] text conditioning, the SD schedule and the SD workload's
knobs (t ≡ 999, scaling_norm 750, λ 0.5). The JAX draws are injected into
the port (``test_torch_train_step.jax_draws``). The port runs
``attention_impl="flash"`` (the kernels' plain versions on the CPU), JAX
runs ``einsum`` (its flash kernel runs only on a TPU).

Tolerances as in test_torch_train_step.py: params rtol 1e-4 / atol 1e-6
after SGD (the update is the clipped gradient, whose fp32 sums run in other
orders); loss and gradient metrics rtol 1e-4; importance-weight stats
rtol 1e-3 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxConfig
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch.diffusion import sd_noise_schedule
from siss_tpu_torch.models import UNet2DCondition, UNet2DConditionConfig
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, cond_unet_eps_apply)
from siss_tpu_torch.utils.convert import params_from_flax
from test_torch_train_step import A, MB, assert_metrics_match, assert_params_match, jax_draws

HW, C, CTX_LEN, CTX_DIM = 16, 4, 7, 32
TINY16 = dict(UNet2DConditionConfig.tiny().__dict__, sample_size=HW)
SD_STEP_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", 0.5),),
                  scaling_norm=750.0, max_grad_norm=1.0, grad_accum_steps=A, t_min=999,
                  t_max=1000)


def test_sd_schedule_tables_match_jax():
    ours, theirs = sd_noise_schedule(device="cpu"), jax_sd_schedule()
    for name in ("betas", "alphas_cumprod", "gamma", "sigma"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)
    assert ours.clip_sample is False and ours.clip_sample is theirs.clip_sample


@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_one_sd_step_sgd_matches_jax(impl):
    fmodel = FlaxUNet(FlaxConfig(**dict(TINY16, attention_impl="einsum")))
    params = jax.jit(functools.partial(fmodel.init_params, batch_size=MB,
                                       context_len=CTX_LEN))(jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    batch = {k: rng.normal(size=(A, MB, HW, HW, C)).astype(np.float32)
             for k in ("all", "deletion")}
    batch["conditioning"] = rng.normal(size=(A, MB, CTX_LEN, CTX_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    tx = optax.sgd(1.0)
    jstep = jax.jit(jax_build_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t, c),
                                   jax_sd_schedule(), tx, JaxStepConfig(**SD_STEP_KW)))
    jstate, jm = jstep(JaxState.create(params, tx), {k: jnp.asarray(v) for k, v in batch.items()},
                       key, {})

    model = UNet2DCondition(UNet2DConditionConfig(**dict(TINY16, attention_impl=impl)))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(cond_unet_eps_apply, sd_noise_schedule(device="cpu"),
                                     DeletionStepConfig(**SD_STEP_KW))
    state, m = step(TrainState.create(model, opt, sched),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=jax_draws(key, (HW, HW, C), 999, 1000))
    assert_metrics_match(m, jm)
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=1e-6)
    assert state.step == 1
