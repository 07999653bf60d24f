"""The port's noise schedule (siss_tpu_torch.diffusion) against the JAX
package's: the tables are built the same way on the host (float64, cast to
float32), so they agree bit for bit; q_sample and the SNR weights are one
fp32 multiply-add or divide per element and agree to 1 ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import schedule as jax_schedule
from siss_tpu_torch.diffusion import schedule as port_schedule


@pytest.mark.parametrize("name", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_tables_bitwise(name):
    ours = port_schedule.NoiseSchedule.create(1000, name, device="cpu")
    theirs = jax_schedule.NoiseSchedule.create(1000, name)
    for field in ("betas", "alphas_cumprod", "gamma", "sigma"):
        got = getattr(ours, field)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(theirs, field)), err_msg=field)


def test_q_sample_and_snr_weights():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(5, 6, 6, 3)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 1, 250, 998, 999])
    ours = port_schedule.NoiseSchedule.create(1000, device="cpu")
    theirs = jax_schedule.NoiseSchedule.create(1000)
    got = port_schedule.q_sample(ours, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    want = jax_schedule.q_sample(theirs, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    got = port_schedule.snr_weights(ours, torch.from_numpy(t), torch.from_numpy(x0))
    want = jax_schedule.snr_weights(theirs, jnp.asarray(t), jnp.asarray(x0))
    assert got.shape == (5, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        port_schedule.make_beta_schedule("nope", 10)
