"""The port's reverse-process steps, samplers, evaluator grid and t-shirt
detector against the JAX package's, on the CPU.

JAX's draws are regenerated from the same key chains as
``siss_tpu/diffusion/sampling.py`` (a split for the starting noise, then one
split per step) and handed to the port. Tolerances: one step 1e-6 (a few
fp32 operations, in the same order); a whole sampler 1e-5 (up to 50 steps
of the same, through a smooth fixed ε function); the timestep grid, the grid
image and the detector exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import sampling as jax_sampling
from siss_tpu.diffusion import schedule as jax_schedule
from siss_tpu.evaluate import Evaluator as JaxEvaluator
from siss_tpu.metrics.tshirt import TShirtClassifier as JaxTShirt
from siss_tpu_torch.diffusion import sampling, schedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.metrics import TShirtClassifier

SHAPE = (3, 6, 6, 2)


def schedules(prediction_type="epsilon", clip_sample=True):
    kw = dict(prediction_type=prediction_type, clip_sample=clip_sample)
    return (schedule.NoiseSchedule.create(1000, device="cpu", **kw),
            jax_schedule.NoiseSchedule.create(1000, **kw))


def jax_eps(x, t, cond):
    return 0.5 * jnp.tanh(x) + 1e-3 * t.astype(jnp.float32)[:, None, None, None] - 0.2


def port_eps(x, t, cond):
    return 0.5 * torch.tanh(x) + 1e-3 * t.to(torch.float32)[:, None, None, None] - 0.2


def t_of(array):
    return torch.from_numpy(np.array(array))


@pytest.mark.parametrize("n", [1, 7, 10, 50, 1000])
def test_spaced_timesteps_equal(n):
    ours, theirs = schedule.spaced_timesteps(1000, n), jax_schedule.spaced_timesteps(1000, n)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_pred_x0_from_eps():
    ours, theirs = schedules()
    rng = np.random.default_rng(0)
    x, eps = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999])
    got = schedule.pred_x0_from_eps(ours, t_of(x), t_of(eps), t_of(t))
    want = jax_schedule.pred_x0_from_eps(theirs, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


STEP_CASES = [(999, 979), (500, 499), (20, 0), (0, -1)]
PRED_CASES = [("epsilon", True), ("epsilon", False), ("sample", True), ("v_prediction", True)]


@pytest.mark.parametrize("pred,clip", PRED_CASES)
@pytest.mark.parametrize("t,prev", STEP_CASES)
def test_ddpm_step(t, prev, pred, clip):
    ours, theirs = schedules(pred, clip)
    rng = np.random.default_rng(t)
    x, out = (2 * rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t + 3)
    want = jax_schedule.ddpm_step(theirs, jnp.asarray(x), jnp.asarray(out), jnp.asarray(t),
                                  jnp.asarray(prev), key)
    noise = np.asarray(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    got = schedule.ddpm_step(ours, t_of(x), t_of(out), t, prev, noise=t_of(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("pred,clip", PRED_CASES)
@pytest.mark.parametrize("t,prev", STEP_CASES[:3] + [(5, -1)])
def test_ddim_step(t, prev, pred, clip, eta):
    ours, theirs = schedules(pred, clip)
    rng = np.random.default_rng(t + 1)
    x, out = (2 * rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t)
    want = jax_schedule.ddim_step(theirs, jnp.asarray(x), jnp.asarray(out), jnp.asarray(t),
                                  jnp.asarray(prev), eta=eta, key=key)
    noise = np.asarray(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    got = schedule.ddim_step(ours, t_of(x), t_of(out), t, prev, eta=eta, noise=t_of(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ddim_eta_needs_noise():
    ours, _ = schedules()
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        schedule.ddim_step(ours, x, x, 10, 5, eta=0.5)


def chain_noise(key, n_steps, split_init):
    """The starting noise (when ``split_init``) and per-step noise of a
    JAX sampling loop's key chain."""
    init = None
    if split_init:
        key, init_key = jax.random.split(key)
        init = t_of(jax.random.normal(init_key, SHAPE, dtype=jnp.float32))
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(t_of(jax.random.normal(sub, SHAPE, dtype=jnp.float32)))
    return init, steps


@pytest.mark.parametrize("n_steps", [4, 50])
def test_sample_ddpm_matches_jax(n_steps):
    ours, theirs = schedules()
    key = jax.random.PRNGKey(11)
    want = jax_sampling.sample_ddpm(jax_eps, theirs, key, SHAPE, n_steps)
    init, steps = chain_noise(key, n_steps, split_init=True)
    got = sampling.sample_ddpm(port_eps, ours, SHAPE, n_steps, x_init=init, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sample_ddim_matches_jax(eta):
    ours, theirs = schedules()
    key = jax.random.PRNGKey(5)
    want = jax_sampling.sample_ddim(jax_eps, theirs, key, SHAPE, 10, eta=eta)
    init, steps = chain_noise(key, 10, split_init=True)
    got = sampling.sample_ddim(port_eps, ours, SHAPE, 10, eta=eta, x_init=init, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t_start", [0, 9, 250])
def test_denoise_from_t_matches_jax(t_start):
    ours, theirs = schedules()
    key = jax.random.PRNGKey(2)
    x_t = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    want = jax_sampling.denoise_from_t(jax_eps, theirs, key, jnp.asarray(x_t), t_start)
    _, steps = chain_noise(key, t_start + 1, split_init=False)
    got = sampling.denoise_from_t(port_eps, ours, t_of(x_t), t_start, step_noise=steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_steps", [2, 10, 20])
def test_dpm_solver_2m_matches_jax(n_steps):
    ours, theirs = schedules()
    key = jax.random.PRNGKey(8)
    want = jax_sampling.sample_dpm_solver_2m(jax_eps, theirs, key, SHAPE, n_steps)
    init, _ = chain_noise(key, 0, split_init=True)
    got = sampling.sample_dpm_solver_2m(port_eps, ours, SHAPE, n_steps, x_init=init)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t_start,n", [(250, 10), (3, 10), (1, 2)])
def test_denoise_from_t_dpm_matches_jax(t_start, n):
    ours, theirs = schedules()
    x_t = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    want = jax_sampling.denoise_from_t_dpm(jax_eps, theirs, jnp.asarray(x_t), t_start, n)
    got = sampling.denoise_from_t_dpm(port_eps, ours, t_of(x_t), t_start, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_evaluator_samples_and_seeding():
    """NHWC float in [0, 1]; ``set_generator`` repeats its panel."""
    ours, _ = schedules()
    ev = Evaluator(lambda model, x, t, c: port_eps(x, t, c), ours, SHAPE[1:], 4, random_seed=3)
    a = ev.sample_images(None, 3, set_generator=True)
    b = ev.sample_images(None, 3, set_generator=True)
    assert a.shape == SHAPE and a.dtype == np.float32
    assert a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(a, b)
    d = ev.denoise_images(None, np.zeros(SHAPE, np.float32), 5)
    assert d.shape == SHAPE
    dpm = Evaluator(lambda model, x, t, c: port_eps(x, t, c), ours, SHAPE[1:], 4, solver="dpm")
    assert dpm.sample_images(None, 2).shape == (2,) + SHAPE[1:]
    with pytest.raises(ValueError):
        Evaluator(None, ours, SHAPE[1:], solver="euler")


@pytest.mark.parametrize("n,c", [(1, 1), (5, 1), (9, 3), (64, 1)])
def test_make_grid_equal(n, c):
    imgs = np.random.default_rng(n).random((n, 7, 5, c)).astype(np.float32)
    ours = Evaluator.make_grid_from_images(imgs)
    theirs = JaxEvaluator.make_grid_from_images(imgs)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_tshirt_detector_equal():
    """Images at L2 distances well away from the threshold of 10 on both
    sides, so fp32 summation order cannot flip a match."""
    rng = np.random.default_rng(0)
    tshirt = rng.random((28, 28, 1)).astype(np.float32)
    offsets = np.array([0.0, 0.1, 0.2, 0.5, 0.9, 1.2])[:, None, None, None]
    signs = rng.choice([-1.0, 1.0], size=(6, 28, 28, 1))
    imgs = (tshirt[None] + offsets * signs).astype(np.float32)   # distances 28·offset
    freq, mask = TShirtClassifier.get_tshirt_frequency(imgs, tshirt)
    want_freq, want_mask = JaxTShirt.get_tshirt_frequency(imgs, tshirt)
    assert freq == want_freq == 3 / 6
    np.testing.assert_array_equal(mask, want_mask)
    assert TShirtClassifier.get_tshirt_frequency(imgs, tshirt, threshold=30.0)[0] == 5 / 6
