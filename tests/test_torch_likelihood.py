"""The port's SDEs, ODE solvers and probability-flow likelihood
(siss_tpu_torch.diffusion.{sde,ode}, siss_tpu_torch.metrics.likelihood)
against the JAX package's, on the same inputs.

The Hutchinson probe is JAX's own draw, made from the same key as
``LikelihoodEvaluator`` makes it and passed to the port as a tensor.
Tolerances: the SDE formulas rtol 1e-6 (atol 5e-5 on the std, see
STD_ATOL); the ODE solvers rtol 1e-5 and the same ``nfe`` (both keep t and
h in float32, so the adaptive solver takes the same steps); bpd rtol 1e-5
after RK4 and rtol 1e-4 after RK45 (the divergence is ε·Jε in JAX and ε·Jᵀε
here: equal values, other rounding; and the score's σ[⌊t·999⌋] table is a
staircase in t, so a last-bit difference in a stage time can move one
evaluation a whole table step: JAX's own jitted and eager RK45 runs of the
Gaussian oracle differ by 4e-5); the Gaussian oracle within 5% of the
closed form, as in tests/test_likelihood.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_unet, torch_unet
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.diffusion import sde as jax_sde
from siss_tpu.diffusion.ode import odeint_rk4 as jax_rk4
from siss_tpu.diffusion.ode import odeint_rk45 as jax_rk45
from siss_tpu.metrics.likelihood import LikelihoodEvaluator as JaxLikelihood
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.diffusion import sde as port_sde
from siss_tpu_torch.diffusion.ode import odeint_rk4, odeint_rk45
from siss_tpu_torch.metrics.likelihood import LikelihoodEvaluator
from siss_tpu_torch.train import unet_eps_apply

# No attention, one resnet per level: the smallest UNet whose JAX RK45
# loop (7 jvps of the UNet in one while body) compiles in seconds.
LIK_UNET = dict(sample_size=8, in_channels=1, out_channels=1, block_out_channels=(16, 32),
                down_block_types=("DownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "UpBlock2D"), layers_per_block=1,
                norm_num_groups=8, add_mid_attention=False)


# Near t = 0 the VP std is √(1 − e^{2c}) with 1 − e^{2c} ≈ 2e-6: one float32
# ulp of the exponential (6e-8) moves it by ~3e-5, in either package.
STD_ATOL = 5e-5


def flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in flat(item)]
    return [tree]


@pytest.mark.parametrize("name", ["VPSDE", "SubVPSDE", "VESDE"])
def test_sde_formulas_match_jax(name):
    ours, theirs = getattr(port_sde, name)(), getattr(jax_sde, name)()
    x = np.random.default_rng(0).normal(size=(3, 4, 4, 2)).astype(np.float32)
    score = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    tx = torch.from_numpy(x)
    for t in (1e-5, 0.3, 1.0):
        for t_ours in (np.float32(t), torch.tensor(t, dtype=torch.float32)):
            got = [ours.sde(tx, t_ours), ours.marginal_prob(tx, t_ours),
                   ours.probability_flow_drift(tx, t_ours, torch.from_numpy(score))]
            want = [theirs.sde(jnp.asarray(x), jnp.float32(t)),
                    theirs.marginal_prob(jnp.asarray(x), jnp.float32(t)),
                    theirs.probability_flow_drift(jnp.asarray(x), jnp.float32(t),
                                                  jnp.asarray(score))]
            for g, w in zip(flat(got), flat(want)):
                np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w),
                                           rtol=1e-6, atol=STD_ATOL)
        np.testing.assert_allclose(float(ours.marginal_std(np.float32(t))),
                                   float(theirs.marginal_std(jnp.float32(t))), rtol=1e-6,
                                   atol=STD_ATOL)
    np.testing.assert_allclose(ours.prior_logp(tx).numpy(),
                               np.asarray(theirs.prior_logp(jnp.asarray(x))), rtol=1e-6)
    assert ours.T == theirs.T == 1.0 and ours.N == theirs.N


def test_rk45_matches_jax_steps_and_values():
    """An ODE stiff enough to reject steps: the same nfe and y(1)."""
    def ours_f(y, t):
        return (-20.0 * (y[0] - float(np.cos(t))), float(np.sin(t)) * y[1])

    def jax_f(y, t):
        return (-20.0 * (y[0] - jnp.cos(t)), jnp.sin(t) * y[1])

    y0 = (np.linspace(-1, 1, 6, dtype=np.float32), np.full((2,), 2.0, np.float32))
    (a, b), nfe = odeint_rk45(ours_f, tuple(map(torch.from_numpy, y0)), 0.0, 1.0, rtol=1e-6,
                              atol=1e-6)
    (ja, jb), jnfe = jax_rk45(jax_f, tuple(map(jnp.asarray, y0)), 0.0, 1.0, rtol=1e-6, atol=1e-6)
    assert nfe == int(jnfe) > 0
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5)
    # the max_steps cap stops silently, as JAX's does
    _, capped = odeint_rk45(ours_f, tuple(map(torch.from_numpy, y0)), 0.0, 1.0, max_steps=3)
    _, jcapped = jax_rk45(jax_f, tuple(map(jnp.asarray, y0)), 0.0, 1.0, max_steps=3)
    assert capped == int(jcapped) == 18


def test_rk4_matches_jax():
    def ours_f(y, t):
        return (float(np.sin(t)) * y[0],)

    y0 = np.ones((3,), np.float32)
    (got,) = odeint_rk4(ours_f, (torch.from_numpy(y0),), 0.0, 1.0, num_steps=50)
    (want,) = jax_rk4(lambda y, t: (jnp.sin(t) * y[0],), (jnp.asarray(y0),), 0.0, 1.0, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def jax_probe(key, shape, kind):
    if kind == "Gaussian":
        return np.array(jax.random.normal(key, shape))
    return np.array(jax.random.rademacher(key, shape, dtype=jnp.float32))


@pytest.mark.parametrize("method", ["rk45", "rk4"])
def test_gaussian_nll_matches_jax_and_closed_form(method):
    """The oracle ε of x0 ~ N(0, std²) (tests/test_likelihood.py)."""
    std = 0.5
    jsched = JaxSchedule.create(1000, "linear", 0.1 / 1000, 20.0 / 1000)
    sched = NoiseSchedule.create(1000, "linear", 0.1 / 1000, 20.0 / 1000, device="cpu")

    def jax_eps(params, x, t, cond):
        g, s = jsched.gamma[t].reshape(-1, 1, 1, 1), jsched.sigma[t].reshape(-1, 1, 1, 1)
        return x * s / (g ** 2 * std ** 2 + s ** 2)

    def port_eps(model, x, t, cond):
        g, s = sched.gamma[t].reshape(-1, 1, 1, 1), sched.sigma[t].reshape(-1, 1, 1, 1)
        return x * s / (g ** 2 * std ** 2 + s ** 2)

    kw = dict(method=method, hutchinson_type="Gaussian", rk4_steps=100)
    rtol = 1e-4 if method == "rk45" else 1e-5
    data = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 4, 4, 1))) * std
    key = jax.random.PRNGKey(1)
    jbpd, _, jnfe = JaxLikelihood(jax_eps, jax_sde.VPSDE(), schedule=jsched,
                                  **kw).evaluate_likelihood({}, data, key=key)
    ev = LikelihoodEvaluator(port_eps, port_sde.VPSDE(), schedule=sched, device="cpu", **kw)
    bpd, z, nfe = ev.evaluate_likelihood(None, data, probe=jax_probe(key, data.shape, "Gaussian"))
    assert nfe == int(jnfe) and z.shape == data.shape
    np.testing.assert_allclose(bpd.numpy(), np.asarray(jbpd), rtol=rtol)
    d = data.reshape(2, -1)
    logp = -0.5 * (d.shape[1] * np.log(2 * np.pi * std ** 2) + (d ** 2).sum(-1) / std ** 2)
    np.testing.assert_allclose(bpd.numpy(), -logp / np.log(2) / d.shape[1] + 7.0, rtol=0.05)


def unet_eps(method, apply, sigma):
    """RK4 runs the UNet as it is. For RK45 its output is scaled by σ_t and
    its timestep held at 500, so score = −UNet(x): a random UNet's output
    jumps between consecutive integer timesteps (its sinusoidal embedding
    turns one radian a timestep at its highest frequency), which makes the
    ODE's right-hand side a staircase of O(1) steps on which the adaptive
    solver's steps hang on the last bit of each stage time: JAX's own jitted
    and eager runs of such a UNet take 594 and 540 evaluations."""
    if method == "rk4":
        return apply

    def eps(model, x, t, cond):
        return apply(model, x, t * 0 + 500, cond) * sigma[t].reshape(-1, 1, 1, 1)

    return eps


@pytest.mark.parametrize("method,rtol", [("rk45", 1e-4), ("rk4", 1e-5)])
def test_tiny_unet_bpd_matches_jax(method, rtol):
    """A random tiny UNet with the task's schedule and JAX's Rademacher
    probe: the same nfe and the same bits/dim."""
    fmodel, params, np_params = flax_unet(LIK_UNET, seed=3)
    model = torch_unet(LIK_UNET, np_params)
    jsched = JaxSchedule.create(1000, "linear")
    sched = NoiseSchedule.create(1000, "linear", device="cpu")
    kw = dict(method=method, rk4_steps=20)
    jev = JaxLikelihood(unet_eps(method, lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
                                 jsched.sigma), jax_sde.VPSDE(), schedule=jsched, **kw)
    ev = LikelihoodEvaluator(unet_eps(method, unet_eps_apply, sched.sigma), port_sde.VPSDE(),
                             schedule=sched, device="cpu", **kw)
    data = np.random.default_rng(4).uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jbpd, jz, jnfe = jev.evaluate_likelihood(params, data, key=key)
    with torch.no_grad():   # the evaluator turns autograd on for its own pulls
        bpd, z, nfe = ev.evaluate_likelihood(model, data,
                                             probe=jax_probe(key, data.shape, "Rademacher"))
    assert nfe == int(jnfe) > 0
    np.testing.assert_allclose(bpd.numpy(), np.asarray(jbpd), rtol=rtol)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=10 * rtol, atol=10 * rtol)
    assert not any(p.grad is not None for p in model.parameters())


def test_probe_comes_from_the_seeded_generator():
    """Without a probe the evaluator draws ±1 from a generator seeded with
    random_seed: two calls agree, another seed differs."""
    sched = NoiseSchedule.create(1000, "linear", device="cpu")
    eps = lambda m, x, t, c: torch.tanh(x.roll(1, dims=2))   # noqa: E731  (J not diagonal)
    data = np.random.default_rng(0).uniform(-1, 1, (1, 4, 4, 1)).astype(np.float32)
    runs = [LikelihoodEvaluator(eps, schedule=sched, device="cpu", method="rk4", rk4_steps=10,
                                random_seed=s).evaluate_likelihood(None, data)[0]
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    probe = LikelihoodEvaluator(eps, schedule=sched, device="cpu").draw_probe(
        (64,), torch.Generator().manual_seed(0))
    assert set(probe.tolist()) == {-1.0, 1.0}
