"""The port's deletion step (siss_tpu_torch.train.step) on every objective
against siss_tpu.train.step: each ``loss_fn`` through its own gradient path
(scalar, fused SISS, shared forward, two forwards), with both surgery forms,
unfused SISS, and per-microbatch [A] loss scalars.

The ε model is torch_parity.TinyEps (the same function in both packages),
so each case compiles in about a second. The JAX draws are injected:
``split(key, A)``, then ``split(k, 5)`` per microbatch into noise, t and the
loss key, from which the loss's own draw is made (u [mb] for the mixtures,
the uniform forget target for EraseDiff). Tolerances as in
tests/test_torch_train_step.py: params rtol 1e-4 / atol 1e-6 after one SGD
step, rtol 1e-4 / atol 0.25·lr after two AdamW+EMA steps; loss and gradient
metrics rtol 1e-4 (atol 1e-7 for a surgery scale that is ~0); importance
weights rtol 1e-3 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import TinyEps, jax_tiny_apply, tiny_apply, tiny_params
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.losses import LOSS_FUNCTIONS
from siss_tpu_torch.train import DeletionStepConfig, TrainState, build_deletion_train_step
from siss_tpu_torch.train import build_optimizer
from siss_tpu_torch.train.step import draw_microbatch_randomness

A, MB, HW, C = 2, 4, 6, 2
LR = 1e-3
OPTIMIZERS = {
    "sgd": ({"_target_": "sgd", "lr": 1.0}, lambda: optax.sgd(1.0), 1, False),
    "adamw_ema": ({"_target_": "torch.optim.AdamW", "lr": LR, "betas": [0.95, 0.999],
                   "weight_decay": 1e-6},
                  lambda: optax.adamw(LR, b1=0.95, b2=0.999, weight_decay=1e-6), 2, True),
}
LOSS_PARAMS = (("lambd", 0.5), ("superfactor", 0.8))


def jax_draws(key, loss_fn, shape, t_min=0, t_max=1000):
    """The JAX step's per-microbatch draws, as torch tensors."""
    out = {"noise": [], "t": [], "u": [], "uniform": []}
    for k in jax.random.split(key, A):
        k_noise, k_t, k_loss, _, _ = jax.random.split(k, 5)
        out["noise"].append(jax.random.normal(k_noise, (MB,) + shape))
        out["t"].append(jax.random.randint(k_t, (MB,), t_min, t_max))
        out["u"].append(jax.random.uniform(k_loss, (MB,)))
        out["uniform"].append(jax.random.uniform(k_loss, (MB,) + shape))
    draws = {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}
    draws["t"] = draws["t"].long()
    if loss_fn != "erasediff":
        del draws["uniform"]
    return draws


def run_steps(step_kw, opt_name, dyn=None, seed=0):
    """Steps of both packages from the same params, batch and draws; returns
    (jax state, port state, [(port metrics, jax metrics)], lr)."""
    opt_cfg, jax_tx, steps, use_ema = OPTIMIZERS[opt_name]
    kw = dict(loss_params=LOSS_PARAMS, scaling_norm=3.0, grad_accum_steps=A, use_ema=use_ema,
              **step_kw)
    params = tiny_params(seed, channels=C)
    rng = np.random.default_rng(seed + 1)
    batch = {k: rng.normal(size=(A, MB, HW, HW, C)).astype(np.float32) for k in ("all", "deletion")}
    tx = jax_tx()
    jstep = jax.jit(jax_build_step(jax_tiny_apply, JaxSchedule.create(1000, "linear"), tx,
                                   JaxStepConfig(**kw)))
    jstate = JaxState.create(jax.tree.map(jnp.asarray, params), tx, use_ema=use_ema)
    model = TinyEps(params)
    opt, sched = build_optimizer(opt_cfg, model.parameters())
    state = TrainState.create(model, opt, sched, use_ema=use_ema)
    step = build_deletion_train_step(tiny_apply, NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**kw))
    jdyn = {k: jnp.asarray(v, jnp.float32) for k, v in (dyn or {}).items()}
    tdyn = {k: torch.tensor(v, dtype=torch.float32) for k, v in (dyn or {}).items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pairs = []
    for i in range(steps):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jdyn)
        state, m = step(state, tbatch, dyn_scalars=tdyn,
                        draws=jax_draws(key, kw.get("loss_fn"), (HW, HW, C)))
        pairs.append((m, jm))
    return jstate, state, pairs, opt_cfg["lr"]


def assert_metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith("importance_weight"):
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-3, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)


def assert_params_match(state, jstate, lr, adam):
    atol = 0.25 * lr if adam else 1e-6
    names = list(state.model.state_dict())
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jstate.params[name]), rtol=1e-4,
                                   atol=atol, err_msg=name)
    if state.ema is not None:
        for name, e in zip(names, state.ema.params):
            np.testing.assert_allclose(e.numpy(), np.asarray(jstate.ema.params[name]),
                                       rtol=1e-4, atol=atol, err_msg=f"ema {name}")


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("fused_surgery", [True, False], ids=["fused_surgery", "plain_surgery"])
@pytest.mark.parametrize("loss_fn", LOSS_FUNCTIONS)
def test_objective_steps_match_jax(loss_fn, fused_surgery, opt_name):
    jstate, state, pairs, lr = run_steps(dict(loss_fn=loss_fn, fused_surgery=fused_surgery),
                                         opt_name)
    for m, jm in pairs:
        assert_metrics_match(m, jm)
        # The scalar path logs no surgery metrics; every other path does.
        assert ("gradient/scaling_factor" in m) == (loss_fn not in ("simple_neg_del", "naive_del"))
    assert_params_match(state, jstate, lr, opt_name == "adamw_ema")
    assert state.step == len(pairs)


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_unfused_siss_matches_jax(opt_name):
    """fused_siss=False: the loss method's forward and two pulls."""
    jstate, state, pairs, lr = run_steps(dict(fused_siss=False), opt_name)
    for m, jm in pairs:
        assert_metrics_match(m, jm)
    assert_params_match(state, jstate, lr, opt_name == "adamw_ema")


@pytest.mark.parametrize("loss_fn,dyn", [
    ("simple_neg_del", {"superfactor": [1.0, 0.5]}),
    ("simple_neg_del", {"superfactor": 0.3}),
    ("importance_sampling_with_mixture", {"lambd": [0.3, 0.7]}),
], ids=["superfactor_per_microbatch", "superfactor_scalar", "unfused_lambd_per_microbatch"])
def test_dynamic_scalars_ride_the_microbatches(loss_fn, dyn):
    """[A] scalars give each microbatch its own value (the task's per-
    microbatch superfactor decay); a plain scalar holds for all; dynamic λ
    runs off the fused path."""
    step_kw = dict(loss_fn=loss_fn, fused_siss=False)
    jstate, state, [(m, jm)], lr = run_steps(step_kw, "sgd", dyn=dyn)
    assert_metrics_match(m, jm)
    assert_params_match(state, jstate, lr, adam=False)


def test_superfactor_scales_each_microbatch():
    """NegGrad's gradient is −superfactor·∇MSE, microbatch by microbatch: a
    [2, 0] superfactor gives twice the first microbatch's gradient alone."""
    params = tiny_params(3, channels=C)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.normal(size=(A, MB, HW, HW, C)).astype(np.float32))
             for k in ("all", "deletion")}
    draws = draw_microbatch_randomness(torch.Generator().manual_seed(0), A, MB, (HW, HW, C),
                                       0, 1000, "cpu")
    grads = []
    for sf in ([2.0, 0.0], [1.0, 1.0], [1.0, 0.0]):
        model = TinyEps(params)
        opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
        step = build_deletion_train_step(tiny_apply, NoiseSchedule.create(1000, device="cpu"),
                                         DeletionStepConfig(loss_fn="simple_neg_del",
                                                            loss_params=(), max_grad_norm=1e9))
        step(TrainState.create(model, opt, sched), batch,
             dyn_scalars={"superfactor": torch.tensor(sf)}, draws=draws)
        grads.append(torch.cat([(torch.from_numpy(params[k]) - p.detach()).reshape(-1)
                                for k, p in model.named_parameters()]))
    torch.testing.assert_close(grads[0], 2 * grads[2], rtol=1e-5, atol=1e-7)
    assert not torch.allclose(grads[1], grads[2])


def test_erasediff_draws_a_uniform_target():
    draws = draw_microbatch_randomness(torch.Generator().manual_seed(0), A, MB, (HW, HW, C),
                                       0, 1000, "cpu", uniform_target=True)
    u = draws["uniform"]
    assert u.shape == (A, MB, HW, HW, C) and float(u.min()) >= 0 and float(u.max()) < 1
    plain = draw_microbatch_randomness(torch.Generator().manual_seed(0), A, MB, (HW, HW, C),
                                       0, 1000, "cpu")
    assert sorted(plain) == ["noise", "t", "u"]
    assert all(torch.equal(plain[k], draws[k]) for k in plain)   # SISS's draws are unchanged
