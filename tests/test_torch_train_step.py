"""The port's fused SISS train step (siss_tpu_torch.train) against the JAX
step, with the JAX draws injected into the port.

The draws are made exactly as ``siss_tpu/train/step.py`` makes them:
``split(key, A)``, then ``split(k, 5)`` per microbatch into noise, t and
the mixture's uniform. Tolerances: params rtol 1e-4 / atol 1e-6 after SGD
(the update is the clipped gradient, whose fp32 sums run in other orders);
loss and gradient metrics rtol 1e-4; importance-weight stats rtol 1e-3 /
atol 1e-6 (iw is exp of a difference of large sums; see
test_torch_siss_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import CELEB_LIKE, flax_unet, torch_unet
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu.train.ema import ema_decay as jax_ema_decay
from siss_tpu.train.optim import build_lr_schedule as jax_lr_schedule
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.ops.siss import siss_weighted_sums_reference
from siss_tpu_torch.train import (
    DeletionStepConfig,
    TrainState,
    build_deletion_train_step,
    build_lr_schedule,
    build_optimizer,
    clip_by_global_norm,
    ema_decay,
    global_norm,
    unet_eps_apply,
)
from siss_tpu_torch.train.step import draw_microbatch_randomness
from siss_tpu_torch.utils.convert import params_from_flax

A, MB, HW = 2, 4, 8
STEP_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", 0.5),),
               scaling_norm=5.0, grad_accum_steps=A, t_min=500, t_max=1000)


def jax_draws(key, shape, t_min, t_max):
    """The JAX fused step's per-microbatch draws, as torch tensors."""
    noise, ts, us = [], [], []
    for k in jax.random.split(key, A):
        k_noise, k_t, k_loss, _, _ = jax.random.split(k, 5)
        noise.append(jax.random.normal(k_noise, (MB,) + shape, dtype=jnp.float32))
        ts.append(jax.random.randint(k_t, (MB,), t_min, t_max))
        us.append(jax.random.uniform(k_loss, (MB,)))
    return {"noise": torch.from_numpy(np.array(jnp.stack(noise))),
            "t": torch.from_numpy(np.array(jnp.stack(ts)).astype(np.int64)),
            "u": torch.from_numpy(np.array(jnp.stack(us)))}


def make_batch(C, seed=3, H=HW):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(A, MB, H, H, C)).astype(np.float32) for k in ("all", "deletion")}


def assert_metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith("importance_weight"):
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-3, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)


def run_unet_steps(opt_cfg, jax_tx, keys, use_ema=False):
    """Steps of both packages on the tiny celeb-like UNet from the same
    params, batch and draws; returns (jax state, port state, metrics pairs)."""
    fmodel, params, np_params = flax_unet(CELEB_LIKE, seed=2)
    batch = make_batch(3)
    jstep = jax.jit(jax_build_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
                                   JaxSchedule.create(1000, "linear"), jax_tx,
                                   JaxStepConfig(**STEP_KW, use_ema=use_ema)))
    jstate = JaxState.create(params, jax_tx, use_ema=use_ema)
    model = torch_unet(CELEB_LIKE, np_params)
    opt, sched = build_optimizer(opt_cfg, model.parameters())
    state = TrainState.create(model, opt, sched, use_ema=use_ema)
    step = build_deletion_train_step(unet_eps_apply, NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**STEP_KW, use_ema=use_ema))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pairs = []
    for key in keys:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, {})
        state, m = step(state, tbatch, draws=jax_draws(key, (HW, HW, 3), 500, 1000))
        pairs.append((m, jm))
    return jstate, state, pairs


def assert_params_match(torch_params, jax_params, rtol, atol):
    want = params_from_flax(jax.tree.map(np.asarray, jax_params))
    assert sorted(torch_params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(torch_params[k].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_one_step_sgd_matches_jax():
    jstate, state, [(m, jm)] = run_unet_steps({"_target_": "sgd", "lr": 1.0}, optax.sgd(1.0),
                                              [jax.random.PRNGKey(7)])
    assert_metrics_match(m, jm)
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=1e-6)
    assert state.step == 1


def test_two_steps_adamw_ema_match_jax():
    """AdamW moves every param by ~lr whatever its gradient's size, so a
    gradient that is ~0 by symmetry (e.g. the to_k bias, which softmax
    ignores) gets a rounding-noise direction: params and EMA are held at
    atol 0.25·lr on top of rtol 1e-4."""
    lr = 1e-4
    cfg = {"_target_": "torch.optim.AdamW", "lr": lr, "betas": [0.95, 0.999],
           "weight_decay": 1e-6}
    tx = optax.adamw(lr, b1=0.95, b2=0.999, weight_decay=1e-6)
    jstate, state, pairs = run_unet_steps(cfg, tx, [jax.random.PRNGKey(1), jax.random.PRNGKey(2)],
                                          use_ema=True)
    for m, jm in pairs:
        assert_metrics_match(m, jm)
    names = list(state.model.state_dict())
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=0.25 * lr)
    ema = dict(zip(names, state.ema.params))
    assert_params_match(ema, jstate.ema.params, rtol=1e-4, atol=0.25 * lr)
    assert state.ema.step == int(jstate.ema.step) == 2


class Linear(torch.nn.Module):
    """eps = w·x + b, so the gradients are analytic."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.5))
        self.b = torch.nn.Parameter(torch.tensor(0.1))


def linear_apply(model, x, t, cond):
    return model.w * x + model.b


@pytest.mark.parametrize("max_grad_norm", [1e9, 1e-2], ids=["no_clip", "clip"])
def test_linear_model_surgery_and_clip(max_grad_norm):
    """Final update = clip(g_x − (scaling_norm/‖g_a‖)·g_a), with g_x, g_a
    the microbatch-averaged gradients of Σ iw·l / mb; and equal to JAX's."""
    kw = dict(STEP_KW, scaling_norm=3.0, max_grad_norm=max_grad_norm, t_min=0, t_max=100)
    batch = make_batch(1, seed=5)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, (HW, HW, 1), 0, 100)

    model = Linear()
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    sched_t = NoiseSchedule.create(100, device="cpu")
    step = build_deletion_train_step(linear_apply, sched_t, DeletionStepConfig(**kw))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = step(TrainState.create(model, opt, sched), tbatch, draws=draws)

    # Independent recomputation with the plain reference epilogue.
    w0, b0 = torch.tensor(0.5, requires_grad=True), torch.tensor(0.1, requires_grad=True)
    gx, ga = torch.zeros(2), torch.zeros(2)
    for a in range(A):
        t, noise = draws["t"][a], draws["noise"][a]
        g_t = sched_t.gamma[t].reshape(-1, 1, 1, 1)
        s_t = sched_t.sigma[t].reshape(-1, 1, 1, 1)
        keep, forget = tbatch["all"][a], tbatch["deletion"][a]
        mix = torch.where((draws["u"][a] > 0.5).reshape(-1, 1, 1, 1),
                          g_t * keep + s_t * noise, g_t * forget + s_t * noise)
        wlx, wla, _ = siss_weighted_sums_reference(w0 * mix + b0, mix, keep, forget,
                                                   sched_t.gamma[t], sched_t.sigma[t], 0.5)
        gx += torch.stack(torch.autograd.grad(wlx / MB, (w0, b0), retain_graph=True))
        ga += torch.stack(torch.autograd.grad(wla / MB, (w0, b0)))
    gx, ga = gx / A, ga / A
    s = 3.0 / ga.norm()
    final = gx - s * ga
    norm = final.norm()
    final = final * min(1.0, max_grad_norm / (float(norm) + 1e-6))
    np.testing.assert_allclose(float(m["gradient/scaling_factor"]), float(s), rtol=1e-5)
    np.testing.assert_allclose(float(m["gradient/pre_clip_norm"]), float(norm), rtol=1e-5)
    np.testing.assert_allclose([float(model.w.detach()), float(model.b.detach())],
                               [0.5 - float(final[0]), 0.1 - float(final[1])], rtol=1e-5)

    # ... and the JAX step on the same draws.
    jstep = jax.jit(jax_build_step(lambda p, x, t, c: p["w"] * x + p["b"],
                                   JaxSchedule.create(100, "linear"), optax.sgd(1.0),
                                   JaxStepConfig(**kw)))
    params = {"w": jnp.asarray(0.5), "b": jnp.asarray(0.1)}
    jstate, jm = jstep(JaxState.create(params, optax.sgd(1.0)),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key, {})
    assert_metrics_match(m, jm)
    np.testing.assert_allclose([float(model.w.detach()), float(model.b.detach())],
                               [float(jstate.params["w"]), float(jstate.params["b"])], rtol=1e-5)


@pytest.mark.parametrize("loss_fn,exc", [("modified_noise_obj", NotImplementedError),
                                         ("no_such_loss", ValueError)])
def test_config_guards_match_jax(loss_fn, exc):
    with pytest.raises(exc):
        JaxStepConfig(loss_fn=loss_fn)
    with pytest.raises(exc):
        DeletionStepConfig(loss_fn=loss_fn)


# The SD options of ROADMAP item 6b. The other loss_fns, fused_siss=False
# and fused_surgery=False are ported: tests/test_torch_objectives.py holds
# them to the JAX step.
@pytest.mark.parametrize("kwargs", [
    dict(noise_offset=0.1),
    dict(input_perturbation=0.1),
    dict(batched_dual_backward=True),
    dict(grad_accum_dtype="bfloat16"),
    dict(param_cast_dtype="bfloat16"),
], ids=lambda kw: next(iter(kw)))
def test_unported_branches_raise(kwargs):
    cfg = DeletionStepConfig(**kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6b"):
        build_deletion_train_step(linear_apply, NoiseSchedule.create(100, device="cpu"), cfg)


def test_dynamic_lambd_raises():
    step = build_deletion_train_step(linear_apply, NoiseSchedule.create(100, device="cpu"),
                                     DeletionStepConfig(**STEP_KW))
    model = Linear()
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    batch = {k: torch.from_numpy(v) for k, v in make_batch(1).items()}
    with pytest.raises(ValueError, match="dynamic lambd"):
        step(TrainState.create(model, opt, sched), batch, torch.Generator().manual_seed(0),
             {"lambd": 0.3})


def test_generator_draws_are_reproducible():
    """Without injected draws the step draws from its generator: the same
    seed gives the same step, t stays in [t_min, t_max)."""
    draws = draw_microbatch_randomness(torch.Generator().manual_seed(0), A, MB, (HW, HW, 1),
                                       990, 1000, "cpu")
    assert draws["noise"].shape == (A, MB, HW, HW, 1) and draws["u"].shape == (A, MB)
    assert int(draws["t"].min()) >= 990 and int(draws["t"].max()) < 1000
    batch = {k: torch.from_numpy(v) for k, v in make_batch(1).items()}
    out = []
    for _ in range(2):
        model = Linear()
        opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
        step = build_deletion_train_step(linear_apply, NoiseSchedule.create(1000, device="cpu"),
                                         DeletionStepConfig(**STEP_KW))
        _, m = step(TrainState.create(model, opt, sched), batch, torch.Generator().manual_seed(4))
        out.append((float(model.w.detach()), float(m["gradient/pre_clip_norm"])))
    assert out[0] == out[1]


def test_global_norm_and_clip():
    tree = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    np.testing.assert_allclose(float(global_norm(tree)), 5.0, rtol=1e-6)
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-4)
    small, _ = clip_by_global_norm([torch.tensor([0.3])], 1.0)
    np.testing.assert_allclose(small[0].numpy(), [0.3], rtol=1e-5)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", ["constant", "cosine", "linear"])
def test_lr_schedules_match_optax(name, warmup):
    """optax evaluates its schedules in float32, the port in float64."""
    ours = build_lr_schedule(name, 1e-3, warmup, total_steps=12)
    theirs = jax_lr_schedule(name, 1e-3, warmup, total_steps=12)
    for count in range(15):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-5, atol=1e-12)


def test_ema_decay_matches_jax():
    for step in (1, 2, 10, 1000, 10 ** 6):
        np.testing.assert_allclose(ema_decay(step), float(jax_ema_decay(jnp.asarray(step))),
                                   rtol=1e-6)


def test_unported_optimizers_raise():
    with pytest.raises(NotImplementedError):
        build_optimizer({"_target_": "adafactor", "lr": 1e-3}, [torch.nn.Parameter(torch.ones(1))])
    with pytest.raises(NotImplementedError):
        build_optimizer({"lr": 1e-3, "mu_dtype": "bfloat16"}, [torch.nn.Parameter(torch.ones(1))])
