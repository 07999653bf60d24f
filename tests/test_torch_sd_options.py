"""The SD optimizer and precision knobs of the port against the JAX package,
on the CPU:

- AdamW and Adam with bf16 ``mu_dtype``/``nu_dtype`` against
  ``siss_tpu.train.optim.build_optimizer`` over 5 steps, and Adafactor with
  and without ``weight_decay``, ``momentum`` and
  ``multiply_by_parameter_scale`` (a conv and a linear kernel that factor, a
  bias and a small matrix that do not). Params: each tensor within 1e-6 of
  its largest |value| (a few fp32 ulps; the packages round ``decay**count``
  and the EMAs alike but not every intermediate); Adam's stored moments
  equal in bf16; the ``ValueError``s of both packages;
- each step knob through ``build_deletion_train_step`` against the JAX step
  with injected draws: ``noise_offset`` and ``input_perturbation`` on
  TinyEps (params rtol 1e-4 / atol 1e-6 after SGD, metrics as
  tests/test_torch_objectives.py), bf16 ``grad_accum_dtype`` on TinyEps and
  bf16 ``param_cast_dtype`` on the tiny conditional UNet (each param's SGD
  update within 2⁻⁷ of the largest update of its tensor: two bf16 ulps, as
  both packages round the same fp32 gradients to bf16);
- ``batched_dual_backward`` equal to two pulls (rtol 1e-5 / atol 1e-7) on
  the fused and the unfused shared-forward paths, with the flash kernels'
  plain versions and each remat policy;
- ``remat_policy``: gradients equal to those without it, and a dispatch
  count showing that ``dots`` recomputes no convolution in the backward
  while the full recomputation does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import TinyEps, jax_tiny_apply, tiny_apply, tiny_params
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxConfig
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu.train.optim import build_optimizer as jax_build_optimizer
from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule
from siss_tpu_torch.models import UNet2DCondition, UNet2DConditionConfig
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, cond_unet_eps_apply)
from siss_tpu_torch.train.optim import factored_dims
from siss_tpu_torch.train.step import draw_microbatch_randomness
from siss_tpu_torch.utils.convert import params_from_flax
from test_torch_objectives import A, C, HW, MB, assert_metrics_match, jax_draws

# Torch-layout shapes and the permutation to flax's layout: a conv kernel
# OIHW → HWIO and a linear [out, in] → [in, out] that factor, a square conv
# whose two factored dims swap roles between the layouts (argsort ties), a
# bias and a matrix whose smaller dim is under 128, which do not.
OPT_SHAPES = {"conv": ((256, 160, 3, 3), (2, 3, 1, 0)), "linear": ((300, 200), (1, 0)),
              "square": ((192, 192, 3, 3), (2, 3, 1, 0)), "bias": ((300,), (0,)),
              "small": ((64, 8), (1, 0))}


def run_optimizers(cfg, steps=5):
    """Both packages' optimizers over the same params and gradients; returns
    (optax state, port optimizer, {name: (jax param, port param)})."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, (s, _) in OPT_SHAPES.items()}
    grads = [{k: rng.normal(0, 1e-2, s).astype(np.float32) for k, (s, _) in OPT_SHAPES.items()}
             for _ in range(steps)]

    def to_flax(tree):
        return {k: jnp.asarray(v.transpose(OPT_SHAPES[k][1])) for k, v in tree.items()}

    tx = jax_build_optimizer(dict(cfg))
    jp = to_flax(p0)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, _ = build_optimizer(dict(cfg), tp.values())
    for g in grads:
        updates, jstate = tx.update(to_flax(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    pairs = {k: (np.asarray(jp[k]).transpose(np.argsort(OPT_SHAPES[k][1])), tp[k].detach().numpy())
             for k in tp}
    return jstate, opt, tp, pairs


def assert_params_close(pairs):
    for k, (want, got) in pairs.items():
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k


@pytest.mark.parametrize("target", ["torch.optim.AdamW", "adam"])
def test_adam_bf16_moments_match_optax(target):
    cfg = {"_target_": target, "lr": 1e-2, "weight_decay": 1e-2, "mu_dtype": "bfloat16",
           "nu_dtype": "bfloat16"}
    jstate, opt, tp, pairs = run_optimizers(cfg)
    assert_params_close(pairs)
    adam_state = next(s for s in jstate if hasattr(s, "mu"))
    for k, p in tp.items():
        st = opt.state[p]
        assert st["mu"].dtype == st["nu"].dtype == torch.bfloat16 and st["step"] == 5
        perm = np.argsort(OPT_SHAPES[k][1])
        for name in ("mu", "nu"):
            want = np.asarray(getattr(adam_state, name)[k].astype(jnp.float32)).transpose(perm)
            np.testing.assert_array_equal(st[name].float().numpy(), want, err_msg=f"{k} {name}")


def test_adam_bf16_moments_survive_a_checkpoint():
    """torch casts loaded optimizer state to each param's type; the moments
    stay bf16 and the resumed updates are the uninterrupted ones."""
    _, opt, tp, _ = run_optimizers({"lr": 1e-2, "mu_dtype": "bfloat16",
                                    "nu_dtype": "bfloat16"}, steps=2)
    params = [torch.nn.Parameter(p.detach().clone()) for p in tp.values()]
    opt2, _ = build_optimizer({"lr": 1e-2, "mu_dtype": "bfloat16", "nu_dtype": "bfloat16"},
                              params)
    opt2.load_state_dict(opt.state_dict())
    for p, q in zip(tp.values(), params):
        for name in ("mu", "nu"):
            assert opt2.state[q][name].dtype == torch.bfloat16
            assert torch.equal(opt2.state[q][name], opt.state[p][name])


@pytest.mark.parametrize("extra", [
    {}, {"weight_decay": 1e-2}, {"momentum": 0.9}, {"multiply_by_parameter_scale": True},
    {"weight_decay": 1e-2, "momentum": 0.9, "multiply_by_parameter_scale": True,
     "decay_rate": 0.7, "eps": 1e-20},
], ids=["plain", "weight_decay", "momentum", "param_scale", "all"])
def test_adafactor_matches_optax(extra):
    _, opt, tp, pairs = run_optimizers({"_target_": "adafactor", "lr": 1e-2, **extra})
    assert_params_close(pairs)
    assert factored_dims(tp["conv"].shape) == (1, 0) and factored_dims(tp["linear"].shape) == (1, 0)
    assert factored_dims(tp["small"].shape) is None and factored_dims(tp["bias"].shape) is None
    st = opt.state[tp["conv"]]
    assert st["v_row"].shape == (160, 3, 3) and st["v_col"].shape == (256, 3, 3)
    assert "v" in opt.state[tp["small"]] and st["step"] == 5


@pytest.mark.parametrize("target,knob", [("adafactor", "mu_dtype"), ("sgd", "nu_dtype")])
def test_state_dtypes_off_adam_raise(target, knob):
    cfg = {"_target_": target, "lr": 1e-3, knob: "bfloat16"}
    with pytest.raises(ValueError, match="Adam-state options"):
        jax_build_optimizer(cfg)
    with pytest.raises(ValueError, match="Adam-state options"):
        build_optimizer(cfg, [torch.nn.Parameter(torch.ones(1))])


def sd_knob_draws(key, loss_fn, noise_offset, input_perturbation):
    """``jax_draws`` plus the JAX step's offset and perturbation draws."""
    draws = jax_draws(key, loss_fn, (HW, HW, C))
    offset, perturb = [], []
    for k in jax.random.split(key, A):
        _, _, _, k_offset, k_perturb = jax.random.split(k, 5)
        offset.append(jax.random.normal(k_offset, (MB, 1, 1, C)))
        perturb.append(jax.random.normal(k_perturb, (MB, HW, HW, C)))
    if noise_offset:
        draws["offset"] = torch.from_numpy(np.array(jnp.stack(offset)))
    if input_perturbation:
        draws["perturb"] = torch.from_numpy(np.array(jnp.stack(perturb)))
    return draws


def tiny_eps_step(step_kw, seed=0):
    """One SGD step of both packages on TinyEps; returns (jax state, jax
    metrics, port model, port metrics, initial params)."""
    kw = dict(loss_params=(("lambd", 0.5),), scaling_norm=3.0, grad_accum_steps=A, **step_kw)
    params = tiny_params(seed, channels=C)
    rng = np.random.default_rng(seed + 1)
    batch = {k: rng.normal(size=(A, MB, HW, HW, C)).astype(np.float32) for k in ("all", "deletion")}
    key = jax.random.PRNGKey(7)
    tx = optax.sgd(1.0)
    jstep = jax.jit(jax_build_step(jax_tiny_apply, JaxSchedule.create(1000, "linear"), tx,
                                   JaxStepConfig(**kw)))
    jstate, jm = jstep(JaxState.create(jax.tree.map(jnp.asarray, params), tx),
                       {k: jnp.asarray(v) for k, v in batch.items()}, key, {})
    model = TinyEps(params)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(tiny_apply, NoiseSchedule.create(1000, device="cpu"),
                                     DeletionStepConfig(**kw))
    draws = sd_knob_draws(key, kw.get("loss_fn"), kw.get("noise_offset", 0.0),
                          kw.get("input_perturbation", 0.0))
    _, m = step(TrainState.create(model, opt, sched),
                {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    return jstate, jm, model, m, params


@pytest.mark.parametrize("step_kw", [
    dict(noise_offset=0.1), dict(input_perturbation=0.1),
    dict(noise_offset=0.1, input_perturbation=0.1, fused_siss=False),
    dict(noise_offset=0.1, loss_fn="erasediff"),
], ids=["noise_offset", "input_perturbation", "both_unfused", "noise_offset_erasediff"])
def test_noise_knobs_match_jax(step_kw):
    jstate, jm, model, m, _ = tiny_eps_step(step_kw)
    assert_metrics_match(m, jm)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_noise_knobs_leave_the_fused_path():
    """Either knob sends SISS down the unfused path, as the JAX step does."""
    assert DeletionStepConfig().is_fused_siss
    assert not DeletionStepConfig(noise_offset=0.1).is_fused_siss
    assert not DeletionStepConfig(input_perturbation=0.1).is_fused_siss
    draws = draw_microbatch_randomness(torch.Generator().manual_seed(0), A, MB, (HW, HW, C), 0,
                                       1000, "cpu", noise_offset=True, input_perturbation=True)
    assert draws["offset"].shape == (A, MB, 1, 1, C)
    assert draws["perturb"].shape == (A, MB, HW, HW, C)


def assert_updates_close(pairs, p0):
    """Each param's update within 2⁻⁷ of its tensor's largest update."""
    for name, (got, want) in pairs.items():
        du_got, du_want = got - p0[name], want - p0[name]
        assert np.abs(du_got - du_want).max() <= 2 ** -7 * np.abs(du_want).max(), name


def test_bf16_grad_accumulators_match_jax():
    jstate, jm, model, m, p0 = tiny_eps_step(dict(grad_accum_dtype="bfloat16"))
    for k in ("gradient/norm_loss_x", "gradient/norm_loss_a", "gradient/pre_clip_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2 ** -7, err_msg=k)
    assert_updates_close({n: (p.detach().numpy(), np.asarray(jstate.params[n]))
                          for n, p in model.named_parameters()}, p0)


SD_HW, SD_CTX = 8, (7, 32)
SD_KW = dict(loss_fn="importance_sampling_with_mixture", loss_params=(("lambd", 0.5),),
             scaling_norm=750.0, grad_accum_steps=A, t_min=999, t_max=1000)


def test_param_cast_matches_jax():
    """bf16 copies of the fp32 params, once a step, on the tiny conditional
    UNet computing in fp32 (flax promotes the bf16 params; the port
    upcasts them): the same step as JAX's."""
    fmodel = FlaxUNet(FlaxConfig(**dict(UNet2DConditionConfig.tiny().__dict__,
                                        attention_impl="einsum")))
    params = jax.jit(functools.partial(fmodel.init_params, batch_size=MB,
                                       context_len=SD_CTX[0]))(jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    batch = {k: rng.normal(size=(A, MB, SD_HW, SD_HW, 4)).astype(np.float32)
             for k in ("all", "deletion")}
    batch["conditioning"] = rng.normal(size=(A, MB) + SD_CTX).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(SD_KW, param_cast_dtype="bfloat16")
    tx = optax.sgd(1.0)
    jstep = jax.jit(jax_build_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t, c),
                                   jax_sd_schedule(), tx, JaxStepConfig(**kw)))
    jstate, jm = jstep(JaxState.create(params, tx), {k: jnp.asarray(v) for k, v in batch.items()},
                       key, {})
    model = UNet2DCondition(UNet2DConditionConfig.tiny())
    p0 = params_from_flax(jax.tree.map(np.asarray, params))
    model.load_state_dict(p0)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(cond_unet_eps_apply, sd_noise_schedule(device="cpu"),
                                     DeletionStepConfig(**kw))
    draws = jax_draws(key, None, (SD_HW, SD_HW, 4), 999, 1000)
    _, m = step(TrainState.create(model, opt, sched),
                {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    for k in ("gradient/norm_loss_x", "gradient/norm_loss_a", "gradient/pre_clip_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2 ** -7, err_msg=k)
    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = model.state_dict()
    assert_updates_close({k: (got[k].numpy(), want[k].numpy()) for k in want},
                         {k: v.numpy() for k, v in p0.items()})
    assert all(p.dtype == torch.float32 for p in model.parameters())


def flash_unet(**kw):
    cfg = dataclasses.replace(UNet2DConditionConfig.tiny(), sample_size=16,
                              attention_impl="flash", **kw)
    return UNet2DCondition(cfg)


def one_step_params(model_kw, step_kw, channels_last=False):
    """The tiny flash UNet after one SGD step from fixed weights, batch and
    draws (the same draws whatever the knobs)."""
    torch.manual_seed(0)
    model = flash_unet(**model_kw)
    if channels_last:
        model = model.to(memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randn(A, MB, 16, 16, 4, generator=gen) for k in ("all", "deletion")}
    batch["conditioning"] = torch.randn((A, MB) + SD_CTX, generator=gen)
    draws = draw_microbatch_randomness(gen, A, MB, (16, 16, 4), 999, 1000, "cpu")
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(cond_unet_eps_apply, sd_noise_schedule(device="cpu"),
                                     DeletionStepConfig(**dict(SD_KW, **step_kw)))
    _, m = step(TrainState.create(model, opt, sched), batch, draws=draws)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, m


@pytest.mark.parametrize("model_kw,step_kw,channels_last", [
    ({}, {}, True),
    ({}, dict(fused_siss=False), False),
    (dict(gradient_checkpointing=True, remat_attention=True), {}, False),
    (dict(gradient_checkpointing=True, remat_attention=True, remat_policy="dots"), {}, True),
], ids=["fused", "unfused", "remat", "remat_dots_channels_last"])
def test_batched_dual_backward_equals_two_pulls(model_kw, step_kw, channels_last):
    want, wm = one_step_params(model_kw, step_kw, channels_last)
    got, gm = one_step_params(model_kw, dict(step_kw, batched_dual_backward=True), channels_last)
    for k in ("gradient/norm_loss_x", "gradient/norm_loss_a", "gradient/pre_clip_norm"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, err_msg=k)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-7, msg=k)


def test_batched_flash_backward_hands_the_kernels_their_layout(monkeypatch):
    """The folded operands of a batched pull meet the CUDA wrappers' rules
    (contiguous fp32 lse and di, a unit-stride head dim), B = 1 included,
    and give each seed its own gradient."""
    from siss_tpu_torch.ops import flash_attention as fa

    seen = []
    for name in ("flash_bwd_dkv_plain", "flash_bwd_dq_plain"):
        plain = getattr(fa, name)

        def checked(q, k, v, lse, do, di, scale, _plain=plain):
            seen.append(q.shape[0])
            assert lse.is_contiguous() and di.is_contiguous()
            assert all(t.stride(-1) == 1 for t in (q, k, v, do))
            return _plain(q, k, v, lse, do, di, scale)
        monkeypatch.setattr(fa, name, checked)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 128, 2 * 8, generator=gen, requires_grad=True)
    q = x.reshape(1, 128, 2, 8).transpose(1, 2)
    out = fa.flash_attention(q, q * 0.5, q * 2.0, 0.3)
    cots = torch.randn((2,) + out.shape, generator=gen)
    (both,) = torch.autograd.grad(out, x, cots, retain_graph=True, is_grads_batched=True)
    assert seen == [2, 2]
    for s in range(2):
        (one,) = torch.autograd.grad(out, x, cots[s], retain_graph=True)
        torch.testing.assert_close(both[s], one, rtol=1e-6, atol=1e-7)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def backward_ops(**model_kw):
    """(the gradients of a tiny UNet's squared output, the aten ops its
    backward ran)."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(UNet2DConditionConfig.tiny(), sample_size=16,
                              attention_impl="einsum", remat_attention=True, **model_kw)
    model = UNet2DCondition(cfg)
    gen = torch.Generator().manual_seed(2)
    out = model(torch.randn(2, 4, 16, 16, generator=gen), torch.full((2,), 999),
                torch.randn((2,) + SD_CTX, generator=gen))
    with _CountOps() as ops:
        grads = torch.autograd.grad((out ** 2).sum(), list(model.parameters()))
    return grads, ops.counts


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_remat_policies_keep_the_gradients(policy):
    want, plain = backward_ops()
    got, ops = backward_ops(gradient_checkpointing=True, remat_policy=policy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert plain.get("convolution", 0) == 0
    recomputed = {k: ops.get(k, 0) - plain.get(k, 0) for k in ("convolution", "addmm", "bmm")}
    # Full recomputation runs every saved-op again; "dots" saves the matmuls
    # and convolutions; "dots_no_batch" saves the linear layers only.
    expect_none = {None: set(), "dots": {"convolution", "addmm", "bmm"},
                   "dots_no_batch": {"addmm"}}[policy]
    for k, n in recomputed.items():
        assert (n == 0) == (k in expect_none), (policy, recomputed)
