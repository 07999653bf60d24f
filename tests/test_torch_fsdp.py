"""The fsdp axis of the port (siss_tpu_torch.parallel.fsdp) on gloo ranks on
the CPU, against one process and against the JAX step.

(a) ``fsdp_dim`` splits, for every parameter of the full-width celeb, SD
    and t-shirt UNets at fsdp 2 and 4, the torch dimension of the flax axis
    that JAX's ``_fsdp_spec`` splits (the trees from ``jax.eval_shape``, the
    torch modules on the meta device).
Two worlds (tests/torch_fsdp_worker.py, spawned once for the module, side
by side): ``data=1 × fsdp=2`` on two ranks and ``data=2 × fsdp=2`` on four.
Each runs every case of tests/torch_fsdp_cases.py (fused SISS with AdamW and
EMA, unfused SISS, EraseDiff, NegGrad (the scalar path), the batched dual
backward, Adafactor with EMA; on the tiny conditional UNet the flash path,
bf16 ``param_cast_dtype``, bf16 ``grad_accum_dtype`` and
``remat_policy=dots``; the pretrain step) on its rows of each global
batch. Checks:

(b) the ranks' gathered parameters and EMA are bit for bit equal; against
    the one-process step on the global batch at the data-parallel
    tolerances (tests/test_torch_parallel.py: params rtol 1e-5 / atol 1e-7
    after SGD, atol 0.25·lr after AdamW or Adafactor, metrics rtol 1e-5,
    importance weights rtol 1e-3 / atol 1e-6), and against the JAX step at
    the one-process parity tolerances (rtol 1e-4; params atol 1e-6 after
    SGD, 0.25·lr after AdamW or Adafactor); the bf16 cases' norms rtol 2⁻⁷
    and each parameter's update within 2⁻⁷ of its tensor's largest update,
    against both (tests/test_torch_sd_options.py);
(c) a whole leaf that carries ~99.9% of ‖g_a‖ is counted once in every sum
    of the surgery (‖g_x‖, ‖g_a‖, ⟨g_x, g_a⟩, the clip's norm): rtol 1e-6
    against one process, where counting it R times is off by ~√R;
(d) each rank holds 1/fsdp of every split parameter's elements, of its
    EMA, optimizer state and both accumulators, and all of a whole one's;
(e) a checkpoint saved on the fsdp ranks is the one-process format: one
    process loads it, holds each rank's blocks bit for bit and saves it
    back unchanged; a one-process checkpoint loads on the fsdp ranks as
    their blocks, bit for bit, and the next step equals one process's as (b);
(f) samples and a denoising injection from the gathered UNet equal one
    process's within 1e-5;
and the groups, the gather and the reduce-scatter along each dimension, in
both forms: the all-reduce form that gloo runs on CUDA tensors and the NCCL
form (``all_gather_into_tensor``, ``reduce_scatter_tensor``), selected on
the gloo ranks by patching ``multihost._native_collectives``.
"""

import functools
import os
import subprocess
import sys
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_objectives as objectives
import test_torch_pretrain_step as pretrain
import test_torch_train_step as train_step
import torch_fsdp_cases as cases
from test_torch_parallel import assert_metrics_close
from torch_parity import flax_unet, torch_unet
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.models.unet2d import UNet2D as FlaxUNet
from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxCondUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxCondConfig
from siss_tpu.parallel.mesh import _fsdp_spec
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu.train import build_pretrain_step as jax_build_pretrain_step
from siss_tpu.train.optim import build_optimizer as jax_build_optimizer
from siss_tpu_torch.config import load_config, to_dict
from siss_tpu_torch.models import UNet2D, UNet2DCondition, UNet2DConditionConfig, UNet2DConfig
from siss_tpu_torch.parallel import fsdp_dim, shard_module
from siss_tpu_torch.train.step import DeletionStepConfig, _surgery, global_norm
from siss_tpu_torch.utils import CheckpointManager
from siss_tpu_torch.utils.convert import params_from_flax, torch_key

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = {"fsdp2": (1, 2), "data2_fsdp2": (2, 2)}   # name -> (data, fsdp)
JOIN_TIMEOUT_S = 300
JAX_KEYS = (jax.random.PRNGKey(100), jax.random.PRNGKey(101))
PRETRAIN_KEY = jax.random.PRNGKey(3)
ADAPTIVE = (cases.ADAMW, cases.ADAFACTOR)


# (a) ------------------------------------------------------------------------

class _FakeMesh:
    """What ``_fsdp_spec`` reads of a mesh."""

    def __init__(self, n):
        self.shape = {"fsdp": n}


def _tshirt_kwargs():
    node = to_dict(load_config("train_tshirt_mnist", [], os.path.join(ROOT, "configs")).unet)
    node.pop("_target_")
    return {k: tuple(v) if isinstance(v, list) else v for k, v in node.items()}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(flax param shapes, torch module on the meta device)."""
    if name == "celeb":
        flax = FlaxUNet(FlaxConfig.celebahq_256())
        make = lambda: UNet2D(UNet2DConfig.celebahq_256())  # noqa: E731
    elif name == "tshirt":
        flax = FlaxUNet(FlaxConfig(**_tshirt_kwargs()))
        make = lambda: UNet2D(UNet2DConfig(**_tshirt_kwargs()))  # noqa: E731
    else:
        flax = FlaxCondUNet(FlaxCondConfig.sd_v1())
        make = lambda: UNet2DCondition(UNet2DConditionConfig.sd_v1())  # noqa: E731
    shapes = jax.eval_shape(flax.init_params, jax.random.PRNGKey(0))
    with torch.device("meta"):
        return shapes, make()


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v.shape


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["celeb", "sd", "tshirt"])
def test_fsdp_dim_matches_jax_on_every_leaf(model, n):
    shapes, module = _models(model)
    params = dict(module.named_parameters())
    mesh = _FakeMesh(n)
    seen, split = 0, 0
    for path, shape in _flax_leaves(shapes):
        spec = tuple(_fsdp_spec(shape, mesh))
        flax_axis = spec.index("fsdp") if "fsdp" in spec else None
        p = params[torch_key(path)]
        torch_of_flax = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(shape), tuple(range(len(shape))))
        if path[-1] != "kernel":
            torch_of_flax = tuple(range(len(shape)))
        assert tuple(p.shape) == tuple(shape[a] for a in np.argsort(torch_of_flax)), path
        want = None if flax_axis is None else torch_of_flax[flax_axis]
        assert fsdp_dim(p.shape, n) == want, (path, shape, spec)
        seen += 1
        split += want is not None
    assert seen == len(params) and split > 0


# the worlds ---------------------------------------------------------------

def _jax_draws(name):
    _, steps, kw = cases.CASES[name]
    shape = (cases.COND_HW, cases.COND_HW, cases.COND_C) if cases.is_cond(name) else (
        cases.HW, cases.HW, 3)
    return [objectives.jax_draws(k, kw["loss_fn"], shape) for k in JAX_KEYS[:steps]]


def _flax_cond():
    """(flax module, params) of the conditional UNet's cases (einsum: JAX's
    flash kernel runs only on a TPU)."""
    fmodel = FlaxCondUNet(FlaxCondConfig(**dict(cases.COND, attention_impl="einsum")))
    return fmodel, jax.jit(functools.partial(fmodel.init_params, batch_size=cases.MB,
                                             context_len=cases.CTX[0]))(jax.random.PRNGKey(7))


def _jax_run(name, flax_models, inputs):
    """The JAX step of a case on the global batch: (state, metrics)."""
    opt_cfg, steps, kw = cases.CASES[name]
    fmodel, fparams = flax_models["cond" if cases.is_cond(name) else "unet"]
    if cases.is_cond(name):
        def apply(p, x, t, c):
            return fmodel.apply({"params": p}, x, t, c)
    else:
        def apply(p, x, t, c):
            return fmodel.apply({"params": p}, x, t)
    tx = jax_build_optimizer(dict(opt_cfg))
    jstep = jax.jit(jax_build_step(apply, JaxSchedule.create(1000, "linear"), tx,
                                   JaxStepConfig(**kw)))
    jstate = JaxState.create(fparams, tx, use_ema=kw.get("use_ema", False))
    batch = {k: jnp.asarray(v.numpy()) for k, v in inputs[name]["batch"].items()}
    metrics = []
    for key in JAX_KEYS[:steps]:
        jstate, jm = jstep(jstate, batch, key, {})
        metrics.append({k: float(v) for k, v in jm.items()})
    return jstate, metrics


def _jax_pretrain(fmodel, fparams, inputs):
    tx = jax_build_optimizer(dict(cases.SGD))
    jstep = jax.jit(jax_build_pretrain_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
                                            JaxSchedule.create(1000, "linear"), tx))
    batch = jnp.asarray(inputs["pretrain"]["batch"].numpy())
    return jstep(JaxState.create(fparams, tx), batch, PRETRAIN_KEY)


def _references(inputs, flax_models):
    """Everything the ranks are held to: one process's and JAX's runs (the
    JAX steps compiled in threads: XLA's compiler releases the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        jax_runs = {("jax", name): pool.submit(_jax_run, name, flax_models, inputs)
                    for name in cases.CASES}
        jax_runs["jax", "pretrain"] = pool.submit(_jax_pretrain, *flax_models["unet"], inputs)
        refs = {name: cases.run_case(name, inputs) for name in cases.CASES}
        for name in cases.CHECKPOINT_CASES:
            refs["resumed", name] = cases.run_case(name, inputs, start=1,
                                                   state_dict=inputs["resume"][name])
        refs["pretrain"] = cases.run_pretrain(inputs)
        for name in cases.EVAL_CASES:
            refs["eval", name] = cases.run_evaluator(name, inputs)
        refs.update({k: f.result() for k, f in jax_runs.items()})
    return refs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, the references, {world: one result per rank}, directory).
    The references are computed while the ranks run."""
    d = tmp_path_factory.mktemp("fsdp")
    fmodel, fparams, np_params = flax_unet(cases.FSDP_UNET, seed=2)
    flax_models = {"unet": (fmodel, fparams), "cond": _flax_cond()}
    draws = {name: _jax_draws(name) for name in cases.CASES}
    draws["pretrain"] = pretrain.jax_draws(PRETRAIN_KEY, (cases.MB, cases.HW, cases.HW, 3))
    cond_state = params_from_flax(jax.tree.map(np.asarray, flax_models["cond"][1]))
    inputs = cases.make_inputs(torch_unet(cases.FSDP_UNET, np_params).state_dict(), draws,
                               cond_state)
    inputs["resume"] = {name: cases.run_case(name, inputs, stop=1)["state"]
                        for name in cases.CHECKPOINT_CASES}
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = {}
    try:
        for world, (data, fsdp) in WORLDS.items():
            (d / world).mkdir()
            n = data * fsdp
            procs[world] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_fsdp_worker.py"), str(r), str(n),
                 str(data), str(fsdp), str(d / world)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env) for r in range(n)]
        refs = _references(inputs, flax_models)
        outs = {world: [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in ps]
                for world, ps in procs.items()}
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for world, ps in procs.items():
        for p, out in zip(ps, outs[world]):
            assert p.returncode == 0, out[-4000:]
    results = {world: [torch.load(d / world / f"rank{r}.pt", weights_only=False)
                       for r in range(data * fsdp)]
               for world, (data, fsdp) in WORLDS.items()}
    return inputs, refs, results, d


def _assert_params_close(got, want, adaptive, lr):
    atol = 0.25 * lr if adaptive else 1e-7
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=atol, err_msg=k)


def test_mesh_groups(setup):
    _, _, results, _ = setup
    for world, (data, fsdp) in WORLDS.items():
        for r, res in enumerate(results[world]):
            c = res["collectives"]
            assert c["fsdp_rank"] == r % fsdp
            row = r // fsdp * fsdp
            assert c["fsdp_members"] == sum(2.0 ** q for q in range(row, row + fsdp))
            assert c["data_members"] == sum(2.0 ** (q * fsdp + r % fsdp) for q in range(data))


@pytest.mark.parametrize("world", list(WORLDS))
def test_nccl_form_equals_the_all_reduce_form(setup, world):
    """The NCCL form of the gather and the reduce-scatter
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``: the branch that
    runs on the card), chosen through ``multihost._native_collectives`` on
    gloo ranks, gives the all-reduce form's tensors bit for bit."""
    _, _, results, _ = setup
    for res in results[world]:
        a, b = res["collectives"], res["native"]
        assert a.keys() == b.keys()
        for k in ("gathered", "scattered"):
            assert len(a[k]) == len(b[k]) == len(cases.COLLECTIVE_SHAPES) + (k == "scattered")
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        assert torch.equal(a["scattered_bf16"], b["scattered_bf16"])
        assert a["gathered_channels_last"] == b["gathered_channels_last"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_gather_and_reduce_scatter(setup, world):
    _, _, results, _ = setup
    data, fsdp = WORLDS[world]
    shapes = cases.COLLECTIVE_SHAPES
    fulls = [cases.whole(s, seed=i) for i, (s, _, _) in enumerate(shapes)]
    for r, res in enumerate(results[world]):
        c = res["collectives"]
        for got, want in zip(c["gathered"], fulls):
            assert torch.equal(got, want)
        assert c["gathered_channels_last"] == [False, True, True, False, False]
        row = r // fsdp * fsdp
        scale = sum(q + 1 for q in range(row, row + fsdp))
        me = r % fsdp
        for got, want, (_, dim, _) in zip(c["scattered"], fulls, shapes):
            size = want.shape[dim] // fsdp
            torch.testing.assert_close(got, 1 + scale * want.narrow(dim, me * size, size),
                                       rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(c["scattered"][-1], 1 + scale * cases.whole((5,), seed=9),
                                   rtol=1e-6, atol=1e-6)
        bf = (cases.whole((8, 6), torch.bfloat16, seed=7).float() * scale).narrow(
            0, me * 8 // fsdp, 8 // fsdp)
        torch.testing.assert_close(c["scattered_bf16"].float(), bf, rtol=2 ** -7, atol=1e-2)


# (c) ------------------------------------------------------------------------

@pytest.mark.parametrize("world", list(WORLDS))
def test_a_whole_leaf_is_counted_once(setup, world):
    _, _, results, _ = setup
    sharding = shard_module(cases.Leaves())
    for loss_fn in ("importance_sampling_with_mixture", "erasediff"):
        g_x, g_a = cases.surgery_trees()
        norm_a = float(global_norm(g_a))
        metrics = {}
        final, pre = _surgery(DeletionStepConfig(loss_fn=loss_fn, scaling_norm=5.0, eta=10.0),
                              sharding, g_x, g_a, metrics)
        twice = float(torch.sqrt(sum(t.square().sum() for t in g_a) + g_a[1].square().sum()))
        assert abs(twice - norm_a) > 0.3 * norm_a  # the whole leaf dominates
        for res in results[world]:
            got = res["norms"]
            np.testing.assert_allclose(got[f"norm_a_{loss_fn}"], norm_a, rtol=1e-6)
            for k, v in metrics.items():
                np.testing.assert_allclose(got[loss_fn]["metrics"][k], float(v), rtol=1e-6,
                                           atol=1e-9, err_msg=k)
            np.testing.assert_allclose(got[loss_fn]["pre_clip_norm"], float(pre), rtol=1e-6)
            for a, b in zip(got[loss_fn]["final"], final):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


# (b) ------------------------------------------------------------------------

CASE_WORLDS = [(w, n) for w in WORLDS for n in cases.CASES]


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_ranks_stay_bit_equal(setup, world, name):
    _, _, results, _ = setup
    ranks = results[world]
    assert all(res["equal"][name] for res in ranks)
    assert all(res["steps"][name]["metrics"] == ranks[0]["steps"][name]["metrics"]
               for res in ranks)


NORMS = ("gradient/norm_loss_x", "gradient/norm_loss_a", "gradient/pre_clip_norm")


def _assert_bf16_step_close(got, metrics, params, p0):
    """A bf16 case's one SGD step against ``metrics`` and ``params``: the
    norms rtol 2⁻⁷, each parameter's update within 2⁻⁷ of its tensor's
    largest update (tests/test_torch_sd_options.py: two bf16 ulps)."""
    for k in NORMS:
        np.testing.assert_allclose(got["metrics"][0][k], metrics[k], rtol=2 ** -7, err_msg=k)
    assert got["model"].keys() == params.keys()
    for k, want in params.items():
        du_got, du_want = got["model"][k] - p0[k], want - p0[k]
        assert (du_got - du_want).abs().max() <= 2 ** -7 * du_want.abs().max(), k


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_fsdp_equals_one_process(setup, world, name):
    inputs, refs, results, _ = setup
    one = refs[name]
    got = results[world][0]["steps"][name]
    if name in cases.BF16_CASES:
        _assert_bf16_step_close(got, one["metrics"][0], one["state"]["model"], inputs["cond"])
        return
    for m, want in zip(got["metrics"], one["metrics"]):
        assert_metrics_close(m, want, rtol=1e-5)
    opt_cfg, steps, _ = cases.CASES[name]
    assert len(got["metrics"]) == steps
    adaptive = opt_cfg in ADAPTIVE
    _assert_params_close(got["model"], one["state"]["model"], adaptive, opt_cfg["lr"])
    if got["ema"] is not None:
        _assert_params_close(got["ema"], one["state"]["ema"]["params"], adaptive, opt_cfg["lr"])


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_fsdp_matches_jax(setup, world, name):
    inputs, refs, results, _ = setup
    jstate, jmetrics = refs["jax", name]
    got = results[world][0]["steps"][name]
    if name in cases.BF16_CASES:
        _assert_bf16_step_close(got, jmetrics[0],
                                params_from_flax(jax.tree.map(np.asarray, jstate.params)),
                                inputs["cond"])
        return
    for m, jm in zip(got["metrics"], jmetrics):
        assert_metrics_close(m, jm, rtol=1e-4)
    opt_cfg = cases.CASES[name][0]
    atol = 0.25 * opt_cfg["lr"] if opt_cfg in ADAPTIVE else 1e-6
    train_step.assert_params_match(got["model"], jstate.params, rtol=1e-4, atol=atol)
    if got["ema"] is not None:
        train_step.assert_params_match(got["ema"], jstate.ema.params, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("world", list(WORLDS))
def test_pretrain_step_equals_one_process_and_jax(setup, world):
    _, refs, results, _ = setup
    ranks = results[world]
    got = ranks[0]["pretrain"]
    for res in ranks[1:]:
        assert res["pretrain"]["metrics"] == got["metrics"]
        assert all(torch.equal(res["pretrain"]["params"][k], v) for k, v in got["params"].items())
    one = refs["pretrain"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    _assert_params_close(got["params"], one["params"], False, 1.0)
    jstate, jm = refs["jax", "pretrain"]
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, err_msg=k)
    train_step.assert_params_match(got["params"], jstate.params, rtol=1e-4, atol=1e-6)


# (d) ------------------------------------------------------------------------

@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_its_share(setup, world):
    _, refs, results, _ = setup
    fsdp = WORLDS[world][1]
    for name in ("siss_adamw_ema", "adafactor", "simple_neg_del"):
        one = refs[name]["held"]
        for res in results[world]:
            held = res["steps"][name]["held"]
            sharding = shard_module(UNet2D(UNet2DConfig(**cases.FSDP_UNET)), None)
            dims = [fsdp_dim(s, fsdp) for s in sharding.full_shapes]
            assert sum(d is not None for d in dims) == 28
            share = [1 if d is None else fsdp for d in dims]
            assert [n * s for n, s in zip(held["param"], share)] == one["param"]
            if one["ema"] is not None:
                assert [n * s for n, s in zip(held["ema"], share)] == one["ema"]
            for acc, acc_one in zip(held["accumulators"], one["accumulators"]):
                assert [n * s for n, s in zip(acc, share)] == acc_one
            assert len(held["accumulators"]) == len(one["accumulators"]) > 0
            for st, st_one, dim, shape in zip(held["optimizer"], one["optimizer"], dims,
                                              sharding.full_shapes):
                assert st.keys() == st_one.keys()
                for k, n in st.items():
                    # Adafactor's row (col) statistics are whole when they
                    # drop the split dimension.
                    assert n * fsdp == st_one[k] or (dim is None or k in ("v_row", "v_col")) \
                        and n == st_one[k], (k, shape)
            split = sum(n for n, d in zip(one["param"], dims) if d is not None)
            whole = sum(one["param"]) - split
            assert held["bytes"]["params"] == 4 * (split // fsdp + whole)


# (e) ------------------------------------------------------------------------

def _assert_blocks(blocks, state_dict, world, r):
    """``blocks`` (a rank's own tensors) are the rank's blocks of the whole
    ``state_dict``, bit for bit."""
    data, fsdp = WORLDS[world]
    ref = cases.build_state(cases.CHECKPOINT_CASES[0], state_dict["model"])
    names = ref.sharding.names
    dims = [fsdp_dim(s, fsdp) for s in ref.sharding.full_shapes]

    def block(t, d):
        if d is None:
            return t
        size = t.shape[d] // fsdp
        return t.narrow(d, (r % fsdp) * size, size)

    for name, d, got in zip(names, dims, blocks["params"]):
        assert torch.equal(got, block(state_dict["model"][name], d)), name
    if blocks["ema"] is not None:
        for name, d, got in zip(names, dims, blocks["ema"]):
            assert torch.equal(got, block(state_dict["ema"]["params"][name], d)), name
    whole_state = state_dict["optimizer"]["state"]
    for i, (d, shape, st) in enumerate(zip(dims, ref.sharding.full_shapes, blocks["optimizer"])):
        for k, v in st.items():
            want = whole_state[i][k]
            if isinstance(v, torch.Tensor) and d is not None:
                from siss_tpu_torch.train.optim import state_split_dim

                want = block(want, state_split_dim(k, want, d, shape))
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, want), (i, k)
            else:
                assert v == want, (i, k)


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in cases.CHECKPOINT_CASES])
def test_checkpoint_from_fsdp_ranks_loads_in_one_process(setup, world, name):
    inputs, _, results, d = setup
    mgr = CheckpointManager(str(d / world / "ckpt" / name))
    sd = mgr.restore_item("latest", "state")
    assert sd["step"] == cases.CASES[name][1]
    state = cases.build_state(name, inputs["unet"])
    state.load_state_dict(sd)
    back = state.state_dict()
    for k, v in sd["model"].items():
        assert torch.equal(back["model"][k], v), k
    for k, v in sd["ema"]["params"].items():
        assert torch.equal(back["ema"]["params"][k], v), k
    for i, st in sd["optimizer"]["state"].items():
        for k, v in st.items():
            got = back["optimizer"]["state"][i][k]
            assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v, (i, k)
    for r, res in enumerate(results[world]):
        _assert_blocks(res["steps"][name]["blocks"], sd, world, r)


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in cases.CHECKPOINT_CASES])
def test_one_process_checkpoint_resumes_on_fsdp_ranks(setup, world, name):
    inputs, refs, results, _ = setup
    resume = inputs["resume"][name]
    for r, res in enumerate(results[world]):
        _assert_blocks(res["resumed"][name]["loaded"], resume, world, r)
    one = refs["resumed", name]
    got = results[world][0]["resumed"][name]
    for m, want in zip(got["metrics"], one["metrics"]):
        assert_metrics_close(m, want, rtol=1e-5)
    _assert_params_close(got["model"], one["state"]["model"], True, cases.CASES[name][0]["lr"])


# (f) ------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in cases.EVAL_CASES])
def test_evaluator_on_fsdp_ranks_equals_one_process(setup, world, name):
    _, refs, results, _ = setup
    one = refs["eval", name]
    assert one.shape == (cases.MB, cases.HW, cases.HW, 3)
    ranks = results[world]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["evaluator"][name], ranks[0]["evaluator"][name])
    np.testing.assert_allclose(ranks[0]["evaluator"][name], one, rtol=0, atol=1e-5)
