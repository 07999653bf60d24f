"""The tensor axis composed with the fsdp axis (``data × fsdp × tensor``) on
gloo ranks on the CPU, against one process and against the JAX step.

(a) ``param_dims`` gives, for every parameter of the full-width celeb, SD
    and t-shirt UNets at (fsdp, tensor) = (2, 2), (2, 4) and (4, 2), the
    torch dimensions of the flax axes that JAX's ``_param_spec`` gives to
    ``tensor`` and to ``fsdp`` (the trees from ``jax.eval_shape``, the
    torch modules on the meta device); at 2 × 2 the two-axis leaves and the
    elements a rank holds are counted.
Two worlds (tests/torch_tensor_fsdp_worker.py, spawned once for the module,
side by side): ``data=1 × fsdp=2 × tensor=2`` on four ranks and the JAX
package's ``data=2 × fsdp=2 × tensor=2`` on eight. They run the cases of
tests/torch_tensor_fsdp_cases.py (fused SISS with AdamW and EMA on the
single-head and the multi-head UNet2D, EraseDiff and the pretrain step on
the single-head one; on the conditional UNet with the flash path Adafactor
with EMA, whose factored dimensions are both split on 22 leaves, and bf16
``grad_accum_dtype``) on the rows of their batch coordinate. Checks:

(b) the ranks' gathered parameters, EMA and metrics are bit for bit equal;
    against the one-process step on the global batch and the JAX step at
    tests/test_torch_tensor.py's tolerances; the bf16 case by the bf16
    rule (tests/test_torch_fsdp.py), against both;
(c) the ranks of a data group hold bit-equal blocks, and each leaf's blocks
    over the fsdp × tensor plane assemble the whole (the fsdp blocks of
    each tensor block, then GEGLU's chunked tensor blocks);
(d) each rank holds its share of every parameter, its EMA, its optimizer
    state (Adafactor's factored statistics split over the axes that split
    the dimensions they keep) and both accumulators;
(e) a checkpoint saved on the mesh is the one-process format: one process
    loads it and saves it back unchanged, and it holds each rank's blocks
    bit for bit; a one-process checkpoint loads on the ranks as their
    blocks, bit for bit, and the next step equals one process's;
(f) samples and a denoising injection from the UNet gathered over both
    axes equal one process's within 1e-5;
and the groups, the fsdp × tensor plane's included.
"""

import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_objectives as objectives
import test_torch_pretrain_step as pretrain
import test_torch_train_step as train_step
import torch_tensor_fsdp_cases as cases
from test_torch_fsdp import _assert_bf16_step_close, _flax_leaves, _models
from test_torch_parallel import assert_metrics_close
from test_torch_tensor import _assert_metrics_close, _assert_params_close
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.models.unet2d import UNet2D as FlaxUNet
from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxCondUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxCondConfig
from siss_tpu.parallel.mesh import _param_spec
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu.train import build_pretrain_step as jax_build_pretrain_step
from siss_tpu.train.optim import build_optimizer as jax_build_optimizer
from siss_tpu_torch.parallel import Layout, param_dims
from siss_tpu_torch.train.optim import state_layout
from siss_tpu_torch.utils import CheckpointManager
from siss_tpu_torch.utils.convert import params_from_flax, torch_key

HERE = os.path.dirname(os.path.abspath(__file__))
JOIN_TIMEOUT_S = 400
JAX_KEYS = (jax.random.PRNGKey(300), jax.random.PRNGKey(301))
PRETRAIN_KEY = jax.random.PRNGKey(6)
ADAPTIVE = (cases.ADAMW, cases.ADAFACTOR)


# (a) ------------------------------------------------------------------------

class _FakeMesh:
    """What ``_param_spec`` and ``_fsdp_spec`` read of a mesh."""

    def __init__(self, fsdp, tensor):
        self.shape = {"data": 1, "fsdp": fsdp, "tensor": tensor}


# JAX's placement at fsdp 2 × tensor 2 (jax.eval_shape): leaves split over
# both axes, their elements, the elements a rank holds of the whole UNet.
TWO_AXIS_COUNTS = {"celeb": (120, 99_139_584, 32_212_483), "sd": (226, 756_449_280, 240_791_364)}


@pytest.mark.parametrize("fsdp,tensor", [(2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("model", ["celeb", "sd", "tshirt"])
def test_param_dims_match_jax_on_every_leaf(model, fsdp, tensor):
    shapes, module = _models(model)
    params = dict(module.named_parameters())
    mesh = _FakeMesh(fsdp, tensor)
    seen, two, two_elements, held = 0, 0, 0, 0
    for path, shape in _flax_leaves(shapes):
        spec = tuple(_param_spec(path, shape, mesh))
        key = torch_key(path)
        torch_of_flax = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(shape), tuple(range(len(shape))))
        if path[-1] != "kernel":
            torch_of_flax = tuple(range(len(shape)))
        want = tuple(torch_of_flax[spec.index(a)] if a in spec else None
                     for a in ("tensor", "fsdp"))
        got = param_dims(key.split("."), params[key].shape, fsdp, tensor)
        assert got == want, (path, shape, spec)
        seen += 1
        n = params[key].numel()
        two += None not in got
        two_elements += n if None not in got else 0
        held += n // ((tensor if got[0] is not None else 1) * (fsdp if got[1] is not None else 1))
    assert seen == len(params) and two > 0
    if (fsdp, tensor) == (2, 2) and model in TWO_AXIS_COUNTS:
        assert (two, two_elements, held) == TWO_AXIS_COUNTS[model]


# the worlds ---------------------------------------------------------------

def _flax_family(kind):
    """(flax module, params, whole torch weights) of a model kind: the flax
    init (jitted), carried over to torch."""
    if kind == "cond":
        fmodel = FlaxCondUNet(FlaxCondConfig(**dict(cases.COND, attention_impl="einsum")))
        init = functools.partial(fmodel.init_params, batch_size=cases.MB,
                                 context_len=cases.CTX[0])
    else:
        fmodel = FlaxUNet(FlaxConfig(**(cases.MULTI if kind == "multi" else cases.SINGLE)))
        init = fmodel.init_params
    fparams = jax.jit(init)(jax.random.PRNGKey(4))
    return fmodel, fparams, params_from_flax(jax.tree.map(np.asarray, fparams))


def _jax_run(name, flax_models, inputs):
    """The JAX step of a case on the global batch: (state, metrics)."""
    kind, opt_cfg, steps, kw = cases.CASES[name]
    fmodel, fparams, _ = flax_models[kind]
    if kind == "cond":
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


def _jax_pretrain(kind, flax_models, inputs):
    fmodel, fparams, _ = flax_models[kind]
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
        for kind in cases.PRETRAIN_KINDS:
            jax_runs["jax", "pretrain", kind] = pool.submit(_jax_pretrain, kind, flax_models,
                                                            inputs)
        refs = {name: cases.run_case(name, inputs) for name in cases.CASES}
        for name in cases.CHECKPOINT_CASES:
            refs["resumed", name] = cases.run_case(name, inputs, start=1,
                                                   state_dict=inputs["resume"][name])
        for kind in cases.PRETRAIN_KINDS:
            refs["pretrain", kind] = cases.run_pretrain(kind, inputs)
        for name in cases.EVAL_CASES:
            refs["eval", name] = cases.run_evaluator(name, inputs)
        refs.update({k: f.result() for k, f in jax_runs.items()})
    return refs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, the references, {world: one result per rank}, directory).
    The references are computed while the ranks run."""
    d = tmp_path_factory.mktemp("tensor_fsdp")
    with ThreadPoolExecutor(len(cases.MODELS)) as pool:
        flax_models = dict(zip(cases.MODELS, pool.map(_flax_family, cases.MODELS)))
    draws = {name: [objectives.jax_draws(k, kw["loss_fn"], cases.shape_of(kind))
                    for k in JAX_KEYS[:steps]]
             for name, (kind, _, steps, kw) in cases.CASES.items()}
    draws["pretrain"] = pretrain.jax_draws(PRETRAIN_KEY, (cases.MB, cases.HW, cases.HW, 3))
    inputs = cases.make_inputs({k: m[2] for k, m in flax_models.items()}, draws)
    inputs["resume"] = {name: cases.run_case(name, inputs, stop=1)["state"]
                        for name in cases.CHECKPOINT_CASES}
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = {}
    try:
        for world, (data, fsdp, tensor) in cases.WORLDS.items():
            (d / world).mkdir()
            n = data * fsdp * tensor
            procs[world] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_tensor_fsdp_worker.py"), str(r),
                 str(n), str(data), str(fsdp), str(tensor), str(d / world)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                for r in range(n)]
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
                       for r in range(data * fsdp * tensor)]
               for world, (data, fsdp, tensor) in cases.WORLDS.items()}
    return inputs, refs, results, d


CASE_WORLDS = [(w, n) for w in cases.WORLDS for n in cases.CASES]


def _coords(world, r):
    """(data, fsdp, tensor) coordinates of rank ``r`` of a world."""
    _, fsdp, tensor = cases.WORLDS[world]
    return r // (fsdp * tensor), r // tensor % fsdp, r % tensor


def test_mesh_groups(setup):
    _, _, results, _ = setup
    for world, (data, fsdp, tensor) in cases.WORLDS.items():
        for r, res in enumerate(results[world]):
            d, f, t = _coords(world, r)
            g = res["groups"]
            assert (g["fsdp_rank"], g["tensor_rank"], g["batch_rank"]) == (f, t, d * fsdp + f)

            def members(ranks):
                return sum(2.0 ** q for q in ranks)

            plane = range(d * fsdp * tensor, (d + 1) * fsdp * tensor)
            assert g["plane"] == members(plane)
            assert g["tensor"] == members(q for q in plane if _coords(world, q)[1] == f)
            assert g["fsdp"] == members(q for q in plane if _coords(world, q)[2] == t)
            assert g["data"] == members(q * fsdp * tensor + r % (fsdp * tensor)
                                        for q in range(data))
            assert res["mesh"] == f"data {data} x fsdp {fsdp} x tensor {tensor}"


# (b) ------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_ranks_stay_bit_equal(setup, world, name):
    _, _, results, _ = setup
    ranks = results[world]
    assert all(res["equal"][name] for res in ranks)
    assert all(res["steps"][name]["metrics"] == ranks[0]["steps"][name]["metrics"]
               for res in ranks)


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_tensor_fsdp_equals_one_process(setup, world, name):
    inputs, refs, results, _ = setup
    one = refs[name]
    got = results[world][0]["steps"][name]
    if name in cases.BF16_CASES:
        _assert_bf16_step_close(got, one["metrics"][0], one["state"]["model"],
                                inputs["weights"]["cond"])
        return
    _, opt_cfg, steps, _ = cases.CASES[name]
    assert len(got["metrics"]) == steps
    for m, want in zip(got["metrics"], one["metrics"]):
        _assert_metrics_close(m, want)
    adaptive = opt_cfg in ADAPTIVE
    _assert_params_close(got["model"], one["state"]["model"], adaptive, opt_cfg["lr"])
    if got["ema"] is not None:
        _assert_params_close(got["ema"], one["state"]["ema"]["params"], adaptive, opt_cfg["lr"])


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_tensor_fsdp_matches_jax(setup, world, name):
    inputs, refs, results, _ = setup
    jstate, jmetrics = refs["jax", name]
    got = results[world][0]["steps"][name]
    if name in cases.BF16_CASES:
        _assert_bf16_step_close(got, jmetrics[0],
                                params_from_flax(jax.tree.map(np.asarray, jstate.params)),
                                inputs["weights"]["cond"])
        return
    for m, jm in zip(got["metrics"], jmetrics):
        assert_metrics_close(m, jm, rtol=1e-4)
    opt_cfg = cases.CASES[name][1]
    atol = 0.25 * opt_cfg["lr"] if opt_cfg in ADAPTIVE else 1e-6
    train_step.assert_params_match(got["model"], jstate.params, rtol=1e-4, atol=atol)
    if got["ema"] is not None:
        train_step.assert_params_match(got["ema"], jstate.ema.params, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("world", list(cases.WORLDS))
def test_pretrain_step_equals_one_process_and_jax(setup, world):
    _, refs, results, _ = setup
    ranks = results[world]
    for kind in cases.PRETRAIN_KINDS:
        got = ranks[0]["pretrain"][kind]
        for res in ranks[1:]:
            assert res["pretrain"][kind]["metrics"] == got["metrics"]
            assert all(torch.equal(res["pretrain"][kind]["params"][k], v)
                       for k, v in got["params"].items())
        one = refs["pretrain", kind]
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=5e-5, atol=1e-6, err_msg=k)
        _assert_params_close(got["params"], one["params"], False, 1.0)
        jstate, jm = refs["jax", "pretrain", kind]
        for k, v in jm.items():
            np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, err_msg=k)
        train_step.assert_params_match(got["params"], jstate.params, rtol=1e-4, atol=1e-6)


# (c), (d) ---------------------------------------------------------------------

def _assemble(parts, layout, fsdp, tensor):
    """The whole tensor of the blocks ``parts`` of one data group's ranks
    (rank order: fsdp-major, tensor-minor) split as ``layout``; a split the
    leaf does not have must leave equal blocks."""
    tdim, fdim, chunks = layout
    tblocks = []
    for t in range(tensor):
        column = [parts[f * tensor + t] for f in range(fsdp)]
        if fdim is None:
            assert all(torch.equal(c, column[0]) for c in column)
            tblocks.append(column[0])
        else:
            assert not torch.equal(column[0], column[1])
            tblocks.append(torch.cat(column, fdim))
    if tdim is None:
        assert all(torch.equal(b, tblocks[0]) for b in tblocks)
        return tblocks[0]
    assert not torch.equal(tblocks[0], tblocks[1])
    pieces = [b.chunk(chunks, tdim) for b in tblocks]
    return torch.cat([pieces[t][c] for c in range(chunks) for t in range(tensor)], tdim)


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_blocks_assemble_the_whole(setup, world, name):
    _, _, results, _ = setup
    data, fsdp, tensor = cases.WORLDS[world]
    ranks = results[world]
    layouts = ranks[0]["steps"][name]["layouts"]
    assert all(res["steps"][name]["layouts"] == layouts for res in ranks)
    two = [lay for lay in layouts if lay[0] is not None and lay[1] is not None]
    assert len(two) == {"cond": 64}.get(cases.CASES[name][0], 40)
    assert (2 in [lay[2] for lay in layouts]) == (cases.CASES[name][0] == "cond")
    whole = ranks[0]["steps"][name]["model"]
    params = [res["steps"][name]["blocks"]["params"] for res in ranks]
    plane = fsdp * tensor
    for i, (key, lay) in enumerate(zip(whole, layouts)):
        for d in range(1, data):      # a data group holds equal blocks
            for q in range(plane):
                assert torch.equal(params[d * plane + q][i], params[q][i]), key
        assert torch.equal(_assemble([params[q][i] for q in range(plane)], lay, fsdp, tensor),
                           whole[key]), key


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_each_rank_holds_its_share(setup, world, name):
    _, refs, results, _ = setup
    _, fsdp, tensor = cases.WORLDS[world]
    one = refs[name]["held"]
    shapes = [v.shape for v in refs[name]["state"]["model"].values()]
    for res in results[world]:
        step = res["steps"][name]
        held, layouts = step["held"], step["layouts"]
        share = [(tensor if t is not None else 1) * (fsdp if f is not None else 1)
                 for t, f, _ in layouts]
        assert [n * s for n, s in zip(held["param"], share)] == one["param"]
        if one["ema"] is not None:
            assert [n * s for n, s in zip(held["ema"], share)] == one["ema"]
        assert len(held["accumulators"]) == len(one["accumulators"]) > 0
        for acc, acc_one in zip(held["accumulators"], one["accumulators"]):
            assert [n * s for n, s in zip(acc, share)] == acc_one
        factored_split = 0
        for st, st_one, lay, shape in zip(held["optimizer"], one["optimizer"], layouts, shapes):
            assert st.keys() == st_one.keys()
            for k, n in st.items():
                s = cases.state_share(k, lay, shape, (fsdp, tensor))
                assert n * s == st_one[k], (k, shape, lay)
                factored_split += k in ("v_row", "v_col") and s > 1
        if name == "cond_adafactor":
            assert factored_split > 0
        split = sum(n - n // s for n, s in zip(one["param"], share))
        assert held["bytes"]["params"] == 4 * (sum(one["param"]) - split)


# (e) ------------------------------------------------------------------------

def _assert_blocks(blocks, state_dict, name, layouts, world, r):
    """``blocks`` (a rank's own tensors) are the rank's blocks of the whole
    ``state_dict``, bit for bit."""
    _, fsdp, tensor = cases.WORLDS[world]
    _, f, t = _coords(world, r)
    ref = cases.build_state(name, {cases.CASES[name][0]: state_dict["model"]})
    names = ref.sharding.names

    def block(x, lay):
        return cases.block_of(x, lay, (f, t), (fsdp, tensor))

    for key, lay, got in zip(names, layouts, blocks["params"]):
        assert torch.equal(got, block(state_dict["model"][key], lay)), key
    if blocks["ema"] is not None:
        for key, lay, got in zip(names, layouts, blocks["ema"]):
            assert torch.equal(got, block(state_dict["ema"]["params"][key], lay)), key
    whole_state = state_dict["optimizer"]["state"]
    for i, (lay, shape, st) in enumerate(zip(layouts, ref.sharding.full_shapes,
                                             blocks["optimizer"])):
        for k, v in st.items():
            want = whole_state[i][k]
            if isinstance(v, torch.Tensor):
                want = block(want, state_layout(k, want, Layout(*lay), shape))
                assert torch.equal(v, want), (i, k)
            else:
                assert v == want, (i, k)


CKPT_WORLDS = [(w, n) for w in cases.WORLDS for n in cases.CHECKPOINT_CASES]


@pytest.mark.parametrize("world,name", CKPT_WORLDS)
def test_checkpoint_from_the_mesh_loads_in_one_process(setup, world, name):
    inputs, _, results, d = setup
    mgr = CheckpointManager(str(d / world / "ckpt" / name))
    sd = mgr.restore_item("latest", "state")
    assert sd["step"] == cases.CASES[name][2]
    state = cases.build_state(name, inputs["weights"])
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
        step = res["steps"][name]
        _assert_blocks(step["blocks"], sd, name, step["layouts"], world, r)


@pytest.mark.parametrize("world,name", CKPT_WORLDS)
def test_one_process_checkpoint_resumes_on_the_mesh(setup, world, name):
    inputs, refs, results, _ = setup
    resume = inputs["resume"][name]
    for r, res in enumerate(results[world]):
        _assert_blocks(res["resumed"][name]["loaded"], resume, name,
                       res["steps"][name]["layouts"], world, r)
    one = refs["resumed", name]
    got = results[world][0]["resumed"][name]
    for m, want in zip(got["metrics"], one["metrics"]):
        _assert_metrics_close(m, want)
    _assert_params_close(got["model"], one["state"]["model"], True, cases.CASES[name][1]["lr"])


# (f) ------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [(w, n) for w in cases.WORLDS for n in cases.EVAL_CASES])
def test_evaluator_on_the_mesh_equals_one_process(setup, world, name):
    _, refs, results, _ = setup
    one = refs["eval", name]
    assert one.shape == (cases.MB, cases.HW, cases.HW, 3)
    ranks = results[world]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["evaluator"][name], ranks[0]["evaluator"][name])
    np.testing.assert_allclose(ranks[0]["evaluator"][name], one, rtol=0, atol=1e-5)
