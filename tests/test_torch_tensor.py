"""The tensor axis of the port (siss_tpu_torch.parallel.tensor) on gloo ranks
on the CPU, against one process and against the JAX step.

(a) ``tp_dim`` splits, for every parameter of the full-width celeb, SD and
    t-shirt UNets at tensor 2 and 4 (fsdp 1), the torch dimension of the
    flax axis that JAX's ``_param_spec`` gives to ``tensor`` (the trees from
    ``jax.eval_shape``, the torch modules on the meta device), and covers
    the Megatron roles on the tiny conditional UNet as
    ``test_tp_specs_cover_the_megatron_roles`` does.
Three worlds (tests/torch_tensor_worker.py, spawned once for the module,
side by side): ``data=1 × tensor=2`` on two ranks, ``data=2 × tensor=2`` and
``data=1 × tensor=4`` on four. They run the cases of
tests/torch_tensor_cases.py (fused SISS with AdamW and EMA, unfused SISS,
EraseDiff, NegGrad, the batched dual backward, Adafactor with EMA and the
pretrain step on a single-head UNet2D; fused SISS with AdamW and EMA on a
multi-head UNet2D and on the tiny conditional UNet with the flash path,
which also runs Adafactor, and bf16 ``param_cast_dtype`` with
``remat_policy=dots``) on the rows of their batch coordinate. Checks:

(b) the ranks' gathered parameters and EMA are bit for bit equal; against
    the one-process step on the global batch: metrics rtol 5e-5 / atol 1e-6
    (the JAX package's own tensor test, tests/test_tensor_parallel.py), the
    importance weights' statistics rtol 1e-3 / atol 1e-6 as in
    tests/test_torch_parallel.py; params rtol 1e-5 / atol 1e-7 after SGD,
    rtol 1e-5 / atol 0.25·lr after AdamW or Adafactor (the JAX test: rtol
    1e-3 / atol 5e-5); against the JAX step at the one-process parity
    tolerances (rtol 1e-4; params atol 1e-6 after SGD, 0.25·lr after AdamW
    or Adafactor); the bf16 case's norms rtol 2⁻⁷ and each parameter's
    update within 2⁻⁷ of its tensor's largest update, against both;
(c) the ranks of a data group hold bit-equal blocks; the ranks of a tensor
    group hold different blocks that assemble the whole, GEGLU's
    interleaved [h | gate] blocks included;
(d) each rank holds 1/tensor of every split parameter's elements, of its
    EMA, optimizer state and both accumulators, and all of a whole one's;
(e) a checkpoint saved on the tensor ranks is the one-process format: one
    process loads it and saves it back unchanged, and it holds each rank's
    blocks bit for bit; a one-process checkpoint loads on the tensor ranks
    as their blocks, bit for bit, and the next step equals one process's;
(f) samples and a denoising injection from the gathered UNet equal one
    process's within 1e-5; the one-head attention split along its
    dimension (the celeb UNet's) gives one process's output and gradients
    within 1e-5;
and the groups, and that tensor 1 leaves every module whole.
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
import torch_tensor_cases as cases
from test_torch_fsdp import _assert_bf16_step_close, _flax_leaves, _models
from test_torch_parallel import assert_metrics_close
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
from siss_tpu_torch.models import UNet2DCondition, UNet2DConditionConfig
from siss_tpu_torch.parallel import shard_module, tp_dim
from siss_tpu_torch.train.optim import state_split_dim
from siss_tpu_torch.utils import CheckpointManager
from siss_tpu_torch.utils.convert import params_from_flax, torch_key

HERE = os.path.dirname(os.path.abspath(__file__))
JOIN_TIMEOUT_S = 400
JAX_KEYS = (jax.random.PRNGKey(200), jax.random.PRNGKey(201))
PRETRAIN_KEY = jax.random.PRNGKey(5)
ADAPTIVE = (cases.ADAMW, cases.ADAFACTOR)


# (a) ------------------------------------------------------------------------

class _FakeMesh:
    """What ``_param_spec`` and ``_fsdp_spec`` read of a mesh."""

    def __init__(self, n):
        self.shape = {"data": 1, "fsdp": 1, "tensor": n}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["celeb", "sd", "tshirt"])
def test_tp_dim_matches_jax_on_every_leaf(model, n):
    shapes, module = _models(model)
    params = dict(module.named_parameters())
    mesh = _FakeMesh(n)
    seen, split = 0, 0
    for path, shape in _flax_leaves(shapes):
        spec = tuple(_param_spec(path, shape, mesh))
        assert "fsdp" not in spec
        flax_axis = spec.index("tensor") if "tensor" in spec else None
        key = torch_key(path)
        torch_of_flax = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(shape), tuple(range(len(shape))))
        if path[-1] != "kernel":
            torch_of_flax = tuple(range(len(shape)))
        want = None if flax_axis is None else torch_of_flax[flax_axis]
        assert tp_dim(key.split("."), params[key].shape, n) == want, (path, shape, spec)
        seen += 1
        split += want is not None
    assert seen == len(params)
    # JAX's counts at tensor 2 (jax.eval_shape): celeb 248 of 450 leaves, sd_v1 330 of 686.
    assert split == {"celeb": 248, "sd": 330}.get(model, split) > 0


def test_tp_dim_covers_the_megatron_roles():
    """The tiny conditional UNet's roles, as the JAX package's
    test_tp_specs_cover_the_megatron_roles checks them."""
    with torch.device("meta"):
        names = {k: p.shape for k, p in UNet2DCondition(UNet2DConditionConfig.tiny())
                 .named_parameters()}

    def dim(key):
        return tp_dim(key.split("."), names[key], 2)

    tb = "down_blocks.0.attentions.0.transformer_blocks.0"
    assert dim(f"{tb}.attn1.to_q.weight") == 0
    assert dim(f"{tb}.attn2.to_k.weight") == 0
    assert dim(f"{tb}.attn1.to_out.0.weight") == 1
    assert dim(f"{tb}.ff.net.0.proj.weight") == 0
    assert dim(f"{tb}.ff.net.2.weight") == 1
    rb = "down_blocks.0.resnets.0"
    assert dim(f"{rb}.conv1.weight") == 0
    assert dim(f"{rb}.conv2.weight") == 1
    assert dim(f"{rb}.norm2.weight") == 0
    assert dim(f"{rb}.norm1.weight") is None
    assert dim(f"{tb}.attn1.to_out.0.bias") is None
    assert dim(f"{rb}.conv2.bias") is None


def test_tensor_1_leaves_every_module_whole():
    """At tensor 1 placement splits nothing and tells no module a split:
    the one-process model runs as it did."""
    model = UNet2DCondition(UNet2DConditionConfig.tiny())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sharding = shard_module(model)
    assert not sharding.sharded and not any(sharding.partial)
    assert all(getattr(m, "tensor_split", None) is None for m in model.modules())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# the worlds ---------------------------------------------------------------

def _flax_family(family):
    """(flax module, params, whole torch weights) of a family of
    ``cases.MODELS``: the flax init (jitted), carried over to torch."""
    if family == "cond":
        fmodel = FlaxCondUNet(FlaxCondConfig(**dict(cases.COND, attention_impl="einsum")))
        init = functools.partial(fmodel.init_params, batch_size=cases.MB,
                                 context_len=cases.CTX[0])
    else:
        fmodel = FlaxUNet(FlaxConfig(**(cases.MULTI if family == "multi" else cases.SINGLE)))
        init = fmodel.init_params
    fparams = jax.jit(init)(jax.random.PRNGKey(3))
    return fmodel, fparams, params_from_flax(jax.tree.map(np.asarray, fparams))


def _flax_models():
    """{family: (flax module, params, whole torch weights)}, initialised in
    threads (XLA's compiler releases the GIL)."""
    with ThreadPoolExecutor(len(cases.FAMILIES)) as pool:
        return dict(zip(cases.FAMILIES, pool.map(_flax_family, cases.FAMILIES)))


def _jax_run(name, flax_models, inputs):
    """The JAX step of a case on the global batch: (state, metrics)."""
    kind, opt_cfg, steps, kw = cases.CASES[name]
    fmodel, fparams, _ = flax_models[cases.MODELS[kind][0]]
    if kind.startswith("cond"):
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
        refs["attention"] = cases.split_attention()
        refs.update({k: f.result() for k, f in jax_runs.items()})
    return refs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, the references, {world: one result per rank}, directory).
    The references are computed while the ranks run."""
    d = tmp_path_factory.mktemp("tensor")
    flax_models = _flax_models()
    draws = {name: [objectives.jax_draws(k, kw["loss_fn"], cases.shape_of(kind))
                    for k in JAX_KEYS[:steps]]
             for name, (kind, _, steps, kw) in cases.CASES.items()}
    draws["pretrain"] = pretrain.jax_draws(PRETRAIN_KEY, (cases.MB, cases.HW, cases.HW, 3))
    inputs = cases.make_inputs({f: m[2] for f, m in flax_models.items()}, draws)
    inputs["resume"] = {name: cases.run_case(name, inputs, stop=1)["state"]
                        for name in cases.CHECKPOINT_CASES}
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = {}
    try:
        for world, (data, tensor, _) in cases.WORLDS.items():
            (d / world).mkdir()
            n = data * tensor
            procs[world] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_tensor_worker.py"), str(r), str(n),
                 str(data), str(tensor), str(d / world)], stdout=subprocess.PIPE,
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
                       for r in range(data * tensor)]
               for world, (data, tensor, _) in cases.WORLDS.items()}
    return inputs, refs, results, d


def _world_cases(names):
    return [(w, n) for w, (_, _, kinds) in cases.WORLDS.items() for n in names
            if cases.CASES[n][0] in kinds]


CASE_WORLDS = _world_cases(cases.CASES)


def _assert_params_close(got, want, adaptive, lr):
    atol = 0.25 * lr if adaptive else 1e-7
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=atol, err_msg=k)


def _assert_metrics_close(got, want):
    """The JAX package's tensor test's metric tolerances (rtol 5e-5, atol
    1e-6), the importance weights' statistics as tests/test_torch_parallel.py."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        rtol = 1e-3 if k.startswith("importance_weight") else 5e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=k)


def test_mesh_groups(setup):
    _, _, results, _ = setup
    for world, (data, tensor, _) in cases.WORLDS.items():
        for r, res in enumerate(results[world]):
            g = res["groups"]
            assert (g["tensor_rank"], g["batch_rank"]) == (r % tensor, r // tensor)
            row = r // tensor * tensor
            assert g["tensor_members"] == sum(2.0 ** q for q in range(row, row + tensor))
            assert g["data_members"] == sum(2.0 ** (q * tensor + r % tensor) for q in range(data))
            assert res["mesh"] == f"data {data} x fsdp 1 x tensor {tensor}"


# (b) ------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_ranks_stay_bit_equal(setup, world, name):
    _, _, results, _ = setup
    ranks = results[world]
    assert all(res["equal"][name] for res in ranks)
    assert all(res["steps"][name]["metrics"] == ranks[0]["steps"][name]["metrics"]
               for res in ranks)


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_tensor_equals_one_process(setup, world, name):
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
def test_tensor_matches_jax(setup, world, name):
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

def _assemble(parts, dim, chunks):
    """The whole tensor of the tensor ranks' blocks ``parts`` (rank order),
    each of which holds its block of every one of ``chunks`` chunks."""
    pieces = [p.chunk(chunks, dim) for p in parts]
    return torch.cat([pieces[r][c] for c in range(chunks) for r in range(len(parts))], dim)


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_blocks_assemble_the_whole(setup, world, name):
    _, _, results, _ = setup
    data, tensor, _ = cases.WORLDS[world]
    ranks = results[world]
    lay = ranks[0]["steps"][name]["layout"]
    assert all(a == "tensor" for a, d in zip(lay["axes"], lay["dims"]) if d is not None)
    assert 2 in lay["chunks"] if cases.CASES[name][0].startswith("cond") else 2 not in lay["chunks"]
    whole = ranks[0]["steps"][name]["model"]
    names = list(whole)
    params = [res["steps"][name]["blocks"]["params"] for res in ranks]
    for i, (key, dim, chunks) in enumerate(zip(names, lay["dims"], lay["chunks"])):
        for d in range(1, data):      # a data group holds equal blocks
            for t in range(tensor):
                assert torch.equal(params[d * tensor + t][i], params[t][i]), key
        group = [params[t][i] for t in range(tensor)]
        if dim is None:
            assert all(torch.equal(g, whole[key]) for g in group), key
            continue
        assert not torch.equal(group[0], group[1]), key
        assert torch.equal(_assemble(group, dim, chunks), whole[key]), key


@pytest.mark.parametrize("world,name", CASE_WORLDS)
def test_each_rank_holds_its_share(setup, world, name):
    _, refs, results, _ = setup
    tensor = cases.WORLDS[world][1]
    one = refs[name]["held"]
    for res in results[world]:
        held = res["steps"][name]["held"]
        lay = res["steps"][name]["layout"]
        share = [1 if d is None else tensor for d in lay["dims"]]
        assert sum(s > 1 for s in share) > len(share) // 3
        assert [n * s for n, s in zip(held["param"], share)] == one["param"]
        if one["ema"] is not None:
            assert [n * s for n, s in zip(held["ema"], share)] == one["ema"]
        assert len(held["accumulators"]) == len(one["accumulators"]) > 0
        for acc, acc_one in zip(held["accumulators"], one["accumulators"]):
            assert [n * s for n, s in zip(acc, share)] == acc_one
        for st, st_one, s in zip(held["optimizer"], one["optimizer"], share):
            assert st.keys() == st_one.keys()
            for k, n in st.items():
                # Adafactor's row (col) statistics are whole when they drop
                # the split dimension.
                assert n * s == st_one[k] or (s == 1 or k in ("v_row", "v_col")) \
                    and n == st_one[k], k
        split = sum(n for n, s in zip(one["param"], share) if s > 1)
        assert held["bytes"]["params"] == 4 * (sum(one["param"]) - split + split // tensor)


# (e) ------------------------------------------------------------------------

def _assert_blocks(blocks, state_dict, name, lay, tensor, r):
    """``blocks`` (a rank's own tensors) are the rank's blocks of the whole
    ``state_dict``, bit for bit."""
    ref = cases.build_state(name, {cases.MODELS[cases.CASES[name][0]][0]: state_dict["model"]})
    names = ref.sharding.names
    me = r % tensor

    def block(t, d, chunks):
        if d is None:
            return t
        size = t.shape[d] // (tensor * chunks)
        return torch.cat([c.narrow(d, me * size, size) for c in t.chunk(chunks, d)], d)

    for key, d, c, got in zip(names, lay["dims"], lay["chunks"], blocks["params"]):
        assert torch.equal(got, block(state_dict["model"][key], d, c)), key
    if blocks["ema"] is not None:
        for key, d, c, got in zip(names, lay["dims"], lay["chunks"], blocks["ema"]):
            assert torch.equal(got, block(state_dict["ema"]["params"][key], d, c)), key
    whole_state = state_dict["optimizer"]["state"]
    for i, (d, c, shape, st) in enumerate(zip(lay["dims"], lay["chunks"],
                                              ref.sharding.full_shapes, blocks["optimizer"])):
        for k, v in st.items():
            want = whole_state[i][k]
            if isinstance(v, torch.Tensor) and d is not None:
                want = block(want, state_split_dim(k, want, d, shape), c)
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, want), (i, k)
            else:
                assert v == want, (i, k)


CKPT_WORLDS = _world_cases(cases.CHECKPOINT_CASES)


@pytest.mark.parametrize("world,name", CKPT_WORLDS)
def test_checkpoint_from_tensor_ranks_loads_in_one_process(setup, world, name):
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
    tensor = cases.WORLDS[world][1]
    for r, res in enumerate(results[world]):
        step = res["steps"][name]
        _assert_blocks(step["blocks"], sd, name, step["layout"], tensor, r)


@pytest.mark.parametrize("world,name", CKPT_WORLDS)
def test_one_process_checkpoint_resumes_on_tensor_ranks(setup, world, name):
    inputs, refs, results, _ = setup
    resume = inputs["resume"][name]
    tensor = cases.WORLDS[world][1]
    for r, res in enumerate(results[world]):
        _assert_blocks(res["resumed"][name]["loaded"], resume, name,
                       res["steps"][name]["layout"], tensor, r)
    one = refs["resumed", name]
    got = results[world][0]["resumed"][name]
    for m, want in zip(got["metrics"], one["metrics"]):
        _assert_metrics_close(m, want)
    _assert_params_close(got["model"], one["state"]["model"], True, cases.CASES[name][1]["lr"])


# (f) ------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [(w, n) for w in cases.WORLDS for n in cases.EVAL_CASES])
def test_evaluator_on_tensor_ranks_equals_one_process(setup, world, name):
    _, refs, results, _ = setup
    one = refs["eval", name]
    assert one.shape == (cases.MB, cases.HW, cases.HW, 3)
    ranks = results[world]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["evaluator"][name], ranks[0]["evaluator"][name])
    np.testing.assert_allclose(ranks[0]["evaluator"][name], one, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", list(cases.WORLDS))
def test_one_head_split_along_its_dimension(setup, world):
    _, refs, results, _ = setup
    one = refs["attention"]
    for res in results[world]:
        got = res["attention"]
        torch.testing.assert_close(got["y"], one["y"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["dx"], one["dx"], rtol=1e-5, atol=1e-5)
        assert got["params"].keys() == one["params"].keys()
        for k, v in one["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-5, atol=1e-5, msg=k)
