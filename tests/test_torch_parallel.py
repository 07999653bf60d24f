"""Data parallelism in the port (siss_tpu_torch.parallel): two gloo ranks on
the CPU against one process and against the JAX step.

Two ranks (tests/torch_parallel_worker.py, spawned once for the module)
run every case of tests/torch_parallel_cases.py on their blocks of each
global batch: the fused SISS step of a tiny UNet (SGD, and two AdamW + EMA
steps), EraseDiff, NegGrad (the scalar path), unfused SISS, the tiny SD
step on the flash path (plain versions), the pretrain step and the
evaluator. Checks:

* the ranks' parameters and EMA are bit for bit equal;
* against the one-process step on the global batch (this process, no
  group): params rtol 1e-5 / atol 1e-7 after SGD, atol 0.25·lr after AdamW
  (whose direction for a ~0 gradient is rounding noise); metrics rtol 1e-5,
  importance-weight stats rtol 1e-3 / atol 1e-6 (exp of a difference of
  large sums). The only differences are the order of fp32 sums;
* against the JAX step on the same global batch and draws, at the one-process
  parity tests' tolerances (tests/test_torch_train_step.py,
  tests/test_torch_objectives.py);
* samples and injections on two ranks equal one process's within 1e-5;
* the stripes tile the one-rank stream; the collectives; a batch the ranks
  do not divide raises as in JAX.
"""

import itertools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_cases as cases
import test_torch_objectives as objectives
import test_torch_train_step as train_step
from torch_parity import CELEB_LIKE, flax_unet, jax_tiny_apply, tiny_params, torch_unet
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.parallel import MeshConfig as JaxMeshConfig
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch.data import InfiniteSampler
from siss_tpu_torch.parallel import MeshConfig, process_batch_slice, resolve_mesh
from siss_tpu_torch.train.step import draw_microbatch_randomness

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
JOIN_TIMEOUT_S = 240
JAX_KEYS = (jax.random.PRNGKey(100), jax.random.PRNGKey(101))


def jax_case_draws(name):
    """The JAX step's global draws of each step of a case (torch tensors)."""
    kind, _, steps, kw = cases.STEP_CASES[name]
    if kind == "unet":
        return [train_step.jax_draws(k, (cases.HW,) * 2 + (3,), kw["t_min"], kw["t_max"])
                for k in JAX_KEYS[:steps]]
    return [objectives.jax_draws(k, kw["loss_fn"], (cases.TINY_HW, cases.TINY_HW, cases.TINY_C))
            for k in JAX_KEYS[:steps]]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, the flax UNet and its params, one result per rank)."""
    d = tmp_path_factory.mktemp("ranks")
    fmodel, fparams, np_params = flax_unet(CELEB_LIKE, seed=2)
    draws = {name: jax_case_draws(name) for name, c in cases.STEP_CASES.items() if c[0] != "sd"}
    gen = torch.Generator().manual_seed(4)
    draws["sd_flash"] = [draw_microbatch_randomness(gen, cases.A, cases.SD_MB,
                                                    (cases.SD_HW, cases.SD_HW, cases.SD_C),
                                                    999, 1000, "cpu")]
    inputs = cases.make_inputs(torch_unet(CELEB_LIKE, np_params).state_dict(), draws)
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                               str(r), str(WORLD), str(d)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    results = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return inputs, (fmodel, fparams), results


@pytest.mark.parametrize("data,fsdp,tensor,n", [(-1, 1, 1, 1), (-1, 1, 1, 2), (-1, 1, 1, 8),
                                                (2, 1, 1, 2), (4, 1, 1, 2), (-1, 2, 1, 8),
                                                (-1, 1, 4, 8), (2, 2, 2, 8), (-1, 3, 1, 8)])
def test_mesh_resolve_matches_jax(data, fsdp, tensor, n):
    ours, theirs = MeshConfig(data, fsdp, tensor), JaxMeshConfig(data, fsdp, tensor)
    try:
        want = theirs.resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            ours.resolve(n)
        return
    got = ours.resolve(n)
    assert (got.data, got.fsdp, got.tensor) == (want.data, want.fsdp, want.tensor)


@pytest.mark.parametrize("mesh,item", [(MeshConfig(fsdp=2), "12b"), (MeshConfig(tensor=2), "12c")])
def test_unported_axes_raise(mesh, item):
    """The fsdp axis (item 12b) and the tensor axis (item 12c) are ported
    and resolve, alone and together (tests/test_torch_tensor_fsdp.py runs
    them together)."""
    if item == "12b":
        assert resolve_mesh(mesh, 4) == MeshConfig(2, 2, 1)
    else:
        assert resolve_mesh(mesh, 4) == MeshConfig(2, 1, 2)
        assert resolve_mesh(MeshConfig(fsdp=2, tensor=2), 4) == MeshConfig(1, 2, 2)
        assert resolve_mesh(MeshConfig(data=2, fsdp=2, tensor=2), 8) == MeshConfig(2, 2, 2)
    assert resolve_mesh(MeshConfig(), 4) == MeshConfig(4, 1, 1)


def test_stripes_tile_the_one_rank_stream(setup):
    _, _, results = setup
    full = list(itertools.islice(iter(InfiniteSampler(16, seed=7)), 16 * WORLD))
    interleaved = [None] * (16 * WORLD)
    for r, res in enumerate(results):
        interleaved[r::WORLD] = res["collectives"]["stripe"]
    assert interleaved == full


def test_collectives(setup):
    _, _, results = setup
    for r, res in enumerate(results):
        c = res["collectives"]
        want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * q for q in range(WORLD)])
        assert torch.equal(c["gathered"], want)
        assert torch.equal(c["gathered_axis1"],
                           torch.cat([torch.full((2, 1, 3), float(q)) for q in range(WORLD)], 1))
        cl = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
        sums = [torch.full((3,), 3.0), 2 * cl + 1, torch.full((40,), 6.0),
                torch.full((5,), 2.0, dtype=torch.bfloat16), torch.arange(4.0) * 3]
        for got, want in zip(c["all_reduced"], sums):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert c["channels_last_kept"]
        assert c["any_rank"] == [True, False]
        assert c["broadcast"] == "dir-of-rank-0"


def test_indivisible_batch_raises_as_jax(setup):
    _, _, results = setup
    for res in results:
        assert res["collectives"]["indivisible"] == "global batch 3 not divisible by 2 processes"
        assert res["collectives"]["indivisible_rows"] == res["collectives"]["indivisible"]
    assert process_batch_slice(3) == 3  # one process takes any batch


@pytest.mark.parametrize("name", list(cases.STEP_CASES))
def test_ranks_stay_bit_equal(setup, name):
    _, _, (r0, r1) = setup
    a, b = r0["steps"][name], r1["steps"][name]
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    if a["ema"] is not None:
        assert all(torch.equal(x, y) for x, y in zip(a["ema"], b["ema"]))
    assert a["metrics"] == b["metrics"]


def assert_metrics_close(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith("importance_weight"):
            np.testing.assert_allclose(got[k], float(v), rtol=1e-3, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", list(cases.STEP_CASES))
def test_two_ranks_equal_one_process(setup, name):
    """The loss, loss_x and loss_a statistics, the surgery's norms and the
    parameters of the global batch, whatever the number of ranks."""
    inputs, _, (r0, _) = setup
    one = cases.run_case(name, inputs)
    for got, want in zip(r0["steps"][name]["metrics"], one["metrics"]):
        assert_metrics_close(got, want, rtol=1e-5)
    atol = 0.25 * cases.LR if cases.STEP_CASES[name][1] is cases.ADAMW else 1e-7
    for k, v in one["params"].items():
        np.testing.assert_allclose(r0["steps"][name]["params"][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)


def jax_case(name, fmodel, fparams):
    """The JAX step of a case on the global batch: (final params, metrics)."""
    kind, opt_cfg, steps, kw = cases.STEP_CASES[name]
    tx = optax.sgd(1.0) if opt_cfg is cases.SGD else optax.adamw(
        cases.LR, b1=0.95, b2=0.999, weight_decay=1e-6)
    if kind == "unet":
        apply, params = (lambda p, x, t, c: fmodel.apply({"params": p}, x, t)), fparams
    else:
        apply = jax_tiny_apply
        params = jax.tree.map(jnp.asarray, tiny_params(0, channels=cases.TINY_C))
    jstep = jax.jit(jax_build_step(apply, JaxSchedule.create(1000, "linear"), tx,
                                   JaxStepConfig(**kw)))
    jstate = JaxState.create(params, tx, use_ema=kw.get("use_ema", False))
    return jstate, jstep


@pytest.mark.parametrize("name", [n for n, c in cases.STEP_CASES.items() if c[0] != "sd"])
def test_two_ranks_match_jax(setup, name):
    inputs, (fmodel, fparams), (r0, _) = setup
    kind, opt_cfg, steps, kw = cases.STEP_CASES[name]
    jstate, jstep = jax_case(name, fmodel, fparams)
    batch = {k: jnp.asarray(v.numpy()) for k, v in inputs[name]["batch"].items()}
    for key, got in zip(JAX_KEYS[:steps], r0["steps"][name]["metrics"]):
        jstate, jm = jstep(jstate, batch, key, {})
        assert_metrics_close(got, {k: float(v) for k, v in jm.items()}, rtol=1e-4)
    adam = opt_cfg is cases.ADAMW
    params = r0["steps"][name]["params"]
    if kind == "unet":
        train_step.assert_params_match(params, jstate.params, rtol=1e-4,
                                       atol=0.25 * cases.LR if adam else 1e-6)
    else:
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_pretrain_step_two_ranks_equal_one_process(setup):
    inputs, _, (r0, r1) = setup
    one = cases.run_pretrain(inputs)
    assert r0["pretrain"]["metrics"] == r1["pretrain"]["metrics"]
    np.testing.assert_allclose(r0["pretrain"]["metrics"]["loss"], one["metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["pretrain"]["metrics"]["gradient/pre_clip_norm"],
                               one["metrics"]["gradient/pre_clip_norm"], rtol=1e-5)
    for k, v in one["params"].items():
        assert torch.equal(r0["pretrain"]["params"][k], r1["pretrain"]["params"][k]), k
        np.testing.assert_allclose(r0["pretrain"]["params"][k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", cases.EVAL_CASES)
def test_evaluator_two_ranks_equal_one_process(setup, name):
    """Each rank runs the model on its half of the batch and gets all of it."""
    inputs, _, (r0, r1) = setup
    one = cases.run_evaluator(name, inputs)
    assert one.shape == (cases.MB, cases.HW, cases.HW, 3)
    np.testing.assert_array_equal(r0["evaluator"][name], r1["evaluator"][name])
    np.testing.assert_allclose(r0["evaluator"][name], one, rtol=0, atol=1e-5)
