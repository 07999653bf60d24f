"""The port's tasks on two ranks through their command line on the CPU:
``python -m torch.distributed.run --standalone --nproc_per_node 2`` over
``siss_tpu_torch.main --device cpu`` (gloo), at a tiny size.

Each task (pretrain, t-shirt unlearning, celeb, SD) runs on two ranks
through tests/torch_parallel_cli_worker.py, which calls
``siss_tpu_torch.main.main`` and records each rank's sampler indices and
its parameters at the last checkpoint bundle. Checks: one ``output_dir``
(rank 0's), one tracker log with each step once, one checkpoint; the ranks'
parameters bit for bit equal; the keep stripes tile the one-rank stream (and
the t-shirt forget stripes too), while celeb and SD give every rank the
same forget rows (their forget stream is not striped, as in JAX); the
t-shirt run logs a one-process run's keys, and ``-m siss_tpu_torch.main``
on two ranks resumes it from its checkpoint; an SD batch the ranks do not
divide raises. With ``mesh.fsdp=2`` (a t-shirt UNet at 128 channels, wide
enough to split), and with ``mesh.tensor=2`` (the tiny t-shirt UNet with an
attention level), and with both on four ranks (``mesh.fsdp=2
mesh.tensor=2``, that UNet at 128 channels), the ranks print the mesh, save
one checkpoint of whole tensors that one process loads, and log a
one-process run's keys.
"""

import itertools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import psutil
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu_torch import main as cli
from siss_tpu_torch.data import InfiniteSampler, RepeatedSampler
from siss_tpu_torch.models import UNet2D, UNet2DConfig
from siss_tpu_torch.utils import CheckpointManager
from test_torch_celeb import celeb_args, write_folder
from test_torch_sd_task import N_IMAGES, TINY as SD_TINY, sd_root  # noqa: F401  (fixture)
from test_torch_tasks import TINY_UNET, delete_args, npz, pretrain_args  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(Path(__file__).resolve().parent / "torch_parallel_cli_worker.py")
TIMEOUT_S = 240
#: The t-shirt UNet of TINY_UNET at 28² (``configs/train_tshirt_mnist.yaml``).
TSHIRT_28 = dict(sample_size=28, in_channels=1, out_channels=1,
                 down_block_types=("DownBlock2D",) * 2, up_block_types=("UpBlock2D",) * 2,
                 norm_num_groups=8)


def launch(*args, nproc=2, **env_extra):
    """``torch.distributed.run`` with ``nproc`` ranks on the CPU. After
    ``TIMEOUT_S`` the launcher and every process under it are killed (its
    ranks run in sessions of their own) and the test fails. Returns (rc,
    output)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", **env_extra)
    with tempfile.TemporaryFile("w+") as log:
        p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", str(nproc), *args], cwd=ROOT, env=env, stdout=log,
                             stderr=subprocess.STDOUT, text=True)
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for proc in psutil.Process(p.pid).children(recursive=True) + [psutil.Process(p.pid)]:
                proc.kill()
            p.wait()
            pytest.fail(f"{nproc} ranks did not finish in {TIMEOUT_S} s: {args}")
        log.seek(0)
        return p.returncode, log.read()


def run_ranks(record, args, **env):
    """The command line on two ranks through the recording worker: the two
    ranks' records."""
    record.mkdir(exist_ok=True)
    rc, out = launch(WORKER, str(record), *args, **env)
    assert rc == 0, out[-4000:]
    return [torch.load(record / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


def only_run(parent):
    (run,) = [p for p in Path(parent).iterdir() if p.is_dir()]
    return run


def rows_of(run):
    (log,) = list(Path(run).rglob("metrics.jsonl"))
    with open(log) as f:
        return [json.loads(line) for line in f]


def checkpoints(run):
    return sorted(p.name for p in Path(run).iterdir() if p.name.startswith("checkpoint-"))


def assert_equal_params(records):
    a, b = (r["params"] for r in records)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_stripes(records, loader, n, sampler):
    """The ranks' first ``n`` indices of ``loader`` interleave into the
    one-rank ``sampler``'s stream."""
    interleaved = [None] * (2 * n)
    for r, rec in enumerate(records):
        interleaved[r::2] = rec["indices"][loader][:n]
    assert interleaved == list(itertools.islice(iter(sampler), 2 * n))


@pytest.fixture(scope="module")
def pretrain2(npz, tmp_path_factory):
    """The pretrain task on two ranks: (run dir, records)."""
    d = tmp_path_factory.mktemp("pretrain2")
    records = run_ranks(d / "record", pretrain_args(npz, d / "out"))
    return only_run(d / "out"), records


def test_pretrain_on_two_ranks(pretrain2):
    run, records = pretrain2
    assert {r["output_dir"] for r in records} == {str(run)}
    assert checkpoints(run) == ["checkpoint-5"]  # 88 images / global batch 16
    rows = rows_of(run)
    assert [r["_step"] for r in rows if "loss" in r] == [1]  # then every 50 steps
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    assert_equal_params(records)
    assert_stripes(records, 0, 5 * 8, InfiniteSampler(88, seed=42))


@pytest.fixture(scope="module")
def delete2(npz, pretrain2, tmp_path_factory):
    """The t-shirt unlearning task on two ranks from the two-rank pretrain:
    (run dir, records, its arguments)."""
    d = tmp_path_factory.mktemp("delete2")
    args = delete_args(npz, d / "out", pretrain2[0])
    records = run_ranks(d / "record", args)
    return only_run(d / "out"), records, args


def test_delete_tshirt_on_two_ranks(delete2):
    run, records, _ = delete2
    assert {r["output_dir"] for r in records} == {str(run)}
    assert checkpoints(run) == ["checkpoint-3"]
    rows = rows_of(run)
    assert sorted(r["_step"] for r in rows if "loss_x/mean" in r) == [1, 2, 3]
    assert_equal_params(records)
    # both streams striped (siss_tpu/tasks/delete_tshirt.py:91-98), seeds 46, 47
    assert_stripes(records, 0, 3 * 2, InfiniteSampler(80, seed=46))  # 10 classes × 8
    assert_stripes(records, 1, 3 * 2, InfiniteSampler(8, seed=47))


def test_delete_tshirt_keys_equal_one_process(npz, pretrain2, delete2, tmp_path):
    (task,) = cli.main(delete_args(npz, tmp_path, pretrain2[0]))
    keys = [set().union(*map(set, rows_of(run))) for run in (task.cfg.output_dir, delete2[0])]
    assert keys[0] == keys[1]


def test_two_ranks_resume_from_latest(delete2):
    """``-m siss_tpu_torch.main`` itself on two ranks, from the two-rank
    run's checkpoint, to step 5: the same run directory and log."""
    run, _, args = delete2
    rc, out = launch("-m", "siss_tpu_torch.main", *args, "training_steps=5",
                     f"resume_from_checkpoint={run}/checkpoint-3")
    assert rc == 0, out[-4000:]
    assert "resumed from step 3" in out
    assert checkpoints(run) == ["checkpoint-3", "checkpoint-5"]
    rows = rows_of(run)
    assert sorted(r["_step"] for r in rows if "loss_x/mean" in r) == [1, 2, 3, 4, 5]


def test_a_stop_on_one_rank_stops_both(npz, pretrain2, tmp_path):
    """A preemption stop requested on rank 1 alone: both ranks agree on it
    before the first step, save one checkpoint together and exit cleanly
    (without the agreement rank 0 would wait in the step's collectives)."""
    records = run_ranks(tmp_path / "record", delete_args(npz, tmp_path / "out", pretrain2[0]),
                        STOP_RANK="1")
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-0"]
    assert not [r for r in rows_of(run) if "loss_x/mean" in r]
    assert_equal_params(records)


def test_delete_celeb_on_two_ranks(tmp_path):
    """The keep stream striped; every rank draws the same forget rows."""
    (tmp_path / "celeba").mkdir()
    folder = write_folder(tmp_path / "celeba")
    records = run_ranks(tmp_path / "record", celeb_args(folder, tmp_path / "out",
                                                        "training_steps=2", "sampling_steps=2"))
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-2"]
    assert sorted(r["_step"] for r in rows_of(run) if "loss_x/mean" in r) == [1, 2]
    assert_equal_params(records)
    n = 2 * 2  # 2 steps × 2 accumulation microbatches × 1 row a rank
    assert_stripes(records, 0, n, InfiniteSampler(6, seed=42))
    forget = [rec["indices"][1][:n] for rec in records]
    assert forget[0] == forget[1] == list(itertools.islice(iter(RepeatedSampler(1, 4)), n))


def test_delete_sd_on_two_ranks(sd_root, tmp_path):  # noqa: F811
    """bs 2 on two ranks; bs 1, which two ranks do not divide, raises."""
    args = ["--config-name=delete_sd", "--device=cpu", f"base_dir={sd_root}",
            f"pretrained_model_name_or_path={sd_root / 'pretrained'}",
            f"og_prompts_path={sd_root / 'og.json'}",
            f"modified_prompts_path={sd_root / 'mod.json'}", *SD_TINY, "training_steps=2"]
    records = run_ranks(tmp_path / "record", [*args, f"output_dir={tmp_path / 'out'}"])
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-2"]
    assert sorted(r["_step"] for r in rows_of(run) if "loss_x/mean" in r) == [4, 8]
    assert_equal_params(records)
    assert_stripes(records, 0, 2 * 2, InfiniteSampler(N_IMAGES - 1, seed=42))
    forget = [rec["indices"][1][:4] for rec in records]
    assert forget[0] == forget[1] == [0, 0, 0, 0]

    rc, out = launch(WORKER, str(tmp_path / "record"), *args, "train_batch_size=1",
                     f"output_dir={tmp_path / 'odd'}")
    assert rc != 0 and "global batch 1 not divisible by 2 processes" in out


def test_delete_tshirt_fsdp_on_two_ranks(npz, tmp_path):
    wide = ["unet.block_out_channels=[128,128]", "checkpoint_path=null"]
    args = delete_args(npz, tmp_path / "out", "unused", *wide, "mesh.fsdp=2")
    (tmp_path / "record").mkdir()
    rc, out = launch(WORKER, str(tmp_path / "record"), *args)
    assert rc == 0, out[-4000:]
    assert out.count("mesh=data 1 x fsdp 2") == 2
    records = [torch.load(tmp_path / "record" / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert_equal_params(records)
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-3"]
    assert sorted(r["_step"] for r in rows_of(run) if "loss_x/mean" in r) == [1, 2, 3]
    # the bundle is whole: one process loads the UNet and the optimizer state
    mgr = CheckpointManager(str(run))
    unet = UNet2D(UNet2DConfig(**{**TSHIRT_28, "block_out_channels": (128, 128)}))
    unet.load_state_dict(mgr.restore_item("latest", "unet"))
    for k, v in unet.state_dict().items():
        assert torch.equal(v, records[0]["params"][k]), k
    state = mgr.restore_item("latest", "state")
    shapes = [p.shape for p in unet.parameters()]
    for i, st in state["optimizer"]["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == shapes[i]
    (task,) = cli.main(delete_args(npz, tmp_path / "one", "unused", *wide))
    keys = [set().union(*map(set, rows_of(r))) for r in (task.cfg.output_dir, run)]
    assert keys[0] == keys[1]


def test_delete_tshirt_tensor_on_two_ranks(npz, tmp_path):
    """``mesh.tensor=2``: each rank runs its block of every resnet's and
    attention block's channels; one run directory, a whole checkpoint that
    one process loads, a one-process run's keys."""
    attn = ["unet.down_block_types=[DownBlock2D,AttnDownBlock2D]",
            "unet.up_block_types=[AttnUpBlock2D,UpBlock2D]", "checkpoint_path=null"]
    args = delete_args(npz, tmp_path / "out", "unused", *attn, "mesh.tensor=2")
    (tmp_path / "record").mkdir()
    rc, out = launch(WORKER, str(tmp_path / "record"), *args)
    assert rc == 0, out[-4000:]
    assert out.count("mesh=data 1 x fsdp 1 x tensor 2") == 2
    records = [torch.load(tmp_path / "record" / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert_equal_params(records)
    # the tensor ranks share one block of the batch: both draw the one-rank
    # keep stream (3 steps × 4 rows; a loader's prefetch may draw further)
    stream = list(itertools.islice(iter(InfiniteSampler(80, seed=46)), 3 * 4))
    assert [rec["indices"][0][:3 * 4] for rec in records] == [stream, stream]
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-3"]
    assert sorted(r["_step"] for r in rows_of(run) if "loss_x/mean" in r) == [1, 2, 3]
    mgr = CheckpointManager(str(run))
    unet = UNet2D(UNet2DConfig(**{**TSHIRT_28, "block_out_channels": (16, 32),
                                  "down_block_types": ("DownBlock2D", "AttnDownBlock2D"),
                                  "up_block_types": ("AttnUpBlock2D", "UpBlock2D")}))
    unet.load_state_dict(mgr.restore_item("latest", "unet"))
    for k, v in unet.state_dict().items():
        assert torch.equal(v, records[0]["params"][k]), k
    state = mgr.restore_item("latest", "state")
    shapes = [p.shape for p in unet.parameters()]
    for i, st in state["optimizer"]["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == shapes[i]
    (task,) = cli.main(delete_args(npz, tmp_path / "one", "unused", *attn))
    keys = [set().union(*map(set, rows_of(r))) for r in (task.cfg.output_dir, run)]
    assert keys[0] == keys[1]


def test_delete_tshirt_fsdp_tensor_on_four_ranks(npz, tmp_path):
    """``mesh.fsdp=2 mesh.tensor=2`` on four ranks: the attention, GEGLU and
    resnet blocks of the tensor axis split once more over fsdp (the UNet at
    128 channels, wide enough for fsdp's 2^16-element floor); one run
    directory, a whole checkpoint that one process loads, a one-process
    run's keys."""
    wide = ["unet.block_out_channels=[128,128]",
            "unet.down_block_types=[DownBlock2D,AttnDownBlock2D]",
            "unet.up_block_types=[AttnUpBlock2D,UpBlock2D]", "checkpoint_path=null"]
    args = delete_args(npz, tmp_path / "out", "unused", *wide, "mesh.fsdp=2", "mesh.tensor=2")
    (tmp_path / "record").mkdir()
    rc, out = launch(WORKER, str(tmp_path / "record"), *args, nproc=4)
    assert rc == 0, out[-4000:]
    assert out.count("mesh=data 1 x fsdp 2 x tensor 2") == 4
    records = [torch.load(tmp_path / "record" / f"rank{r}.pt", weights_only=False)
               for r in range(4)]
    for rec in records[1:]:
        assert_equal_params([records[0], rec])
    run = only_run(tmp_path / "out")
    assert checkpoints(run) == ["checkpoint-3"]
    assert sorted(r["_step"] for r in rows_of(run) if "loss_x/mean" in r) == [1, 2, 3]
    mgr = CheckpointManager(str(run))
    unet = UNet2D(UNet2DConfig(**{**TSHIRT_28, "block_out_channels": (128, 128),
                                  "down_block_types": ("DownBlock2D", "AttnDownBlock2D"),
                                  "up_block_types": ("AttnUpBlock2D", "UpBlock2D")}))
    unet.load_state_dict(mgr.restore_item("latest", "unet"))
    for k, v in unet.state_dict().items():
        assert torch.equal(v, records[0]["params"][k]), k
    state = mgr.restore_item("latest", "state")
    shapes = [p.shape for p in unet.parameters()]
    for i, st in state["optimizer"]["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == shapes[i]
    (task,) = cli.main(delete_args(npz, tmp_path / "one", "unused", *wide))
    keys = [set().union(*map(set, rows_of(r))) for r in (task.cfg.output_dir, run)]
    assert keys[0] == keys[1]
