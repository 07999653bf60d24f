"""The port's t-shirt tasks end to end on the CPU, at a tiny size: the
pretrain task writes its bundle, the unlearning task starts from its
``unet_ema`` and writes ``metrics.jsonl`` with the JAX package's keys and a
PNG panel, all through ``python -m siss_tpu_torch.main --device cpu``
(mirroring tests/test_pretrain_task.py). Also: checkpoint rotation,
``latest``, an exact resume, the step gates under ``steps_per_call`` and
the preemption stop."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.tasks.base import boundary_crossed as jax_boundary_crossed
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch import main as cli
from siss_tpu_torch.tasks import boundary_crossed
from siss_tpu_torch.utils import CheckpointManager, PreemptionGuard
from siss_tpu_torch.utils.tracker import Tracker, write_png

ROOT = Path(__file__).resolve().parents[1]
TINY_UNET = ["unet.block_out_channels=[16,32]", "unet.down_block_types=[DownBlock2D,DownBlock2D]",
             "unet.up_block_types=[UpBlock2D,UpBlock2D]", "+unet.norm_num_groups=8"]
# Keys the JAX DeleteTShirt adds to its step's metrics (siss_tpu/tasks/delete_tshirt.py).
TASK_KEYS = {"images_per_sec", "metrics/deletion_class_fraction", "Sampled Images/files",
             "_step", "_time"}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    from siss_tpu_torch.data import make_synthetic_mnist_tshirt

    path = tmp_path_factory.mktemp("data") / "data.npz"
    images, labels = make_synthetic_mnist_tshirt(n_per_class=8)
    np.savez(path, images=images, labels=labels)
    return str(path)


def pretrain_args(npz, out, *extra):
    return ["--config-name=train_tshirt_mnist", "--device", "cpu", f"dataset.path={npz}",
            f"output_dir={out}", "num_epochs=1", "train_batch_size=16", "eval_batch_size=4",
            "sampling_steps=2", "lr_warmup_steps=2", "pipeline.num_inference_steps=4",
            *TINY_UNET, *extra]


def delete_args(npz, out, base, *extra):
    return ["--config-name=delete_tshirt", "--device", "cpu", f"dataset_all.path={npz}",
            f"dataset_deletion.path={npz}", f"dataset.path={npz}", f"output_dir={out}",
            f"checkpoint_path={base}/latest", "training_steps=3", "train_batch_size=4",
            "eval_images=4", "eval_batch_size=4", "sampling_steps=2", "metrics.likelihood=null",
            "pipeline.num_inference_steps=4", *TINY_UNET, *extra]


def rows_of(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def only_run(parent):
    (run,) = [p for p in Path(parent).iterdir() if p.is_dir()]
    return str(run)


def run_cli(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "siss_tpu_torch.main", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture(scope="module")
def base_run(npz, tmp_path_factory):
    """The pretrain bundle, made through the command line."""
    out = tmp_path_factory.mktemp("base")
    run_cli(pretrain_args(npz, out))
    return only_run(out)


def jax_deletion_metric_keys():
    """The JAX fused SISS step's metric keys, from tracing it (no compile)
    on a linear ε model: the keys do not depend on the model."""
    tx = optax.sgd(1.0)
    params = {"w": jnp.asarray(0.5), "b": jnp.asarray(0.1)}
    step = jax_build_step(lambda p, x, t, c: p["w"] * x + p["b"], JaxSchedule.create(1000), tx,
                          JaxStepConfig())
    batch = {k: jnp.zeros((1, 2, 8, 8, 1)) for k in ("all", "deletion")}
    _, metrics = jax.eval_shape(step, JaxState.create(params, tx), batch,
                                jax.random.PRNGKey(0), {})
    return set(metrics)


def test_cli_pretrain_then_delete_handoff(npz, base_run, tmp_path):
    rows = rows_of(base_run)
    assert set().union(*map(set, rows)) == {"loss", "gradient/pre_clip_norm", "images_per_sec",
                                            "Sampled Images/files", "_step", "_time"}
    assert {"state", "unet", "unet_ema"} == set(
        os.listdir(os.path.join(base_run, "checkpoint-5")))  # 88 images / bs 16

    run_cli(delete_args(npz, tmp_path / "del", base_run))
    out = only_run(tmp_path / "del")
    rows = rows_of(out)
    keys = set().union(*map(set, rows))
    assert keys == jax_deletion_metric_keys() | TASK_KEYS
    step_rows = [r for r in rows if "loss_x/mean" in r]
    assert [r["_step"] for r in step_rows] == [1, 2, 3]
    assert all(r["gradient/scaling_factor"] > 0 for r in step_rows)
    assert all(np.isfinite(v) for r in step_rows for k, v in r.items() if k != "_time")
    fractions = [r for r in rows if "metrics/deletion_class_fraction" in r]
    assert [r["_step"] for r in fractions] == [0, 2]   # step 0, then each 2 steps
    from PIL import Image

    panel = rows[0]["Sampled Images/files"]
    assert Image.open(panel).size == (2 * 28 + 3 * 2,) * 2   # 4 images, 2 × 2 grid
    assert {"state", "unet", "unet_ema"} >= set(os.listdir(os.path.join(out, "checkpoint-3")))
    assert json.load(open(os.path.join(out, "config.json")))["deletion"]["scaling_norm"] == 5


def test_images_per_sec_is_the_jax_wall_rate(npz, base_run, tmp_path, monkeypatch):
    """images_per_sec as the JAX task defines it (siss_tpu/tasks/delete_tshirt.py:
    251, 295-298): a pass's k_done·bs·accum images over the wall time since
    the previous pass ended, so the evaluation after a pass counts in the next
    one. On a patched clock each read advances 1 s and each evaluation 100 s;
    steps_per_call=2 over 5 steps runs passes of 2, 2 and 1 steps, with
    evaluations at steps 0, 2 and 4."""
    from types import SimpleNamespace

    from siss_tpu_torch.evaluate import Evaluator
    from siss_tpu_torch.tasks import delete_tshirt

    clock = [0.0]

    def read():
        clock[0] += 1.0
        return clock[0]

    sample = Evaluator.sample_images

    def slow_sample(self, *args, **kwargs):
        clock[0] += 100.0
        return sample(self, *args, **kwargs)

    monkeypatch.setattr(delete_tshirt, "time", SimpleNamespace(time=read))
    monkeypatch.setattr(Evaluator, "sample_images", slow_sample)
    (task,) = cli.main(delete_args(npz, tmp_path, base_run, "training_steps=5",
                                   "steps_per_call=2"))
    images = int(task.cfg.train_batch_size) * int(task.cfg.gradient_accumulation_steps)
    rows = [r for r in rows_of(str(task.cfg.output_dir)) if "loss_x/mean" in r]
    assert [r["_step"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["images_per_sec"] for r in rows] == pytest.approx(
        [2 * images / 1, 2 * images / 1, 2 * images / 101, 2 * images / 101, images / 101])
    assert len(task.step_seconds) == 5 and all(0 < s < 100 for s in task.step_seconds)


def test_delete_starts_from_unet_ema(npz, base_run, tmp_path):
    (task,) = cli.main(delete_args(npz, tmp_path, base_run, "training_steps=0",
                                   "sampling_steps=0"))
    final = CheckpointManager(str(task.cfg.output_dir)).restore_item("latest", "unet")
    ema = CheckpointManager(base_run).restore_item("latest", "unet_ema")
    raw = CheckpointManager(base_run).restore_item("latest", "unet")
    assert sorted(final) == sorted(ema)
    assert all(torch.equal(final[k], ema[k]) for k in ema)
    assert not all(torch.equal(raw[k], ema[k]) for k in ema)


def test_resume_is_exact(npz, base_run, tmp_path):
    """4 steps straight, against 2 steps, then a resume from checkpoint-2."""
    (task,) = cli.main(delete_args(npz, tmp_path, base_run, "training_steps=4",
                                   "checkpointing_steps=2", "sampling_steps=0"))
    run_dir = str(task.cfg.output_dir)
    mgr = CheckpointManager(run_dir)
    assert [s for s, _ in mgr.list_checkpoints()] == [2, 4]
    straight = mgr.restore_item(os.path.join(run_dir, "checkpoint-4"), "state")
    (resumed,) = cli.main(delete_args(npz, tmp_path, base_run, "training_steps=4",
                                      "sampling_steps=0",
                                      f"resume_from_checkpoint={run_dir}/checkpoint-2"))
    assert str(resumed.cfg.output_dir) == run_dir
    again = mgr.restore_item("latest", "state")
    assert again["step"] == straight["step"] == 4
    for k, v in straight["model"].items():
        assert torch.equal(again["model"][k], v), k
    assert torch.equal(again["generator"], straight["generator"])


def test_pretrain_steps_per_call_gates(npz, tmp_path):
    """steps_per_call=4 over 10 steps (88 images / bs 16 × 2 epochs) runs
    blocks of 4, 4, 2: the every-6 checkpoint gate fires at the end of the
    block that crosses 6, and the run ends at 10 (with random flips on)."""
    (task,) = cli.main(pretrain_args(npz, tmp_path, "num_epochs=2", "sampling_steps=0",
                                     "+steps_per_call=4", "checkpointing_steps=6",
                                     "random_flip=true"))
    steps = [s for s, _ in CheckpointManager(str(task.cfg.output_dir)).list_checkpoints()]
    assert steps == [8, 10]
    assert len(task.step_seconds) == 10


@pytest.mark.parametrize("every", [0, None, 1, 3, 6])
def test_boundary_crossed_matches_jax(every):
    for prev in range(-1, 14):
        for k in (1, 2, 4):
            assert (boundary_crossed(prev, prev + k, every)
                    == jax_boundary_crossed(prev, prev + k, every))


def test_preemption_saves_and_stops(npz, base_run, tmp_path):
    guard = PreemptionGuard()
    guard._stop.set()
    try:
        (task,) = cli.main(delete_args(npz, tmp_path, base_run, "training_steps=5",
                                       "sampling_steps=0"))
    finally:
        guard.reset()
    mgr = CheckpointManager(str(task.cfg.output_dir))
    assert [s for s, _ in mgr.list_checkpoints()] == [0]
    assert mgr.restore_item("latest", "state")["step"] == 0


def test_unported_options_raise(npz, base_run, tmp_path):
    # The likelihood metric is ported (tests/test_torch_tshirt_metrics.py).
    with pytest.raises(NotImplementedError, match="item 12"):
        cli.main(delete_args(npz, tmp_path, base_run, "mesh.fsdp=2"))


def test_checkpoint_rotation_latest_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), total_limit=2, async_save=True)
    for step in (1, 2, 3, 4):
        mgr.save_bundle(step, {"state": {"step": step, "w": torch.full((2,), float(step))},
                               "unet_ema": None})
    mgr.wait()
    assert [s for s, _ in mgr.list_checkpoints()] == [3, 4]
    assert mgr.latest().endswith("checkpoint-4")
    assert sorted(os.listdir(mgr.latest())) == ["state"]   # None items are skipped
    got = mgr.restore_item("latest", "state")
    assert got["step"] == 4 and torch.equal(got["w"], torch.full((2,), 4.0))
    assert mgr.restore_item("checkpoint-3", "state")["step"] == 3
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_item("latest", "state")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_panels_decode(tmp_path, channels):
    from PIL import Image

    img = np.random.default_rng(channels).integers(0, 256, (5, 7, channels), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    got = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)

    tracker = Tracker("p", str(tmp_path / "run"), config={"a": 1})
    tracker.log_images("Sampled Images", np.full((2, 3, 3, channels), 0.5, np.float32), step=7)
    tracker.log({"x": torch.tensor(2.5)}, step=7)
    tracker.log_summary("deletion_steps", 7)
    tracker.finish()
    rows = rows_of(str(tmp_path / "run"))
    assert len(rows[0]["Sampled Images/files"]) == 2 and rows[1]["x"] == 2.5
    assert json.load(open(tmp_path / "run" / "summary.json")) == {"deletion_steps": 7}
