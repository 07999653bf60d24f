"""The port stands alone: siss_tpu_torch imports neither JAX nor the JAX
package, its entry points default to the card and raise without one, and
chip_smoke.py refuses to run without a card or outside the repository."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import siss_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(siss_tpu_torch.__path__, "siss_tpu_torch.")]
    assert {"siss_tpu_torch.ops.siss", "siss_tpu_torch.ops.build", "siss_tpu_torch.train.step",
            "siss_tpu_torch.models.unet2d", "siss_tpu_torch.utils.convert",
            "siss_tpu_torch.ops.flash_attention", "siss_tpu_torch.models.unet2d_cond",
            "siss_tpu_torch.diffusion.sd_pipeline", "siss_tpu_torch.profile_step",
            "siss_tpu_torch.main", "siss_tpu_torch.config.core", "siss_tpu_torch.data.datasets",
            "siss_tpu_torch.data.loader", "siss_tpu_torch.data.samplers",
            "siss_tpu_torch.data.synthetic", "siss_tpu_torch.diffusion.sampling",
            "siss_tpu_torch.evaluate", "siss_tpu_torch.metrics.tshirt",
            "siss_tpu_torch.tasks.base", "siss_tpu_torch.tasks.train_unconditional",
            "siss_tpu_torch.tasks.delete_tshirt", "siss_tpu_torch.utils.checkpoint",
            "siss_tpu_torch.utils.tracker", "siss_tpu_torch.utils.preemption",
            "siss_tpu_torch.tasks.delete_celeb", "siss_tpu_torch.metrics.fid",
            "siss_tpu_torch.metrics.inception_v3"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'siss_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = _run(["-c", code], cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["schedule", "unet", "sd_schedule", "unet_cond"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule
    from siss_tpu_torch.models import (UNet2DConditionConfig, UNet2DConfig, build_unet,
                                       build_unet_cond)

    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "schedule":
            NoiseSchedule.create(1000)
        elif entry == "sd_schedule":
            sd_noise_schedule()
        elif entry == "unet_cond":
            build_unet_cond(UNet2DConditionConfig.tiny())
        else:
            build_unet(UNet2DConfig(block_out_channels=(16, 32), norm_num_groups=8,
                                    down_block_types=("DownBlock2D", "DownBlock2D"),
                                    up_block_types=("UpBlock2D", "UpBlock2D")))


@pytest.mark.parametrize("config", ["train_tshirt_mnist", "delete_tshirt"])
def test_cli_defaults_to_cuda(config):
    """Without --device cpu the command line refuses a card-less host, naming
    cuda, before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = _run(["-m", "siss_tpu_torch.main", f"--config-name={config}",
                "output_dir=/nonexistent/never-written"], cwd=ROOT)
    assert out.returncode != 0
    assert "cuda" in out.stderr and "RuntimeError" in out.stderr
    assert "[siss_tpu_torch] task=" not in out.stdout


def test_tasks_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from siss_tpu_torch.config import load_config
    from siss_tpu_torch.tasks import DeleteTShirt, TrainUnconditional

    for cls, name in ((TrainUnconditional, "train_tshirt_mnist"), (DeleteTShirt, "delete_tshirt")):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(load_config(name))


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(["chip_smoke.py"], cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
