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
            "siss_tpu_torch.models.unet2d", "siss_tpu_torch.utils.convert"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'siss_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = _run(["-c", code], cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["schedule", "unet"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.models import UNet2DConfig, build_unet

    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "schedule":
            NoiseSchedule.create(1000)
        else:
            build_unet(UNet2DConfig(block_out_channels=(16, 32), norm_num_groups=8,
                                    down_block_types=("DownBlock2D", "DownBlock2D"),
                                    up_block_types=("UpBlock2D", "UpBlock2D")))


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
