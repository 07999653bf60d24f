"""The port stands alone: siss_tpu_torch imports neither JAX nor the JAX
package, its entry points default to the card and raise without one, and
chip_smoke.py refuses to run without a card or outside the repository."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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
            "siss_tpu_torch.metrics.inception_v3", "siss_tpu_torch.models.vae",
            "siss_tpu_torch.models.clip_text", "siss_tpu_torch.models.clip_bpe",
            "siss_tpu_torch.data.latent_cache", "siss_tpu_torch.tasks.delete_sd",
            "siss_tpu_torch.models.clip_vision", "siss_tpu_torch.metrics.kmeans_mem",
            "siss_tpu_torch.metrics.sscd", "siss_tpu_torch.metrics.clip_iqa",
            "siss_tpu_torch.ops.batched", "siss_tpu_torch.parallel",
            "siss_tpu_torch.parallel.distributed", "siss_tpu_torch.parallel.mesh",
            "siss_tpu_torch.parallel.multihost", "siss_tpu_torch.parallel.fsdp",
            "siss_tpu_torch.parallel.tensor", "siss_tpu_torch.serve",
            "siss_tpu_torch.data.shapes", "siss_tpu_torch.utils.export",
            "siss_tpu_torch.utils.hf_convert", "siss_tpu_torch.examples.celeb_sampler",
            "siss_tpu_torch.examples.likelihood_eval", "siss_tpu_torch.examples.membership_curve",
            "siss_tpu_torch.examples.sd_inference",
            "siss_tpu_torch.examples.inference_time_mitigation",
            "siss_tpu_torch.examples.sscd_score", "siss_tpu_torch.sd_memorization_demo",
            "siss_tpu_torch.make_tshirt_dataset"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'siss_tpu', 'examples', 'scripts'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = _run(["-c", code], cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


# Each example and the demo without --device, with the options it requires.
EXAMPLE_ARGS = {
    "examples.celeb_sampler": ["--checkpoint", "/nonexistent"],
    "examples.likelihood_eval": ["--checkpoint", "/nonexistent", "--images", "a.png"],
    "examples.membership_curve": ["--checkpoint", "/nonexistent", "--npz", "/nonexistent.npz"],
    "examples.sd_inference": ["--model", "/nonexistent", "--prompt", "a"],
    "examples.inference_time_mitigation": ["--model", "/nonexistent", "--prompt", "a"],
    "examples.sscd_score": ["--model", "/nonexistent.pt", "--target", "a.png", "--images",
                            "b.png"],
    "sd_memorization_demo": ["--out", "/nonexistent/never-written"],
}


@pytest.mark.parametrize("entry", ["schedule", "unet", "sd_schedule", "unet_cond", "vae",
                                   "clip_text", "clip_vision", "kmeans", "clip_iqa",
                                   "distributed", "serve", *EXAMPLE_ARGS])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from siss_tpu_torch.diffusion import NoiseSchedule, sd_noise_schedule
    from siss_tpu_torch.models import (AutoencoderKLConfig, CLIPTextConfig,
                                       UNet2DConditionConfig, UNet2DConfig, build_clip_text,
                                       build_unet, build_unet_cond, build_vae)

    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "schedule":
            NoiseSchedule.create(1000)
        elif entry == "sd_schedule":
            sd_noise_schedule()
        elif entry == "unet_cond":
            build_unet_cond(UNet2DConditionConfig.tiny())
        elif entry == "vae":
            build_vae(AutoencoderKLConfig.tiny())
        elif entry == "clip_text":
            build_clip_text(CLIPTextConfig.tiny())
        elif entry == "clip_vision":
            from siss_tpu_torch.models import CLIPVisionConfig, build_clip_vision

            build_clip_vision(CLIPVisionConfig.tiny())
        elif entry == "kmeans":
            from siss_tpu_torch.metrics.kmeans_mem import KMeansMemClassifier

            KMeansMemClassifier(np.zeros((2, 12), np.float32))
        elif entry == "distributed":
            # a two-rank launch without --device cpu: no group, no CPU fallback
            from siss_tpu_torch.parallel import is_initialized, maybe_initialize_distributed

            monkeypatch.setenv("WORLD_SIZE", "2")
            try:
                maybe_initialize_distributed()
            finally:
                assert not is_initialized()
        elif entry == "serve":
            from siss_tpu_torch.serve import SamplerService

            SamplerService("/nonexistent/checkpoint", arch="mnist_tshirt")
        elif entry in EXAMPLE_ARGS:
            import importlib

            importlib.import_module(f"siss_tpu_torch.{entry}").main(EXAMPLE_ARGS[entry])
        elif entry == "clip_iqa":
            from siss_tpu_torch.metrics.clip_iqa import CLIPIQA

            CLIPIQA(lambda imgs: imgs, np.ones(4, np.float32), -np.ones(4, np.float32))
        else:
            build_unet(UNet2DConfig(block_out_channels=(16, 32), norm_num_groups=8,
                                    down_block_types=("DownBlock2D", "DownBlock2D"),
                                    up_block_types=("UpBlock2D", "UpBlock2D")))


@pytest.mark.parametrize("config", ["train_tshirt_mnist", "delete_tshirt", "delete_sd"])
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
    from siss_tpu_torch.tasks import DeleteSD, DeleteTShirt, TrainUnconditional

    for cls, name in ((TrainUnconditional, "train_tshirt_mnist"), (DeleteTShirt, "delete_tshirt"),
                      (DeleteSD, "delete_sd")):
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
