"""The port's CelebA-HQ unlearning task (siss_tpu_torch.tasks.delete_celeb)
and its data pieces against the JAX package, on the CPU at a tiny width.

The image-folder dataset, the repeated forget sampler and the task's keep /
forget streams must equal the JAX ones bit for bit (the same PIL decode and
numpy arithmetic). The denoising injection with ``pipeline.solver=dpm`` runs
the same float32 UNet and solver from carried weights and JAX-drawn noise:
within 1e-4, as tests/test_torch_sampling.py holds the solvers. A tiny
``--config-name=delete_celeb`` run through the command line logs the JAX
step's keys plus the task's, for ``training_steps × len(img_name)`` steps;
a resumed run ends bit for bit where a straight one does.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_parity
from siss_tpu.data import BatchLoader as JaxBatchLoader
from siss_tpu.data import InfiniteSampler as JaxInfiniteSampler
from siss_tpu.data import RepeatedSampler as JaxRepeatedSampler
from siss_tpu.data import dual_stream as jax_dual_stream
from siss_tpu.data.datasets import ImageFolderDataset as JaxImageFolderDataset
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.diffusion.schedule import q_sample as jax_q_sample
from siss_tpu.evaluate import Evaluator as JaxEvaluator
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch import main as cli
from siss_tpu_torch.config import load_config
from siss_tpu_torch.data import (BatchLoader, ImageFolderDataset, InfiniteSampler,
                                 RepeatedSampler, dual_stream)
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.tasks import DeleteCeleb
from siss_tpu_torch.tasks.delete_celeb import denoising_injection, read_target_image
from siss_tpu_torch.train import unet_eps_apply
from siss_tpu_torch.utils import CheckpointManager

FORGET = ["10000.jpg", "10003.jpg"]
TINY_UNET = ["unet._target_=siss_tpu.models.unet2d.UNet2DConfig", "+unet.sample_size=32",
             "+unet.in_channels=3", "+unet.out_channels=3", "+unet.block_out_channels=[16,32]",
             "+unet.down_block_types=[DownBlock2D,DownBlock2D]",
             "+unet.up_block_types=[UpBlock2D,UpBlock2D]", "+unet.norm_num_groups=8"]
METRICS_ON = ("metrics.fid={step_frequency: 2, num_imgs_to_generate: 4, batch_size: 2, "
              "class_cfg: {inception_batch_size: 4}}",
              "metrics.membership_loss={step_frequency: 2, timesteps: [10], class_cfg: "
              "{num_image_samples: 2, num_noise_samples: 2, eval_batch_size: 4}}")
# Keys the JAX DeleteCeleb adds to its step's (siss_tpu/tasks/delete_celeb.py:
# 199-234, 337) with the injection at t = 10, membership at t = 10 and FID-rand.
TASK_KEYS = {"images_per_sec", "Sampled Images/files", "Target Image Generations (t=10)/files",
             "metrics/fid_rand", "membership_loss/all_membership_loss_t=10",
             "membership_loss/deletion_membership_loss_t=10",
             "membership_loss/membership_ratio_t=10", "_step", "_time"}


def write_folder(root, gray=False):
    rng = np.random.default_rng(0)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            root / f"1000{i}.jpg")
    if gray:
        Image.fromarray(rng.integers(0, 255, (32, 32), dtype=np.uint8)).save(root / "20000.png")
        (root / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seven random 32² RGB JPEGs."""
    return write_folder(tmp_path_factory.mktemp("celeba"))


@pytest.mark.parametrize("filt", ["all", "deletion", "nondeletion"])
def test_image_folder_matches_jax(tmp_path, filt):
    """The JPEGs, a gray PNG and a file that is no image."""
    folder = write_folder(tmp_path, gray=True)
    ours, theirs = (cls(filt, folder, remove_img_names=FORGET)
                    for cls in (ImageFolderDataset, JaxImageFolderDataset))
    assert ours.image_files == theirs.image_files and len(ours) == len(theirs)
    assert len(ours) == {"all": 8, "deletion": 2, "nondeletion": 6}[filt]
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.dtype == b.dtype == np.float32 and a.ndim == 3
        np.testing.assert_array_equal(a, b)
    raw = ImageFolderDataset(filt, folder, remove_img_names=FORGET, normalize=False)[0]
    np.testing.assert_array_equal(raw, JaxImageFolderDataset(filt, folder, FORGET,
                                                             normalize=False)[0])


def test_image_folder_filter_errors(folder):
    for filt in ("deletion", "nondeletion"):
        with pytest.raises(ValueError, match="requires removal class"):
            ImageFolderDataset(filt, folder)
    with pytest.raises(ValueError, match="Invalid filter"):
        ImageFolderDataset("some", folder)


def test_repeated_sampler_matches_jax():
    ours, theirs = RepeatedSampler(3, 4), JaxRepeatedSampler(3, 4)
    assert list(ours) == list(theirs) == [0] * 4 + [1] * 4 + [2] * 4
    assert len(ours) == len(theirs) == 12


def test_celeb_streams_match_jax(folder):
    """The task's keep and forget streams, two forget images, 2 steps each
    at bs 2 × accum 2: the keep set shuffled from random_seed. The forget
    sampler repeats each image training_steps × accum × bs times with
    training_steps already multiplied by the number of images
    (siss_tpu/tasks/delete_celeb.py:76, :112), so in both packages the run
    draws only the first forget image."""
    steps, accum, bs, seed = 2 * len(FORGET), 2, 2, 42
    streams = []
    for ds_cls, loader, inf, rep, dual in (
            (ImageFolderDataset, BatchLoader, InfiniteSampler, RepeatedSampler, dual_stream),
            (JaxImageFolderDataset, JaxBatchLoader, JaxInfiniteSampler, JaxRepeatedSampler,
             jax_dual_stream)):
        keep = ds_cls("nondeletion", folder, FORGET)
        forget = ds_cls("deletion", folder, FORGET)
        it = dual(iter(loader(keep, inf(len(keep), seed=seed), bs)),
                  iter(loader(forget, rep(len(forget), steps * accum * bs), bs)), accum)
        streams.append([next(it) for _ in range(steps)])
    for ours, theirs in zip(*streams):
        for k in ("all", "deletion"):
            np.testing.assert_array_equal(ours[k], theirs[k])
    forget = ImageFolderDataset("deletion", folder, FORGET)
    np.testing.assert_array_equal(streams[0][0]["deletion"][0, 0], forget[0])
    assert all(np.array_equal(img, forget[0])
               for batch in streams[0] for img in batch["deletion"].reshape(-1, 32, 32, 3))


def test_denoising_injection_dpm_matches_jax(folder):
    """The target image noised with JAX-drawn noise to t = 40 and reverse
    diffused with DPM-Solver++(2M) in 3 model calls, from carried weights."""
    kwargs = dict(torch_parity.CELEB_LIKE, sample_size=32)
    jax_model, params, np_params = torch_parity.flax_unet(kwargs)
    model = torch_parity.torch_unet(kwargs, np_params).eval()
    clean = read_target_image(os.path.join(folder, FORGET[0]))
    n, t = 2, 40
    noise = np.array(jax.random.normal(jax.random.PRNGKey(42), (n, *clean.shape)))
    sched = JaxSchedule.create(1000)
    noisy = jax_q_sample(sched, jnp.broadcast_to(jnp.asarray(clean), (n, *clean.shape)),
                         jnp.asarray(noise), jnp.full((n,), t))
    jev = JaxEvaluator(lambda p, x, tt, c: jax_model.apply({"params": p}, x, tt), sched,
                       clean.shape, 4, random_seed=42, solver="dpm", injection_steps=3)
    want = jev.denoise_images(params, noisy, t)
    ours = NoiseSchedule.create(1000, device="cpu")
    ev = Evaluator(unet_eps_apply, ours, clean.shape, 4, random_seed=42, solver="dpm",
                   injection_steps=3)
    with torch.no_grad():
        got = denoising_injection(ev, ours, model, t, torch.from_numpy(clean), n,
                                  noise=torch.from_numpy(noise))
        again = [denoising_injection(ev, ours, model, t, torch.from_numpy(clean), n,
                                     generator=torch.Generator().manual_seed(42))
                 for _ in range(2)]
    assert got.shape == (n, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(*again)   # a generator seeded the same: the same panel


def jax_step_keys():
    """The JAX fused SISS step's metric keys, from tracing it (no compile)."""
    tx = optax.sgd(1.0)
    params = {"w": jnp.asarray(0.5), "b": jnp.asarray(0.1)}
    step = jax_build_step(lambda p, x, t, c: p["w"] * x + p["b"], JaxSchedule.create(1000), tx,
                          JaxStepConfig())
    batch = {k: jnp.zeros((1, 2, 8, 8, 1)) for k in ("all", "deletion")}
    _, metrics = jax.eval_shape(step, JaxState.create(params, tx), batch,
                                jax.random.PRNGKey(0), {})
    return set(metrics)


def celeb_args(folder, out, *extra):
    return ["--config-name=delete_celeb", "--device", "cpu", f"data_dir={folder}",
            f"output_dir={out}", "checkpoint_path=/nonexistent", "train_batch_size=2",
            "gradient_accumulation_steps=2", "eval_batch_size=2", "compute_dtype=float32",
            "pipeline.num_inference_steps=4", "metrics.denoising_injections.timestep=10",
            *TINY_UNET, *extra]


def rows_of(task):
    with open(os.path.join(str(task.cfg.output_dir), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_delete_celeb_two_forget_images(folder, tmp_path, capsys):
    """training_steps=2 over two forget images: 4 steps, each with the JAX
    step's keys; evaluations at steps 0, 2 and 4 with both panels, the
    membership keys and FID-rand; the random-weights warning."""
    (task,) = cli.main(celeb_args(folder, tmp_path, "training_steps=2", "sampling_steps=2",
                                  f"deletion.img_name=[{FORGET[0]},{FORGET[1]}]", *METRICS_ON))
    assert "WARNING: no pretrained weights at /nonexistent" in capsys.readouterr().out
    rows = rows_of(task)
    assert set().union(*map(set, rows)) == jax_step_keys() | TASK_KEYS
    steps = [r for r in rows if "loss_x/mean" in r]
    assert [r["_step"] for r in steps] == [1, 2, 3, 4]
    assert all(r["gradient/scaling_factor"] > 0 and r["images_per_sec"] > 0 for r in steps)
    assert all(np.isfinite(v) for r in steps for k, v in r.items() if k != "_time")
    for key in ("Sampled Images/files", "Target Image Generations (t=10)/files",
                "metrics/fid_rand", "membership_loss/membership_ratio_t=10"):
        assert [r["_step"] for r in rows if key in r] == [0, 2, 4], key
    assert all(np.isfinite(r["metrics/fid_rand"]) for r in rows if "metrics/fid_rand" in r)
    # two 32² images side by side, 2-pixel padding
    assert Image.open(rows[1]["Target Image Generations (t=10)/files"]).size == (70, 36)
    assert [r["step"] for r in task.eval_records] == [0, 2, 4]
    assert all(r["fid"] >= r["fid_compute"] >= 0 for r in task.eval_records)
    assert len(task.step_seconds) == 4 and len(task.eval_seconds) == 3
    assert {"state", "unet"} <= set(os.listdir(os.path.join(str(task.cfg.output_dir),
                                                            "checkpoint-4")))


def test_resume_is_exact(folder, tmp_path):
    """3 steps straight, against 2 steps, then a resume from checkpoint-2."""
    (task,) = cli.main(celeb_args(folder, tmp_path, "training_steps=3", "sampling_steps=0",
                                  "checkpointing_steps=2", "metrics.denoising_injections=null"))
    run_dir = str(task.cfg.output_dir)
    mgr = CheckpointManager(run_dir)
    assert [s for s, _ in mgr.list_checkpoints()] == [2, 3]
    straight = mgr.restore_item("latest", "state")
    cli.main(celeb_args(folder, tmp_path, "training_steps=3", "sampling_steps=0",
                        "metrics.denoising_injections=null",
                        f"resume_from_checkpoint={run_dir}/checkpoint-2"))
    again = mgr.restore_item("latest", "state")
    assert again["step"] == straight["step"] == 3
    for k, v in straight["model"].items():
        assert torch.equal(again["model"][k], v), k
    assert torch.equal(again["generator"], straight["generator"])


def test_pretrained_state_dict_and_bundle_load(folder, tmp_path):
    """A state-dict file with the port's (diffusers) names, and a port
    bundle's ``…/latest``, each become the task's starting weights."""
    cfg = load_config("delete_celeb", celeb_args(folder, tmp_path)[3:])
    task = DeleteCeleb(cfg, device="cpu")
    donor, _ = task.build_unet()
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.25)
    sd = donor.state_dict()
    torch.save(sd, tmp_path / "unet.pt")
    CheckpointManager(str(tmp_path / "base")).save_bundle(5, {"unet": sd})
    for path in (tmp_path / "unet.pt", tmp_path / "base" / "latest"):
        task.cfg.checkpoint_path = str(path)
        model, _ = task.build_unet()
        task._load_pretrained(model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (path, k)


def test_needs_a_card_unless_cpu_is_asked(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = load_config("delete_celeb", celeb_args(folder, tmp_path)[3:])
    with pytest.raises(RuntimeError, match="cuda"):
        DeleteCeleb(cfg)


def test_task_target_maps_to_the_port():
    cfg = load_config("delete_celeb")
    from siss_tpu_torch.config import get_object

    assert get_object(str(cfg.task._target_)) is DeleteCeleb
    assert Path(str(cfg.metrics.denoising_injections.img_path)).name == "10000.jpg"
