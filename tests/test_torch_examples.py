"""The port's examples (``siss_tpu_torch/examples/``) against the JAX
scripts of ``examples/`` and the JAX package's library calls, tiny and on
the CPU.

Each example's ``main(argv, config=<tiny>)`` runs on weights carried over
from flax (``utils/convert``) and written in the port's formats, and its
output is held to the JAX package's calls on the same weights, with JAX's
random draws injected into the port where the two packages draw apart:

* options: each port module's ``--help`` lists its JAX script's options
  (``--platform`` of the demo becomes ``--device``) plus ``--device``, and
  the parsers' defaults are equal;
* ``celeb_sampler``: the grid bit for bit against the port's own
  ``Evaluator.sample_images`` and ``make_grid_from_images`` for the same
  seed, from each checkpoint format;
* ``likelihood_eval``: bits/dim rtol 1e-5 after RK4 and 1e-4 after RK45
  (as ``tests/test_torch_likelihood.py``) and the same count of
  evaluations, JAX's Rademacher probe given to the port. RK4 runs a random
  UNet. RK45 runs the script on a checkpoint whose ``conv_out`` is zero
  (ε ≡ 0, so the drift −½β(t)·x is smooth in t): on a random UNet the
  adaptive solver's steps hang on the last bit of each stage time (the
  UNet's timestep and σ[⌊t·999⌋] are staircases in t: at one seed a tiny
  UNet with its time embedding zeroed took 300 evaluations in JAX and 288
  in the port, and JAX's own jitted and eager runs differ), and ``tests/test_torch_likelihood.py`` holds the UNet's
  RK45 with its timestep held;
* ``membership_curve``: the losses rtol 1e-5, JAX's noises given to the
  port through ``sample_noises(noise=...)``;
* ``sd_inference``: images and noise norms rtol 1e-4 / atol 1e-4 (four
  CFG steps of a tiny fp32 UNet at guidance 7.5), JAX's start latents
  given to the port;
* ``inference_time_mitigation``: token gradients rtol 2e-4 / atol 1e-6,
  ``aug_prompt`` rtol 5e-4 / atol 5e-5 (``tests/test_torch_sd_pipeline.py``),
  JAX's start latents given to the port;
* ``sscd_score``: similarities rtol 1e-5 on a small TorchScript model;
* ``webster_prompts``: the unchanged JAX script's prompt files are what
  the port's ``DeleteSD.fill_cfg`` reads.
"""

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CELEB_LIKE, MNIST_LIKE, flax_unet, torch_unet
from siss_tpu_torch.models import UNet2DConfig
from siss_tpu_torch.utils import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]

# (JAX script, port module)
PAIRS = [
    ("examples/celeb_sampler.py", "siss_tpu_torch.examples.celeb_sampler"),
    ("examples/likelihood_eval.py", "siss_tpu_torch.examples.likelihood_eval"),
    ("examples/membership_curve.py", "siss_tpu_torch.examples.membership_curve"),
    ("examples/sd_inference.py", "siss_tpu_torch.examples.sd_inference"),
    ("examples/inference_time_mitigation.py", "siss_tpu_torch.examples.inference_time_mitigation"),
    ("examples/sscd_score.py", "siss_tpu_torch.examples.sscd_score"),
    ("scripts/sd_memorization_demo.py", "siss_tpu_torch.sd_memorization_demo"),
    ("scripts/make_tshirt_dataset.py", "siss_tpu_torch.make_tshirt_dataset"),
]
# The dataset builder runs on the host, as its JAX script does: no --device.
HOST_ONLY = {"siss_tpu_torch.make_tshirt_dataset"}


def _help_options(args):
    out = subprocess.run([sys.executable, *args, "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=240, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-800:]
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", out.stdout)) - {"--help"}


class _Parsed(Exception):
    pass


def _defaults(main, monkeypatch):
    """{dest: default} of the parser ``main`` builds, caught at its
    ``parse_args`` (a JAX script's parses ``sys.argv``)."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        m.setattr(sys, "argv", ["prog"])
        with pytest.raises(_Parsed):
            main()
    return seen


@pytest.mark.parametrize("script,module", PAIRS, ids=[m.rsplit(".", 1)[1] for _, m in PAIRS])
def test_options_match_the_jax_script(script, module, monkeypatch):
    jax_opts = _help_options([script])
    port_opts = _help_options(["-m", module])
    want = (jax_opts - {"--platform"}) | (set() if module in HOST_ONLY else {"--device"})
    assert port_opts == want

    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(f"jax_{Path(script).stem}", ROOT / script)
    jax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mod)
    jax_defaults = _defaults(jax_mod.main, monkeypatch)
    port_defaults = _defaults(importlib.import_module(module).main, monkeypatch)
    jax_defaults.pop("platform", None)
    if module not in HOST_ONLY:
        assert port_defaults.pop("device") == "cuda"
    assert port_defaults == jax_defaults


# ---------------------------------------------------------------- celeb
def _write_checkpoint(kind, model, tmp_path):
    """``model``'s weights in one of the formats ``--checkpoint`` reads."""
    sd = model.state_dict()
    if kind in ("bundle", "latest"):
        CheckpointManager(str(tmp_path / "run")).save_bundle(3, {"unet": sd})
        return str(tmp_path / "run" / ("checkpoint-3" if kind == "bundle" else "latest"))
    path = tmp_path / "unet.bin"
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("kind", ["bundle", "latest", "state_dict"])
def test_celeb_sampler_grid_is_the_evaluators(kind, tmp_path):
    from PIL import Image

    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.evaluate import Evaluator
    from siss_tpu_torch.examples import celeb_sampler
    from siss_tpu_torch.models import UNet2D
    from siss_tpu_torch.train import unet_eps_apply

    _, _, np_params = flax_unet(CELEB_LIKE, seed=1)
    model = torch_unet(CELEB_LIKE, np_params)
    ckpt = _write_checkpoint(kind, model, tmp_path)
    out = tmp_path / "grid.png"
    got = celeb_sampler.main(["--checkpoint", ckpt, "--n", "4", "--steps", "5", "--seed", "3",
                              "--out", str(out), "--device", "cpu"],
                             config=UNet2DConfig(**CELEB_LIKE))

    ref = UNet2D(UNet2DConfig(**CELEB_LIKE), dtype=torch.bfloat16)
    ref.load_state_dict(model.state_dict())
    ev = Evaluator(unet_eps_apply, NoiseSchedule.create(1000, "linear", device="cpu"), (8, 8, 3),
                   num_inference_steps=5, random_seed=3)
    with torch.inference_mode():
        imgs = ev.sample_images(ref.eval(), 4, set_generator=True)
    want = (np.clip(Evaluator.make_grid_from_images(imgs), 0, 1) * 255).astype(np.uint8)
    assert want.shape == (2 * 8 + 3 * 2, 2 * 8 + 3 * 2, 3)
    np.testing.assert_array_equal(got["grid"], want)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


# ------------------------------------------------------------ likelihood
LIK_UNET = dict(sample_size=8, in_channels=1, out_channels=1, block_out_channels=(16, 32),
                down_block_types=("DownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "UpBlock2D"), layers_per_block=1,
                norm_num_groups=8, add_mid_attention=False)


def _write_pngs(tmp_path, arrays, prefix):
    from PIL import Image

    paths = []
    for i, a in enumerate(arrays):
        path = tmp_path / f"{prefix}{i}.png"
        Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a).save(path)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("method,rtol", [("rk4", 1e-5), ("rk45", 1e-4)])
def test_likelihood_eval_matches_jax(method, rtol, tmp_path, monkeypatch):
    from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
    from siss_tpu.diffusion.sde import VPSDE as JaxVPSDE
    from siss_tpu.metrics.likelihood import LikelihoodEvaluator as JaxLikelihood
    from siss_tpu_torch.examples import likelihood_eval
    from siss_tpu_torch.metrics.likelihood import LikelihoodEvaluator

    fmodel, params, np_params = flax_unet(LIK_UNET, seed=3)
    if method == "rk45":   # ε ≡ 0: see the module docstring
        params = {**params, "conv_out": jax.tree.map(jnp.zeros_like, params["conv_out"])}
        np_params = jax.tree.map(np.asarray, params)
    ckpt = _write_checkpoint("bundle", torch_unet(LIK_UNET, np_params), tmp_path)
    pixels = np.random.default_rng(4).integers(0, 256, (2, 8, 8, 1), dtype=np.uint8)
    paths = _write_pngs(tmp_path, pixels, "img")
    data = pixels.astype(np.float32) / 255.0 * 2 - 1

    key = jax.random.PRNGKey(5)
    jev = JaxLikelihood(lambda p, x, t, c: fmodel.apply({"params": p}, x, t), JaxVPSDE(),
                        schedule=JaxSchedule.create(1000, "linear"), method=method)
    jbpd, _, jnfe = jev.evaluate_likelihood(params, jnp.asarray(data), key=key)
    probe = np.array(jax.random.rademacher(key, data.shape, dtype=jnp.float32))
    monkeypatch.setattr(LikelihoodEvaluator, "draw_probe",
                        lambda self, shape, generator: torch.from_numpy(probe))
    got = likelihood_eval.main(["--checkpoint", ckpt, "--images", *paths, "--arch",
                                "mnist_tshirt", "--method", method, "--device", "cpu"],
                               config=UNet2DConfig(**LIK_UNET))
    assert got["images"] == paths and got["nfe"] == int(jnfe) > 0
    np.testing.assert_allclose(got["bpd"], np.asarray(jbpd), rtol=rtol)


# ------------------------------------------------------------ membership
def test_membership_curve_matches_jax(tmp_path, monkeypatch):
    from siss_tpu.data import LabeledImageDataset as JaxDataset
    from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
    from siss_tpu.metrics import MembershipLoss as JaxMembership
    from siss_tpu_torch.examples import membership_curve
    from siss_tpu_torch.metrics import MembershipLoss

    rng = np.random.default_rng(6)
    npz = tmp_path / "data.npz"
    np.savez(npz, images=rng.integers(0, 256, (24, 8, 8, 1), dtype=np.uint8),
             labels=np.repeat(np.arange(12) % 11, 2))
    fmodel, params, np_params = flax_unet(MNIST_LIKE, seed=2)
    ckpt = _write_checkpoint("bundle", torch_unet(MNIST_LIKE, np_params), tmp_path)

    ds = [JaxDataset.from_npz(f, str(npz), class_to_remove=10) for f in ("nondeletion", "deletion")]
    jml = JaxMembership(lambda p, x, t, c: fmodel.apply({"params": p}, x, t),
                        JaxSchedule.create(1000, "linear"), *ds, 6, 4, eval_batch_size=512)
    jml.sample_images()
    jml.sample_noises()
    timesteps = list(range(0, 1000, 250))
    want = jml.compute_membership_losses(params, timesteps)

    original = MembershipLoss.sample_noises
    monkeypatch.setattr(MembershipLoss, "sample_noises",
                        lambda self: original(self, noise=np.array(jml.noise)))
    out = tmp_path / "curve.png"
    got = membership_curve.main(["--checkpoint", ckpt, "--npz", str(npz), "--time-frequency",
                                 "250", "--num-images", "6", "--num-noises", "4", "--out",
                                 str(out), "--device", "cpu"], config=UNet2DConfig(**MNIST_LIKE))
    assert got["timesteps"] == timesteps and out.stat().st_size > 0
    np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want), rtol=1e-5)


# ------------------------------------------------------------------- SD
SD_UNET = dict(sample_size=8, block_out_channels=(32, 64),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               num_attention_heads=4, cross_attention_dim=32, norm_num_groups=8,
               attention_impl="einsum")
PROMPT = "a photo of the cat"


@pytest.fixture(scope="module")
def sd_model(tmp_path_factory):
    """A tiny SD model directory carried over from flax, and the JAX
    pipeline on the same weights."""
    from siss_tpu.diffusion.sd_pipeline import StableDiffusionPipeline as JaxPipeline
    from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
    from siss_tpu.models.clip_bpe import CLIPBPETokenizer as JaxTokenizer
    from siss_tpu.models.clip_text import CLIPTextConfig as FlaxClipConfig
    from siss_tpu.models.clip_text import CLIPTextModel as FlaxClip
    from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
    from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxUNetConfig
    from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
    from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
    from siss_tpu_torch.models import (AutoencoderKL, AutoencoderKLConfig, CLIPTextConfig,
                                       CLIPTextModel, UNet2DCondition, UNet2DConditionConfig)
    from siss_tpu_torch.utils.convert import clip_text_key, params_from_flax
    from test_torch_sd_tokenizer import _byte_vocab

    root = tmp_path_factory.mktemp("sd_model")
    (root / "tokenizer").mkdir()
    vocab, merges = _byte_vocab()
    (root / "tokenizer" / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                                   encoding="utf-8")
    (root / "tokenizer" / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                                   encoding="utf-8")
    funet, fvae, fclip = (FlaxUNet(FlaxUNetConfig(**SD_UNET)), FlaxVAE(FlaxVAEConfig.tiny()),
                          FlaxClip(FlaxClipConfig.tiny()))
    unet_p = jax.jit(funet.init_params)(jax.random.PRNGKey(0))
    vae_p = jax.jit(lambda k: fvae.init_params(k, image_size=16))(jax.random.PRNGKey(1))
    clip_p = jax.jit(fclip.init_params)(jax.random.PRNGKey(2))
    for sub, model, params, key_fn, fname in (
            ("unet", UNet2DCondition(UNet2DConditionConfig(**SD_UNET)), unet_p, None,
             "diffusion_pytorch_model.bin"),
            ("vae", AutoencoderKL(AutoencoderKLConfig.tiny()), vae_p, None,
             "diffusion_pytorch_model.bin"),
            ("text_encoder", CLIPTextModel(CLIPTextConfig.tiny()), clip_p, clip_text_key,
             "pytorch_model.bin")):
        np_params = jax.tree.map(np.asarray, params)
        model.load_state_dict(params_from_flax(np_params, *([key_fn] if key_fn else [])))
        (root / sub).mkdir()
        torch.save(model.state_dict(), root / sub / fname)
    jax_pipe = JaxPipeline(
        unet_apply=jax.jit(lambda p, x, t, c: funet.apply({"params": p}, x, t, c)),
        unet_params=unet_p,
        vae_decode=jax.jit(lambda p, z: fvae.apply({"params": p}, z, method=fvae.decode)),
        vae_params=vae_p, text_apply=lambda p, ids: fclip.apply({"params": p}, ids),
        text_params=clip_p,
        tokenizer=JaxTokenizer(str(root / "tokenizer" / "vocab.json"),
                               str(root / "tokenizer" / "merges.txt")),
        schedule=jax_sd_schedule(), latent_channels=4, vae_scale_factor=2)
    config = {"unet": UNet2DConditionConfig(**SD_UNET), "vae": AutoencoderKLConfig.tiny(),
              "text_encoder": CLIPTextConfig.tiny(), "dtype": torch.float32}
    return root, jax_pipe, config


def _start_latents(key):
    """JAX's start latents of the tiny pipeline: the first split of ``key``
    at 8 × 8 × 4."""
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(key)[1], (1, 8, 8, 4))))


def test_sd_inference_matches_jax(sd_model, tmp_path, monkeypatch):
    from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline
    from siss_tpu_torch.examples import sd_inference

    root, jax_pipe, config = sd_model
    key = jax.random.PRNGKey(7)
    pe = jax_pipe.encode_prompt(PROMPT, max_length=16)
    ue = jax_pipe.encode_prompt("", max_length=16)
    pe2, ue2 = (jnp.broadcast_to(e, (2, *e.shape[-2:])) for e in (pe, ue))
    want, want_norms = jax_pipe(pe2, ue2, key, height=16, width=16, num_inference_steps=4,
                                track_noise_norm=True)
    x_init = jnp.asarray(jax.random.normal(jax.random.split(key)[1], (2, 8, 8, 4)))
    original = StableDiffusionPipeline.__call__
    monkeypatch.setattr(StableDiffusionPipeline, "__call__", lambda self, *a, **kw: original(
        self, *a, x_init=torch.from_numpy(np.array(x_init)), **kw))

    np.savez(tmp_path / "embeds.npz", embeds=np.asarray(pe))
    runs = [sd_inference.main(["--model", str(root), *src, "--n", "2", "--steps", "4",
                               "--seed", "7", "--out", str(tmp_path / "sd.png"),
                               "--device", "cpu"], config=config)
            for src in (["--prompt", PROMPT], ["--prompt-embeds", str(tmp_path / "embeds.npz")])]
    for got in runs:
        assert got["images"].shape == (2, 16, 16, 3)
        np.testing.assert_allclose(got["images"], want, rtol=1e-4, atol=1e-4)
        for k in ("uncond_norm", "text_norm"):
            np.testing.assert_allclose(got[k], want_norms[k], rtol=1e-4, atol=1e-4)
    with pytest.raises(SystemExit, match="need --prompt"):
        sd_inference.main(["--model", str(root), "--device", "cpu"], config=config)


def test_inference_time_mitigation_matches_jax(sd_model, tmp_path, monkeypatch):
    from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline
    from siss_tpu_torch.examples import inference_time_mitigation

    root, jax_pipe, config = sd_model
    key = jax.random.PRNGKey(11)
    pe = jax_pipe.encode_prompt(PROMPT, max_length=16)
    ue = jax_pipe.encode_prompt("", max_length=16)
    want_grads = jax_pipe.get_text_cond_grad(pe, ue, key, height=16, width=16, target_steps=(0,))
    want_aug = jax_pipe.aug_prompt(pe, ue, key, height=16, width=16, target_steps=(0,), lr=0.1,
                                   optim_iters=3)
    monkeypatch.setattr(StableDiffusionPipeline, "_start_latents",
                        lambda self, generator, height, width, latents: _start_latents(key))
    out = tmp_path / "aug.npz"
    got = inference_time_mitigation.main(["--model", str(root), "--prompt", PROMPT, "--iters",
                                          "3", "--seed", "11", "--out", str(out), "--device",
                                          "cpu"], config=config)
    assert got["token_grads"].shape == (16,) and got["token_grads"].max() > 0
    np.testing.assert_allclose(got["token_grads"], want_grads, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got["embeds"], np.asarray(want_aug), rtol=5e-4, atol=5e-5)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["embeds"], got["embeds"])
    # the file is a prompt for sd_inference and DeleteSD
    np.testing.assert_array_equal(
        StableDiffusionPipeline.load_prompt_embeds(str(out)).numpy(), got["embeds"])


# ------------------------------------------------------------------ SSCD
def test_sscd_score_matches_jax(tmp_path):
    from siss_tpu.metrics.sscd import SSCDEvaluator as JaxSSCD
    from siss_tpu_torch.examples import sscd_score

    torch.manual_seed(0)
    embedder = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, stride=2), torch.nn.ReLU(),
                                   torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
                                   torch.nn.Linear(8, 16)).eval()
    model = tmp_path / "sscd.pt"
    torch.jit.save(torch.jit.script(embedder), str(model))
    pixels = np.random.default_rng(8).integers(0, 256, (3, 12, 12, 3), dtype=np.uint8)
    target, *images = _write_pngs(tmp_path, pixels, "sscd")
    got = sscd_score.main(["--model", str(model), "--target", target, "--images", *images,
                           "--device", "cpu"])
    imgs01 = pixels.astype(np.float32) / 255.0
    want = JaxSSCD.load(str(model)).similarities(imgs01[1:], imgs01[0])
    assert got["images"] == images and got["sims"].shape == (2,)
    np.testing.assert_allclose(got["sims"], want, rtol=1e-5)
    with pytest.raises(SystemExit) as exc:
        sscd_score.main(["--model", str(tmp_path / "absent.pt"), "--target", target,
                         "--images", *images, "--device", "cpu"])
    assert exc.value.code == 1


# --------------------------------------------------------------- webster
def test_webster_prompts_feed_the_ports_delete_sd(tmp_path, monkeypatch):
    """The JAX script is not copied: it imports neither package. The
    prompt files it writes are the ones the port's DeleteSD reads. The
    script runs as ``__main__`` in this process: a child process that has
    read parquet can abort in pyarrow's teardown at its exit ("terminate
    called without an active exception") after its work is done."""
    import runpy

    import pandas as pd

    from siss_tpu_torch.config import load_config
    from siss_tpu_torch.tasks import DeleteSD

    pd.DataFrame({"caption": ["a faint caption", "the memorized caption of a man"],
                  "sscd_score": [0.2, 0.9]}).to_parquet(tmp_path / "gt.parquet")
    script = ROOT / "examples" / "webster_prompts.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--parquet", str(tmp_path / "gt.parquet"),
                                      "--name", "someone", "--out-dir", str(tmp_path / "prompts")])
    runpy.run_path(str(script), run_name="__main__")
    cfg = load_config("delete_sd", [f"base_dir={tmp_path}", "images_name=someone",
                                    f"og_prompts_path={tmp_path / 'prompts' / 'original_prompts.json'}",
                                    f"modified_prompts_path={tmp_path / 'prompts' / 'modified_prompts.json'}"])
    task = DeleteSD(cfg, device="cpu")
    task.fill_cfg()
    assert list(task.cfg.validation_prompts) == ["the memorized caption of a man",
                                                 "the memorized caption of a"]
    assert not task.cfg.using_augmented_prompt
