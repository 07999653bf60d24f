"""The port's SD memorization demo (``siss_tpu_torch/sd_memorization_demo.py``)
and dataset builder (``siss_tpu_torch/make_tshirt_dataset.py``) against
the JAX scripts ``scripts/sd_memorization_demo.py`` and
``scripts/make_tshirt_dataset.py``, on the CPU.

* ``make_dataset``: byte-identical PNGs, label and side files, and the same
  memorized image, for the same seed (the JAX script's function imports no
  JAX, so it is called from the script itself);
* the k-means centers: bit-identical to the JAX script's formula on the
  JAX package's ``SDData`` images;
* the VAE and UNet training losses: rtol 1e-5 against a JAX recomputation
  of the JAX script's losses with the same flax parameters and the same
  draws (the VAE's over three Adam steps, optax's ``adam`` against
  ``torch.optim.Adam``);
* a whole ``main`` run at a small depth writes ``before.json`` and
  ``after.json`` with the report's keys, and its model directory loads into
  the port's ``DeleteSD`` as it was written;
* ``main`` runs with TF32 off and cuDNN deterministic and sets the three
  switches back as they were; ``utils.checkpoint.load_frozen``, which
  builds its models, reads a bundle item or a weight file exactly;
* ``make_tshirt_dataset``: the synthetic and the idx sources write ``.npz``
  files equal array for array, and the same ``tshirt.png``, as the JAX
  script's.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu_torch import make_tshirt_dataset
from siss_tpu_torch import sd_memorization_demo as demo

ROOT = Path(__file__).resolve().parents[1]
RES = 16


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root: Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_make_dataset_matches_the_jax_script(tmp_path):
    jax_demo = _jax_script("sd_memorization_demo")
    got_dir, got_mem = demo.make_dataset(str(tmp_path / "port"), 5, RES,
                                         np.random.default_rng(3))
    want_dir, want_mem = jax_demo.make_dataset(str(tmp_path / "jax"), 5, RES,
                                               np.random.default_rng(3))
    assert Path(got_dir).relative_to(tmp_path / "port") == Path(want_dir).relative_to(tmp_path / "jax")
    np.testing.assert_array_equal(got_mem, want_mem)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(got) == 5 + 1 + 2 and got == want


def test_kmeans_centers_match_the_jax_script(tmp_path):
    from siss_tpu.data import SDData as JaxSDData
    from siss_tpu_torch.data import SDData

    img_dir, mem = demo.make_dataset(str(tmp_path), 4, RES, np.random.default_rng(0))
    labels = str(tmp_path / "kmeans_labels.json")
    # the JAX script's lines, on its package's images
    jax_ds = JaxSDData("nondeletion", img_dir, labels, resolution=RES)
    keep_imgs = np.stack([jax_ds[i][0] for i in range(len(jax_ds))])
    keep01 = (keep_imgs + 1.0) / 2.0
    want = np.stack([keep01.reshape(len(keep01), -1).mean(0) * 255.0, mem.reshape(-1) * 255.0])

    ds = SDData("nondeletion", img_dir, labels, resolution=RES)
    got = demo.kmeans_centers(np.stack([ds[i][0] for i in range(len(ds))]), mem)
    assert got.shape == (2, RES * RES * 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _flax_vae():
    from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
    from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
    from siss_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig
    from siss_tpu_torch.utils.convert import params_from_flax

    fvae = FlaxVAE(FlaxVAEConfig.tiny())
    params = jax.jit(functools.partial(fvae.init_params, image_size=RES))(jax.random.PRNGKey(1))
    vae = AutoencoderKL(AutoencoderKLConfig.tiny())
    vae.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return fvae, params, vae


def test_vae_losses_match_jax_over_adam_steps():
    fvae, params, vae = _flax_vae()
    sf = fvae.config.scaling_factor
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, RES, RES, 3)).astype(np.float32)
    noises = rng.normal(size=(3, 3, RES // 2, RES // 2, 4)).astype(np.float32)

    # scripts/sd_memorization_demo.py's vae_step, its draw given
    @jax.jit
    def jax_step(p, opt, noise):
        def loss_fn(p):
            mean, logvar = fvae.apply({"params": p}, x, method=fvae.encode_moments)
            z = mean + jnp.exp(0.5 * logvar) * noise
            rec = fvae.apply({"params": p}, z * sf, method=fvae.decode)
            kl = 0.5 * jnp.mean(mean ** 2 + jnp.exp(logvar) - 1.0 - logvar)
            return jnp.mean((rec - x) ** 2) + 1e-4 * kl

        loss, g = jax.value_and_grad(loss_fn)(p)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(p, up), opt, loss

    tx = optax.adam(2e-3)
    opt = tx.init(params)
    torch_opt = torch.optim.Adam(vae.parameters(), lr=2e-3)
    for noise in noises:
        params, opt, want = jax_step(params, opt, noise)
        got = demo.vae_loss(vae, torch.from_numpy(x), torch.from_numpy(noise))
        torch_opt.zero_grad()
        got.backward()
        torch_opt.step()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_unet_loss_matches_jax():
    from siss_tpu.diffusion.schedule import q_sample as jax_q_sample
    from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
    from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
    from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxUNetConfig
    from siss_tpu_torch.diffusion import sd_noise_schedule
    from siss_tpu_torch.models import UNet2DCondition
    from siss_tpu_torch.utils.convert import params_from_flax

    fvae, vae_params, vae = _flax_vae()
    unet_cfg, _, text_cfg = demo.demo_configs()
    funet = FlaxUNet(FlaxUNetConfig(**{**FlaxUNetConfig.tiny().__dict__,
                                       "attention_impl": "einsum"}))
    unet_params = jax.jit(funet.init_params)(jax.random.PRNGKey(2))
    unet = UNet2DCondition(unet_cfg)
    unet.load_state_dict(params_from_flax(jax.tree.map(np.asarray, unet_params)))

    n, bs, L, D = 5, 6, text_cfg.max_position_embeddings, text_cfg.hidden_size
    rng = np.random.default_rng(1)
    x_all = rng.uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)
    e_all = rng.normal(0, 0.5, (n, L, D)).astype(np.float32)
    # seed 5: a batch with an unconditional row and the memorized image
    draws = demo.draw_unet_batch(torch.Generator().manual_seed(5), n, bs, 0.33,
                                 (RES // 2, RES // 2, 4), 1000)
    d = {k: v.numpy() for k, v in draws.items()}
    assert d["drop"].any() and (d["idx"] == n - 1).any()

    # scripts/sd_memorization_demo.py's unet_step loss, its draws given
    @jax.jit
    def jax_loss(unet_params, vae_params):
        imgs, cond = x_all[d["idx"]], e_all[d["idx"]]
        cond = jnp.where(d["drop"][:, None, None], jnp.zeros_like(cond), cond)
        mean, logvar = fvae.apply({"params": vae_params}, imgs, method=fvae.encode_moments)
        z = (mean + jnp.exp(0.5 * logvar) * d["enc_noise"]) * fvae.config.scaling_factor
        t = jnp.asarray(d["t"], jnp.int32)
        noisy = jax_q_sample(jax_sd_schedule(), z, d["noise"], t)
        pred = funet.apply({"params": unet_params}, noisy, t, cond)
        return jnp.mean((pred - d["noise"]) ** 2)

    want = jax_loss(unet_params, vae_params)

    got = demo.unet_loss(unet, vae, sd_noise_schedule(device="cpu"), torch.from_numpy(x_all),
                         torch.from_numpy(e_all), draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_unet_draws_follow_the_jax_scripts_distribution():
    """Keep images uniform over 0..n−2, the memorized one (n − 1) at
    ``mem_freq``, unconditional rows at 0.1, timesteps over 0..999."""
    d = demo.draw_unet_batch(torch.Generator().manual_seed(0), 9, 40000, 0.33, (2, 2, 4), 1000)
    idx = d["idx"].numpy()
    assert idx.min() == 0 and idx.max() == 8
    assert abs((idx == 8).mean() - 0.33) < 0.01 and abs(d["drop"].float().mean() - 0.1) < 0.01
    counts = np.bincount(idx[idx < 8], minlength=8)
    assert counts.min() > 0.9 * counts.mean()
    assert d["t"].min() == 0 and d["t"].max() == 999
    assert d["noise"].shape == d["enc_noise"].shape == (40000, 2, 2, 4)


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """A whole ``--phase all`` run at a small depth, with its stdout."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("demo")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = demo.main(["--out", str(out), "--device", "cpu", "--vae-steps", "20",
                            "--pretrain-steps", "30", "--unlearn-steps", "2", "--eval-images",
                            "2", "--num-inference-steps", "5", "--validation-steps", "1"])
    return out, result, buf.getvalue()


def test_demo_writes_both_reports(demo_run):
    out, result, stdout = demo_run
    for name in ("before", "after"):
        with open(out / f"{name}.json") as f:
            report = json.load(f)
        assert set(report) == set(demo.REPORT_KEYS) and report == result[name]
        assert 0.0 <= report["mem_fraction"] <= 1.0 and 0.0 <= report["keep_fraction"] <= 1.0
        assert (out / f"samples_{name}.png").is_file()
    # one validation per step, at image counts (4 × 2 a step)
    assert [s for s, _ in result["series"]] == [8, 16]
    assert (out / "unlearn" / "checkpoint-2" / "unet" / "item.pt").is_file()
    assert "=== SD synthetic-memorization unlearning demo ===" in stdout
    with np.load(out / "kmeans_centers.npz") as z:
        assert z["centers"].shape == (2, 32 * 32 * 3)


def test_demo_model_directory_loads_into_delete_sd(demo_run):
    from siss_tpu_torch.config import load_config
    from siss_tpu_torch.tasks import DeleteSD

    out, _, stdout = demo_run
    assert "no converted weights" not in stdout
    task = DeleteSD(load_config("delete_sd", [f"pretrained_model_name_or_path={out / 'model'}",
                                              "model_variant=tiny"]), device="cpu")
    unet_cfg, vae_cfg, text_cfg = task._configs()
    assert (unet_cfg.block_out_channels, vae_cfg, text_cfg) == (
        demo.demo_configs()[0].block_out_channels, *demo.demo_configs()[1:])
    from siss_tpu_torch.models import build_clip_text, build_unet_cond, build_vae

    for sub, model, fname in (
            ("unet", build_unet_cond(unet_cfg, seed=9, device="cpu"), "diffusion_pytorch_model.bin"),
            ("vae", build_vae(vae_cfg, seed=9, device="cpu"), "diffusion_pytorch_model.bin"),
            ("text_encoder", build_clip_text(text_cfg, seed=9, device="cpu"), "pytorch_model.bin")):
        task._load_weights(sub, model)
        saved = torch.load(out / "model" / sub / fname, weights_only=True)
        got = model.state_dict()
        assert sorted(got) == sorted(saved)
        assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_demo_sets_its_switches_and_sets_them_back(tmp_path, monkeypatch):
    switches = ((torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
                (torch.backends.cudnn, "deterministic"))
    for obj, name in switches:
        monkeypatch.setattr(obj, name, name == "allow_tf32")
    seen = []
    monkeypatch.setattr(demo, "setup", lambda args, device: seen.append(
        [getattr(obj, name) for obj, name in switches]) or {"mem_fraction": 1.0})
    assert demo.main(["--phase", "setup", "--device", "cpu", "--out", str(tmp_path)]) == {
        "before": {"mem_fraction": 1.0}}
    assert seen == [[False, False, True]]
    assert [getattr(obj, name) for obj, name in switches] == [True, True, False]


def test_load_frozen_reads_a_bundle_item_or_a_weight_file(tmp_path):
    from siss_tpu_torch.models import AutoencoderKL, build_vae
    from siss_tpu_torch.utils.checkpoint import load_frozen, read_weights

    cfg = demo.demo_configs()[1]
    want = build_vae(cfg, seed=5, device="cpu").state_dict()
    (tmp_path / "item").mkdir()
    torch.save(want, tmp_path / "item" / "item.pt")
    (tmp_path / "bin").mkdir()
    torch.save(want, tmp_path / "bin" / "diffusion_pytorch_model.bin")
    for sub in ("item", "bin"):
        vae = load_frozen(lambda: AutoencoderKL(cfg), str(tmp_path / sub))
        got = vae.state_dict()
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        assert not vae.training and not any(p.requires_grad for p in vae.parameters())
    assert read_weights(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        load_frozen(lambda: AutoencoderKL(cfg), str(tmp_path))


def _write_idx(path: Path, array: np.ndarray) -> None:
    code = 0x08 << 8 | array.ndim
    header = code.to_bytes(4, "big") + b"".join(d.to_bytes(4, "big") for d in array.shape)
    path.write_bytes(header + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["synthetic", "idx"])
def test_make_tshirt_dataset_matches_the_jax_script(source, tmp_path, monkeypatch):
    args = ["--n-per-class", "6"]
    if source == "idx":
        rng = np.random.default_rng(0)
        mnist = tmp_path / "mnist"
        mnist.mkdir()
        _write_idx(mnist / "train-images-idx3-ubyte", rng.integers(0, 256, (20, 28, 28)))
        _write_idx(mnist / "train-labels-idx1-ubyte", rng.integers(0, 10, 20))
        _write_idx(mnist / "fashion-train-images-idx3-ubyte", rng.integers(0, 256, (12, 28, 28)))
        _write_idx(mnist / "fashion-train-labels-idx1-ubyte", np.arange(12) % 3)
        args = ["--mnist-dir", str(mnist)]
    got = make_tshirt_dataset.main(["--out", str(tmp_path / "port" / "d.npz"), *args])
    jax_main = _jax_script("make_tshirt_dataset").main
    monkeypatch.setattr(sys, "argv", ["make_tshirt_dataset.py", "--out",
                                      str(tmp_path / "jax" / "d.npz"), *args])
    jax_main()

    with np.load(tmp_path / "port" / "d.npz") as a, np.load(tmp_path / "jax" / "d.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["images", "labels"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["images"], got["images"])
    assert got["images"].shape[1:] == (28, 28, 1) and 10 in got["labels"]
    assert ((tmp_path / "port" / "tshirt.png").read_bytes()
            == (tmp_path / "jax" / "tshirt.png").read_bytes())
