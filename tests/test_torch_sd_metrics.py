"""The port's SD metrics against the JAX package's, on the CPU:

- the CLIP vision tower (``models/clip_vision.py``) against flax's
  ``CLIPVisionModel`` through ``convert_clip_vision`` (≤ 1e-5 abs, fp32), and
  against the committed golden of ``tests/test_tower_goldens.py`` (its
  tolerance: rtol 1e-3, atol 1e-4); the port's name rule
  (``clip_vision_key``) key for key against ``convert_clip_vision``;
- the k-means classifier: labels identical to JAX's, near ties at 255 scale
  included, and its ``.npz`` and joblib artifacts;
- SSCD on one saved TorchScript file (≤ 1e-6);
- CLIP-IQA built from the same converted weights (≤ 1e-5), at a 64² → 224
  resize and a 512² → 224 resize;
- each metric's message when its file is missing.
"""

import io
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.metrics.clip_iqa import CLIPIQA as JaxCLIPIQA
from siss_tpu.metrics.kmeans_mem import KMeansMemClassifier as JaxKMeans
from siss_tpu.metrics.sscd import SSCDEvaluator as JaxSSCD
from siss_tpu.models.clip_vision import CLIPVisionConfig as FlaxVisionConfig
from siss_tpu.models.clip_vision import CLIPVisionModel as FlaxVisionModel
from siss_tpu.utils.sd_convert import convert_clip_vision
from siss_tpu_torch.metrics.clip_iqa import CLIPIQA, clip_image_embedder
from siss_tpu_torch.metrics.kmeans_mem import KMeansMemClassifier
from siss_tpu_torch.metrics.sscd import SSCDEvaluator
from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from siss_tpu_torch.utils.convert import clip_vision_key, params_from_flax
from tests.tower_goldens import load_golden, synth_state_dict

GOLDEN = "tests/goldens/clip_vision_golden.npz"
# A tower small enough for the tests that takes CLIP-IQA's 224² input.
IQA_TINY = dict(image_size=224, patch_size=32, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, projection_dim=16)


def flax_tower(cfg_kwargs, seed=0):
    model = FlaxVisionModel(FlaxVisionConfig(**cfg_kwargs))
    return model, model.init_params(jax.random.PRNGKey(seed))


def port_tower(cfg_kwargs, flax_params):
    model = CLIPVisionModel(CLIPVisionConfig(**cfg_kwargs))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, flax_params),
                                           clip_vision_key))
    return model.eval()


def test_vision_tower_matches_flax():
    cfg = FlaxVisionConfig.tiny().__dict__
    fmodel, params = flax_tower(cfg, seed=3)
    model = port_tower(cfg, params)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vision_tower_matches_the_recorded_golden():
    meta, imgs, want = load_golden(GOLDEN)
    model = CLIPVisionModel(CLIPVisionConfig.tiny())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in synth_state_dict(meta).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_clip_vision_key_matches_convert_clip_vision():
    """transformers' state dict → flax (``convert_clip_vision``) → the port's
    names (``clip_vision_key``) gives back every key and value."""
    meta, _, _ = load_golden(GOLDEN)
    sd = synth_state_dict(meta)
    _, template = flax_tower(FlaxVisionConfig.tiny().__dict__)
    back = params_from_flax(jax.tree.map(np.asarray, convert_clip_vision(sd, template)),
                            clip_vision_key)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def near_tie(rng, hw, margin):
    """An image and two centers at 255 scale, center 1 nearer by about
    ``margin`` in squared distance (~8e7 at 64²). The expanded form
    ‖x‖² − 2x·c + ‖c‖² would lose that margin to fp32 cancellation; the
    direct form keeps it."""
    d = hw * hw * 3
    img = rng.random((1, hw, hw, 3)).astype(np.float32)
    x = img.reshape(d).astype(np.float64) * 255.0
    c0 = x + rng.normal(0, 80, d)
    u = rng.normal(0, 1, d)
    c1 = x + u / np.linalg.norm(u) * np.sqrt(((x - c0) ** 2).sum() - margin)
    return img, np.stack([c0, c1]).astype(np.float32)


@pytest.mark.parametrize("hw", [8, 64])
def test_kmeans_labels_match_jax(hw):
    rng = np.random.default_rng(hw)
    imgs = rng.random((6, hw, hw, 3)).astype(np.float32)
    centers = (rng.random((5, hw * hw * 3)) * 255).astype(np.float32)
    ours = KMeansMemClassifier(centers, device="cpu")
    theirs = JaxKMeans(centers)
    np.testing.assert_array_equal(ours.predict(imgs), theirs.predict(imgs))
    assert ours.fraction(imgs) == theirs.fraction(imgs)
    # Near ties: margins of 1e3 down to 30 against squared distances of
    # ~8e7 (64²): the label is the float64 argmin's, and JAX's. (At a margin
    # of 30 the expanded form picks the wrong center about half the time.)
    for margin in (1e3, 100.0, 30.0):
        img, centers = near_tie(rng, hw, margin)
        flat = img.reshape(1, -1).astype(np.float64) * 255.0
        truth = ((flat[:, None] - centers[None].astype(np.float64)) ** 2).sum(-1).argmin(-1)
        got = KMeansMemClassifier(centers, device="cpu").predict(img)
        np.testing.assert_array_equal(got, JaxKMeans(centers).predict(img))
        np.testing.assert_array_equal(got, truth)


def test_kmeans_loads_npz_and_joblib(tmp_path):
    joblib = pytest.importorskip("joblib")
    rng = np.random.default_rng(0)
    centers = (rng.random((2, 2 * 2 * 3)) * 255).astype(np.float32)
    np.savez(tmp_path / "km.npz", centers=centers)
    joblib.dump(types.SimpleNamespace(cluster_centers_=centers), tmp_path / "km.joblib")
    imgs = rng.random((8, 2, 2, 3)).astype(np.float32)
    want = JaxKMeans(centers).predict(imgs)
    for name in ("km.npz", "km.joblib"):
        clf = KMeansMemClassifier.load(str(tmp_path / name), device="cpu")
        np.testing.assert_array_equal(clf.centers.numpy(), centers)
        np.testing.assert_array_equal(clf.predict(imgs), want)


class _Embedder(torch.nn.Module):
    """A small stand-in for the SSCD TorchScript model: conv, ReLU, pool,
    projection."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2)
        self.proj = torch.nn.Linear(8, 6)

    def forward(self, x):
        return self.proj(torch.relu(self.conv(x)).mean(dim=(2, 3)))


@pytest.fixture(scope="module")
def sscd_file(tmp_path_factory):
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("sscd") / "sscd.torchscript.pt"
    torch.jit.save(torch.jit.script(_Embedder().eval()), str(path))
    return str(path)


def test_sscd_matches_jax(sscd_file):
    rng = np.random.default_rng(1)
    imgs = rng.random((5, 24, 24, 3)).astype(np.float32)
    mem = rng.random((32, 32, 3)).astype(np.float32)
    ours = SSCDEvaluator.load(sscd_file, device="cpu")
    theirs = JaxSSCD.load(sscd_file)
    want = theirs.similarities(imgs, mem)
    got = ours.similarities(imgs, mem)
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.mean_similarity(imgs, mem), theirs.mean_similarity(imgs, mem),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.max_similarity(imgs, mem), theirs.max_similarity(imgs, mem),
                               rtol=0, atol=1e-6)


def jax_iqa_embed(fmodel, params):
    """The image embedding of ``siss_tpu.metrics.clip_iqa.CLIPIQA.try_load``
    over a given tower (``try_load`` builds ViT-L/14 from an orbax
    directory)."""
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    @jax.jit
    def embed(imgs):
        x = (imgs - mean) / std
        x = jax.image.resize(x, (x.shape[0], 224, 224, 3), "bilinear")
        e = fmodel.apply({"params": params}, x)
        return e / jnp.linalg.norm(e, axis=-1, keepdims=True)

    return embed


@pytest.mark.parametrize("size", [64, 512])
def test_clip_iqa_matches_jax(size):
    fmodel, params = flax_tower(IQA_TINY, seed=4)
    rng = np.random.default_rng(size)
    good, bad = rng.normal(size=(2, IQA_TINY["projection_dim"])).astype(np.float32)
    imgs = rng.random((3, size, size, 3)).astype(np.float32)
    want = JaxCLIPIQA(jax_iqa_embed(fmodel, params), good, bad).score(imgs)
    ours = CLIPIQA(clip_image_embedder(port_tower(IQA_TINY, params)), good, bad, device="cpu")
    np.testing.assert_allclose(ours.score(imgs), want, rtol=0, atol=1e-5)


def test_clip_iqa_loads_a_transformers_folder(tmp_path):
    """``<dir>/vision/`` with a state dict and its config.json, and
    ``<dir>/iqa_anchors.npz``: the same score as the tower built in memory."""
    fmodel, params = flax_tower(IQA_TINY, seed=5)
    model = port_tower(IQA_TINY, params)
    (tmp_path / "vision").mkdir()
    torch.save(model.state_dict(), tmp_path / "vision" / "pytorch_model.bin")
    names = {"num_layers": "num_hidden_layers", "num_heads": "num_attention_heads"}
    (tmp_path / "vision" / "config.json").write_text(
        __import__("json").dumps({names.get(k, k): v for k, v in IQA_TINY.items()}))
    rng = np.random.default_rng(2)
    good, bad = rng.normal(size=(2, IQA_TINY["projection_dim"])).astype(np.float32)
    np.savez(tmp_path / "iqa_anchors.npz", good=good, bad=bad)
    loaded = CLIPIQA.try_load(str(tmp_path), device="cpu")
    imgs = rng.random((2, 64, 64, 3)).astype(np.float32)
    want = CLIPIQA(clip_image_embedder(model), good, bad, device="cpu").score(imgs)
    assert loaded.score(imgs) == want


def test_missing_files_disable_their_metrics(tmp_path, monkeypatch):
    """The JAX package's messages, and None."""
    out = io.StringIO()
    monkeypatch.delenv("SISS_CLIP_DIR", raising=False)
    with redirect_stdout(out):
        assert SSCDEvaluator.load(str(tmp_path / "nope.pt"), device="cpu") is None
        assert CLIPIQA.try_load(str(tmp_path / "no_dir"), device="cpu") is None
        (tmp_path / "clip").mkdir()
        assert CLIPIQA.try_load(str(tmp_path / "clip"), device="cpu") is None
        monkeypatch.setenv("SISS_CLIP_DIR", str(tmp_path / "from_env"))
        assert CLIPIQA.try_load(device="cpu") is None
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[sscd] unavailable (") and lines[0].endswith("); metric disabled")
    assert lines[1] == f"[clip_iqa] no CLIP weights under {tmp_path / 'no_dir'}; metric disabled"
    assert lines[2].startswith("[clip_iqa] unavailable (") and "vision" in lines[2]
    assert lines[3] == f"[clip_iqa] no CLIP weights under {tmp_path / 'from_env'}; metric disabled"
    with pytest.raises(FileNotFoundError):
        KMeansMemClassifier.load(str(tmp_path / "nope.npz"), device="cpu")
