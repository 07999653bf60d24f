"""The port's FID (siss_tpu_torch.metrics.{fid,inception_v3}) against the JAX
package's, on the CPU.

Tolerances: the Fréchet distance runs the same float64 numpy/scipy
arithmetic in both packages, so it is held at rtol 1e-10 (and the evaluator,
which feeds both the same features, at 1e-12). InceptionV3 with the golden
synthetic weights (tests/tower_goldens.py) is held to the recorded torch
features and to JAX's ``InceptionV3Features`` through ``_convert_inception``
within 1e-3, as tests/test_tower_goldens.py holds the JAX one; JAX's forward
runs at 96² here (its cost at 299² is ~50 s on this CPU), the recorded
features at 299². The random-projection embedder with carried flax params and
the 299² resize are fp32 throughout: 1e-5.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.metrics.fid import FIDEvaluator as JaxFID
from siss_tpu.metrics.fid import frechet_distance as jax_frechet
from siss_tpu.metrics.inception_v3 import InceptionV3Features as JaxInception
from siss_tpu.metrics.inception_v3 import RandomEmbedder as JaxRandomEmbedder
from siss_tpu.metrics.inception_v3 import _convert_inception
from siss_tpu_torch.data import ArrayDataset
from siss_tpu_torch.metrics.fid import FIDEvaluator, frechet_distance
from siss_tpu_torch.metrics.inception_v3 import (
    InceptionV3Features,
    build_fid_evaluator,
    embedding_feature_fn,
    load_inception_state_dict,
    make_inception_feature_fn,
    random_embedder_from_flax,
    resize_to_inception,
)
from tests.tower_goldens import load_golden, synth_state_dict

GOLDENS = Path(__file__).parent / "goldens"


def random_spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + 0.1 * np.eye(d)


@pytest.mark.parametrize("d", [4, 32])
def test_frechet_distance_matches_jax(d):
    rng = np.random.default_rng(d)
    args = (rng.normal(size=d), random_spd(rng, d), rng.normal(size=d), random_spd(rng, d))
    np.testing.assert_allclose(frechet_distance(*args), jax_frechet(*args), rtol=1e-10)


def test_frechet_distance_diagonal_closed_form():
    """Diagonal covariances: ‖μ₁−μ₂‖² + Σ(a + b − 2√(ab))."""
    rng = np.random.default_rng(1)
    a, b = rng.uniform(0.5, 2.0, 16), rng.uniform(0.5, 2.0, 16)
    mu1, mu2 = rng.normal(size=16), rng.normal(size=16)
    want = ((mu1 - mu2) ** 2).sum() + (a + b - 2 * np.sqrt(a * b)).sum()
    got = frechet_distance(mu1, np.diag(a), mu2, np.diag(b))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, jax_frechet(mu1, np.diag(a), mu2, np.diag(b)), rtol=1e-10)


@pytest.mark.parametrize("dim", [8, 64])
def test_fid_evaluator_matches_jax(dim):
    """One numpy feature function through both evaluators: the value, the
    key, and the fake set cleared by compute. At 64 dimensions from 16 fake
    images the covariances are singular and the value must stay finite."""
    rng = np.random.default_rng(dim)
    w = rng.normal(size=(4 * 4 * 3, dim))

    def feats(x):
        return np.asarray(x, np.float64).reshape(len(x), -1) @ w

    real = rng.uniform(0, 1, (40, 4, 4, 3)).astype(np.float32)
    fakes = [rng.uniform(0, 1, (8, 4, 4, 3)).astype(np.float32) for _ in range(2)]
    ours, theirs = (cls(feats, real_images=real, inception_batch_size=16, embedder="rand")
                    for cls in (FIDEvaluator, JaxFID))
    for ev in (ours, theirs):
        for f in fakes:
            ev.update(f)
    (got, secs), (want, _) = ours.compute(), theirs.compute()
    assert np.isfinite(got) and secs >= 0
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert ours.metric_key == theirs.metric_key == "metrics/fid_rand"
    assert ours._fake_feats == []
    ours.update(fakes[0])
    ours.update(fakes[1])
    assert ours.compute()[0] == got   # the same fakes again: the set was cleared
    assert FIDEvaluator(feats, embedder="inception_v3").metric_key == "metrics/fid"
    with pytest.raises(RuntimeError, match="set_real_images"):
        FIDEvaluator(feats).compute()


def test_fid_evaluator_remove_class():
    """The classifier filter drops the images whose argmax is the class."""
    class Clf:
        def compute_logits(self, imgs):
            return np.stack([imgs.mean(axis=(1, 2, 3)), np.full(len(imgs), 0.5)], axis=1)

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (12, 2, 2, 1)).astype(np.float32)
    seen = []
    ev = FIDEvaluator(lambda x: seen.append(len(x)) or np.asarray(x).reshape(len(x), -1),
                      remove_class_classifier=Clf(), remove_class=0)
    ev.update(imgs)
    assert seen == [int((imgs.mean(axis=(1, 2, 3)) <= 0.5).sum())]


@pytest.fixture(scope="module")
def golden_fid():
    meta, imgs, want = load_golden(GOLDENS / "inception_fid_golden.npz")
    return synth_state_dict(meta), imgs, want


def port_inception(variant, sd):
    model = InceptionV3Features(variant=variant)
    load_inception_state_dict(model, sd)
    return model.eval()


def test_inception_fid_matches_recorded_features(golden_fid):
    sd, imgs, want = golden_fid
    with torch.no_grad():
        got = port_inception("fid", sd)(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("variant", [pytest.param("torchvision", marks=pytest.mark.slow), "fid"])
def test_inception_matches_jax(variant, golden_fid):
    """The same weights in both packages (JAX through _convert_inception),
    on 96² inputs: every pool of the variant is exercised."""
    meta, _, _ = load_golden(GOLDENS / f"inception_{variant}_golden.npz")
    sd = synth_state_dict(meta)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    model = JaxInception(variant=variant)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)))
    want = np.asarray(model.apply(_convert_inception(sd, template), jnp.asarray(x)))
    with torch.no_grad():
        got = port_inception(variant, sd)(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_inception_state_dict_file_loads(golden_fid, tmp_path):
    """A torchvision-style .pth (with fc.* and AuxLogits.* to drop, and BN
    counters) gives the InceptionV3 feature function; a missing key raises."""
    sd, imgs, want = golden_fid
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    full["fc.weight"] = torch.zeros(1000, 2048)
    full["AuxLogits.fc.bias"] = torch.zeros(1000)
    full["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "pt_inception.pth"
    torch.save(full, path)
    fn, name = make_inception_feature_fn(str(path), batch_input_range="11", device="cpu")
    assert name == "inception_v3"
    # 299² inputs pass the resize unchanged; range "11" leaves them in [−1, 1]
    np.testing.assert_allclose(fn(imgs).numpy(), want, rtol=1e-3, atol=1e-3)
    del full["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool.conv.weight"):
        load_inception_state_dict(InceptionV3Features(), full)


def test_safetensors_without_the_package_raises(tmp_path, monkeypatch):
    path = tmp_path / "inception.safetensors"
    path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors package"):
        make_inception_feature_fn(str(path), device="cpu")


def test_random_embedder_matches_jax():
    """JAX's RandomEmbedder with its seeded flax params, carried into the
    port's module, through the whole feature function (resize to 299², the
    [0, 1] → [−1, 1] map, the embedder)."""
    jax_model = JaxRandomEmbedder()
    variables = jax_model.init(jax.random.PRNGKey(42), jnp.zeros((1, 299, 299, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    imgs = np.random.default_rng(0).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    x = jax.image.resize(jnp.asarray(imgs), (3, 299, 299, 3), method="bilinear") * 2.0 - 1.0
    want = np.asarray(jax_model.apply(variables, x))
    got = embedding_feature_fn(random_embedder_from_flax(params), device="cpu")(imgs).numpy()
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fn, name = make_inception_feature_fn(None, device="cpu")
    assert name == "rand" and fn(imgs).shape == (3, 512)


@pytest.mark.parametrize("size", [28, 256, 512])
def test_resize_matches_jax(size):
    x = np.random.default_rng(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), method="bilinear"))
    got = resize_to_inception(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_build_fid_evaluator_from_a_dataset():
    """No weights: the random embedder, ``metrics/fid_rand``, real statistics
    from the dataset's first ``max_real`` images (in [−1, 1], mapped to
    [0, 1]), a finite value for fake images."""
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 255, (10, 16, 16, 3), dtype=np.uint8), normalize=True)
    ev = build_fid_evaluator({"inception_batch_size": 4}, ds, max_real=6, device="cpu")
    assert ev.metric_key == "metrics/fid_rand" and ev.batch_size == 4
    real = np.stack([(ds[i] + 1.0) / 2.0 for i in range(6)])
    feats = ev.feature_fn(real).numpy()
    np.testing.assert_allclose(ev._real_stats[0], feats.mean(axis=0), rtol=1e-5, atol=1e-6)
    ev.update(rng.uniform(0, 1, (5, 16, 16, 3)).astype(np.float32))
    assert np.isfinite(ev.compute()[0])
