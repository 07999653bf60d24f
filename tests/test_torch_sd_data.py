"""The SD task's data pieces against the JAX package's, on the CPU:
``SDData`` bit for bit for each filter (a resize included), the latent-moment
cache built through the tiny VAE (atol 1e-5, the towers' tolerance),
``sample_from_moments`` with JAX's normals and flip mask injected (atol
1e-6: a few fp32 operations), the cached path against the encode in the
step from one generator (atol 1e-5), and ``Tracker.log_line_series``
records equal apart from ``_time``."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.data.datasets import SDData as JaxSDData
from siss_tpu.data.latent_cache import build_moment_cache as jax_build_cache
from siss_tpu.data.latent_cache import cache_nbytes as jax_cache_nbytes
from siss_tpu.data.latent_cache import sample_from_moments as jax_sample
from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
from siss_tpu.utils.tracker import Tracker as JaxTracker
from siss_tpu_torch.data import SDData
from siss_tpu_torch.data.latent_cache import build_moment_cache, cache_nbytes, sample_from_moments
from siss_tpu_torch.models import AutoencoderKL, AutoencoderKLConfig
from siss_tpu_torch.utils import Tracker
from siss_tpu_torch.utils.convert import params_from_flax

RES = 16
SF = 0.18215


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seven PNGs, two of them off-size, with labels in a shuffled key order."""
    root = tmp_path_factory.mktemp("sd_data")
    rng = np.random.default_rng(0)
    labels = {}
    for i in (3, 0, 5, 1, 6, 2, 4):
        size = (RES, RES) if i % 3 else (RES + 5, RES - 3)
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(root / name)
        labels[name] = int(i in (0, 4))
    with open(root / "labels.json", "w") as f:
        json.dump(labels, f)
    return str(root)


@pytest.mark.parametrize("filt", ["all", "deletion", "nondeletion"])
@pytest.mark.parametrize("resolution", [RES, None])
def test_sddata_matches_jax(folder, filt, resolution):
    labels = os.path.join(folder, "labels.json")
    ours = SDData(filt, folder, labels, resolution=resolution)
    theirs = JaxSDData(filt, folder, labels, resolution=resolution)
    assert ours.img_names == theirs.img_names and len(ours) == len(theirs)
    for i in range(len(ours)):
        (a, la), (b, lb) = ours[i], theirs[i]
        assert la == lb and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        SDData("bogus", folder, labels)


@pytest.fixture(scope="module")
def vaes():
    fvae = FlaxVAE(FlaxVAEConfig.tiny())
    # jitted: eager flax compiles each operation on its own
    params = jax.jit(functools.partial(fvae.init_params, image_size=RES))(jax.random.PRNGKey(0))
    vae = AutoencoderKL(AutoencoderKLConfig.tiny())
    vae.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return (lambda x: fvae.apply({"params": params}, x, method=fvae.encode_moments)), vae


def _images(n, seed=1):
    return list(np.random.default_rng(seed).uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32))


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("n,mb", [(6, 2), (5, 2), (3, 4)])
def test_moment_cache_matches_jax(vaes, flip, n, mb):
    jax_enc, vae = vaes
    imgs = _images(n)
    want = jax_build_cache(jax_enc, imgs, mb, flip)
    got = build_moment_cache(vae.encode_moments, imgs, mb, flip, device="cpu")
    assert got.shape == want.shape == (n, 2 if flip else 1, RES // 2, RES // 2, 8)
    assert got.dtype == np.float32
    assert got.nbytes == cache_nbytes(n, RES, 2, 4, flip)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flip", [True, False])
def test_sample_from_moments_matches_jax(vaes, flip):
    jax_enc, _ = vaes
    A, mb = 3, 2
    cache = jax_build_cache(jax_enc, _images(A * mb), mb, flip)
    moments = cache[np.arange(A * mb).reshape(A, mb)]
    key = jax.random.PRNGKey(7)
    bits = jax.random.bernoulli(jax.random.PRNGKey(9), 0.5, (A, mb, 1, 1, 1)) if flip else None
    want = jax_sample(jnp.asarray(moments), key, bits, SF)
    keys = jax.random.split(key, A)
    noise = torch.stack([torch.from_numpy(np.array(jax.random.normal(k, (mb, RES // 2,
                                                                          RES // 2, 4))))
                         for k in keys])
    flip_mask = None if bits is None else torch.from_numpy(np.array(bits)).reshape(A, mb)
    got = sample_from_moments(torch.from_numpy(moments), flip_mask, SF, noise=noise)
    assert got.shape == (A, mb, RES // 2, RES // 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cached_latents_equal_the_encode_in_the_step(vaes):
    """The cache with a generator's draws against ``encode_sample`` of the
    flipped pixels, microbatch by microbatch, from the same generator."""
    _, vae = vaes
    A, mb = 2, 3
    imgs = _images(A * mb, seed=2)
    cache = build_moment_cache(vae.encode_moments, imgs, mb, True, device="cpu")
    flip = torch.rand((A, mb), generator=torch.Generator().manual_seed(1)) < 0.5
    cached = sample_from_moments(torch.from_numpy(cache).reshape(A, mb, *cache.shape[1:]), flip,
                                 SF, generator=torch.Generator().manual_seed(4))
    pix = torch.from_numpy(np.stack(imgs)).reshape(A, mb, RES, RES, 3)
    pix = torch.where(flip[:, :, None, None, None], pix.flip(3), pix)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        direct = torch.stack([vae.encode_sample(pix[a], generator=gen) for a in range(A)])
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), rtol=0, atol=1e-5)


def test_cache_nbytes_matches_jax():
    for args in ((16, 512, 8, 4, True), (7, 32, 2, 4, False)):
        assert cache_nbytes(*args) == jax_cache_nbytes(*args, 4)


def test_line_series_record_matches_jax(tmp_path):
    xs, ys = [0, 20, 40], [[1.5, 2.0, 2.5], [np.float32(1.25), 1.0, 0.5]]
    records = []
    for cls, sub in ((Tracker, "port"), (JaxTracker, "jax")):
        tracker = cls("p", str(tmp_path / sub))
        tracker.log_line_series("noise_norms/noise_norms_0", xs=xs, ys=ys, keys=[0, 1],
                                title="Text-conditional noise norm (prompt 0)",
                                xname="Timestep", step=48)
        tracker.finish()
        with open(tmp_path / sub / "metrics.jsonl") as f:
            (record,) = [json.loads(line) for line in f]
        assert isinstance(record.pop("_time"), float)
        records.append(record)
    assert records[0] == records[1]
    assert records[0]["_panel"] == "line_series" and records[0]["_step"] == 48
