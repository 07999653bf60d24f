"""The SD towers of the port (``models/vae.py``, ``models/clip_text.py``)
against the flax modules, at the tiny configs in fp32 with TF32 off, the
flax weights carried by ``utils/convert.py``:

* VAE ``encode_moments``, ``encode_sample`` with JAX's normal draw injected
  and ``decode``: atol 1e-5 (outputs of magnitude ~1–3);
* CLIP text on random ids: rtol 2e-4 / atol 2e-5, the tolerance
  ``tests/test_sd_models.py`` holds the flax tower to transformers with;
* the weight names, key for key: the port's state dict through the JAX
  package's ``sd_convert.convert_vae`` / ``convert_clip_text`` gives back
  the flax params bit for bit, at the tiny configs and, by shapes alone,
  at the sd_v1 widths; the VAE loads the old attention names.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.models.clip_text import CLIPTextConfig as FlaxClipConfig
from siss_tpu.models.clip_text import CLIPTextModel as FlaxClip
from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
from siss_tpu.utils.sd_convert import convert_clip_text, convert_vae
from siss_tpu_torch.models import (AutoencoderKL, AutoencoderKLConfig, CLIPTextConfig,
                                   CLIPTextModel)
from siss_tpu_torch.utils.convert import clip_text_key, params_from_flax, torch_key

RES = 16


@pytest.fixture(scope="module")
def vae_pair():
    fvae = FlaxVAE(FlaxVAEConfig.tiny())
    # jitted: eager flax compiles each operation on its own
    params = jax.jit(functools.partial(fvae.init_params, image_size=RES))(jax.random.PRNGKey(0))
    vae = AutoencoderKL(AutoencoderKLConfig.tiny())
    vae.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return fvae, params, vae


@pytest.fixture(scope="module")
def clip_pair():
    fclip = FlaxClip(FlaxClipConfig.tiny())
    params = jax.jit(fclip.init_params)(jax.random.PRNGKey(1))
    clip = CLIPTextModel(CLIPTextConfig.tiny())
    clip.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), clip_text_key))
    return fclip, params, clip


def _images(seed, n=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)


def test_vae_encode_and_decode_match_flax(vae_pair):
    fvae, params, vae = vae_pair
    x = _images(0)
    apply = functools.partial(jax.jit, static_argnames="method")(
        lambda *a, method: fvae.apply({"params": params}, *a, method=method))
    mean, logvar = apply(jnp.asarray(x), method=fvae.encode_moments)
    key = jax.random.PRNGKey(7)
    z = apply(jnp.asarray(x), key, method=fvae.encode_sample)
    noise = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    images = apply(z, method=fvae.decode)
    with torch.no_grad():
        tmean, tlogvar = vae.encode_moments(torch.from_numpy(x))
        tz = vae.encode_sample(torch.from_numpy(x), noise=torch.from_numpy(np.array(noise)))
        timages = vae.decode(torch.from_numpy(np.array(z)))
    assert tmean.shape == (3, RES // 2, RES // 2, 4) and tmean.dtype == torch.float32
    for got, want in ((tmean, mean), (tlogvar, logvar), (tz, z), (timages, images)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_vae_encode_sample_draws_from_the_generator(vae_pair):
    _, _, vae = vae_pair
    x = torch.from_numpy(_images(1, n=2))
    with torch.no_grad():
        a = vae.encode_sample(x, generator=torch.Generator().manual_seed(3))
        mean, logvar = vae.encode_moments(x)
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
        b = vae.encode_sample(x, noise=noise)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, (mean + torch.exp(0.5 * logvar) * noise) * 0.18215)


def test_clip_text_matches_flax(clip_pair):
    fclip, params, clip = clip_pair
    ids = np.random.default_rng(2).integers(0, 1000, (3, 16))
    want = jax.jit(lambda i: fclip.apply({"params": params}, i))(jnp.asarray(ids))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids))
    assert got.shape == (3, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def _assert_trees_equal(got, want):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_g) == set(flat_w)
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("tower", ["vae", "clip_text"])
def test_state_dict_converts_back_to_the_flax_params(tower, vae_pair, clip_pair):
    """Port state dict → the JAX package's converter → the original flax
    params, bit for bit."""
    _, params, model = vae_pair if tower == "vae" else clip_pair
    convert = convert_vae if tower == "vae" else convert_clip_text
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _assert_trees_equal(convert(sd, params), params)


@pytest.mark.parametrize("tower", ["vae", "clip_text"])
def test_sd_v1_names_and_shapes_match_flax(tower):
    """At the sd_v1 widths, by shapes alone: every flax param has its port
    key with the transposed shape, and the port has no other."""
    if tower == "vae":
        fmodel, key_fn = FlaxVAE(FlaxVAEConfig.sd_v1()), torch_key
        shapes = jax.eval_shape(lambda: fmodel.init_params(jax.random.PRNGKey(0), image_size=64))
        with torch.device("meta"):
            port = AutoencoderKL(AutoencoderKLConfig.sd_v1())
    else:
        fmodel, key_fn = FlaxClip(FlaxClipConfig.sd_v1()), clip_text_key
        shapes = jax.eval_shape(lambda: fmodel.init_params(jax.random.PRNGKey(0)))
        with torch.device("meta"):
            port = CLIPTextModel(CLIPTextConfig.sd_v1())
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [p.key for p in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], *shape[:2])
        want[key_fn(names)] = shape
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert n == {"vae": 83_653_863, "clip_text": 123_060_480}[tower]


def test_vae_loads_the_old_attention_names(vae_pair):
    """``query``/``key``/``value``/``proj_attn``, stored as 1×1 convolutions
    as in converted CompVis checkpoints, load into the same weights."""
    _, _, vae = vae_pair
    old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    sd = {}
    for k, v in vae.state_dict().items():
        for new, name in old.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{name}.")
                v = v[:, :, None, None] if v.ndim == 2 else v
        sd[k] = v
    assert any(".proj_attn." in k for k in sd) and any(".query." in k for k in sd)
    fresh = AutoencoderKL(AutoencoderKLConfig.tiny())
    fresh.load_state_dict(sd)
    for k, v in vae.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_clip_text_ignores_the_position_ids_buffer(clip_pair):
    _, _, clip = clip_pair
    sd = dict(clip.state_dict())
    sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    fresh = CLIPTextModel(CLIPTextConfig.tiny())
    fresh.load_state_dict(sd)
    torch.testing.assert_close(fresh.state_dict()["text_model.final_layer_norm.weight"],
                               sd["text_model.final_layer_norm.weight"])
