"""The SD slice as a whole against the same chain in JAX, tiny and fp32 on
the CPU: the CLIP tokenizer → the text tower → the VAE's ``encode_sample``
of a keep and a forget batch → one SISS SD step (SGD, JAX's draws injected)
→ one CFG DDIM sample with noise norms from the updated UNet → the VAE
decode. Both packages start from the same flax weights (``utils/convert``).

Tolerances: the prompt embeddings rtol 2e-4 / atol 2e-5 (the towers');
the latents atol 1e-5; the step's parameters rtol 1e-4 / atol 1e-6 and its
metrics as ``tests/test_torch_sd_step.py``; the sample and its norms rtol
1e-4 / atol 1e-4 of their largest magnitude (five CFG steps at guidance
7.5 carry the step's 1e-6 parameter differences, amplified by the
guidance, into latents of magnitude ~15), the decoded images atol 1e-4.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import sampling as jax_sampling
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu.models.clip_bpe import CLIPBPETokenizer as JaxTokenizer
from siss_tpu.models.clip_text import CLIPTextConfig as FlaxClipConfig
from siss_tpu.models.clip_text import CLIPTextModel as FlaxClip
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxUNetConfig
from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
from siss_tpu.train import DeletionStepConfig as JaxStepConfig
from siss_tpu.train import TrainState as JaxState
from siss_tpu.train import build_deletion_train_step as jax_build_step
from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline, sd_noise_schedule
from siss_tpu_torch.models import (AutoencoderKL, AutoencoderKLConfig, CLIPTextConfig,
                                   CLIPTextModel, UNet2DCondition, UNet2DConditionConfig,
                                   load_clip_tokenizer)
from siss_tpu_torch.train import (DeletionStepConfig, TrainState, build_deletion_train_step,
                                  build_optimizer, cond_unet_eps_apply)
from siss_tpu_torch.utils.convert import clip_text_key, params_from_flax
from test_torch_sd_step import SD_STEP_KW, TINY16
from test_torch_sd_tokenizer import _byte_vocab
from test_torch_train_step import A, MB, assert_metrics_match, assert_params_match, jax_draws

RES, LAT, C, STEPS = 32, 16, 4, 5


def t_of(a):
    return torch.from_numpy(np.array(a))


def test_sd_slice_matches_jax(tmp_path):
    vocab, merges = _byte_vocab()
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(tmp_path / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    jtok = JaxTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    tok = load_clip_tokenizer(str(tmp_path))

    # tokenizer → text tower
    fclip = FlaxClip(FlaxClipConfig.tiny())
    clip_params = jax.jit(fclip.init_params)(jax.random.PRNGKey(1))
    clip = CLIPTextModel(CLIPTextConfig.tiny())
    clip.load_state_dict(params_from_flax(jax.tree.map(np.asarray, clip_params), clip_text_key))
    fvae = FlaxVAE(FlaxVAEConfig.tiny())
    vae_params = jax.jit(functools.partial(fvae.init_params, image_size=RES))(
        jax.random.PRNGKey(2))
    # jitted: eager flax compiles each operation on its own
    jax_encode = jax.jit(lambda x, k: fvae.apply({"params": vae_params}, x, k,
                                                 method=fvae.encode_sample))
    jax_decode = jax.jit(lambda z: fvae.apply({"params": vae_params}, z, method=fvae.decode))
    vae = AutoencoderKL(AutoencoderKLConfig.tiny())
    vae.load_state_dict(params_from_flax(jax.tree.map(np.asarray, vae_params)))
    pipe = StableDiffusionPipeline(unet_apply=cond_unet_eps_apply, unet=None,
                                   vae_decode=vae.decode, text_encoder=clip, tokenizer=tok,
                                   schedule=sd_noise_schedule(device="cpu"), latent_channels=C,
                                   vae_scale_factor=2)

    clip_apply = jax.jit(lambda ids: fclip.apply({"params": clip_params}, ids))

    def jax_embed(text):
        return clip_apply(jnp.asarray(jtok(text, max_length=16).input_ids))

    cond, uncond = jax_embed("a photo of the cat"), jax_embed("")
    got_cond, got_uncond = pipe.encode_prompt("a photo of the cat", 16), pipe.encode_prompt("", 16)
    for got, want in ((got_cond, cond), (got_uncond, uncond)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)

    # the VAE's encode_sample of each microbatch of both streams
    rng = np.random.default_rng(3)
    pixels = {k: rng.uniform(-1, 1, (A, MB, RES, RES, 3)).astype(np.float32)
              for k in ("all", "deletion")}
    enc_keys = dict(zip(("all", "deletion"), jax.random.split(jax.random.PRNGKey(4))))
    batch, tbatch = {}, {}
    for k, x in pixels.items():
        keys = jax.random.split(enc_keys[k], A)
        batch[k] = jnp.stack([jax_encode(jnp.asarray(x[a]), keys[a]) for a in range(A)])
        noise = [t_of(jax.random.normal(keys[a], (MB, LAT, LAT, C))) for a in range(A)]
        with torch.no_grad():
            tbatch[k] = torch.stack([vae.encode_sample(t_of(x[a]), noise=noise[a])
                                     for a in range(A)])
        np.testing.assert_allclose(tbatch[k].numpy(), np.asarray(batch[k]), rtol=0, atol=1e-5)
    batch["conditioning"] = jnp.broadcast_to(cond, (A, MB, *cond.shape[1:]))
    tbatch["conditioning"] = got_cond.expand(A, MB, *got_cond.shape[1:])

    # one SISS SD step
    fmodel = FlaxUNet(FlaxUNetConfig(**dict(TINY16, attention_impl="einsum")))
    params = jax.jit(functools.partial(fmodel.init_params, batch_size=MB,
                                       context_len=16))(jax.random.PRNGKey(5))
    tx = optax.sgd(1.0)
    jstep = jax.jit(jax_build_step(lambda p, x, t, c: fmodel.apply({"params": p}, x, t, c),
                                   jax_sd_schedule(), tx, JaxStepConfig(**SD_STEP_KW)))
    key = jax.random.PRNGKey(11)
    jstate, jm = jstep(JaxState.create(params, tx), batch, key, {})
    model = UNet2DCondition(UNet2DConditionConfig(**dict(TINY16, attention_impl="flash")))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    opt, sched = build_optimizer({"_target_": "sgd", "lr": 1.0}, model.parameters())
    step = build_deletion_train_step(cond_unet_eps_apply, pipe.schedule,
                                     DeletionStepConfig(**SD_STEP_KW))
    state, m = step(TrainState.create(model, opt, sched), tbatch,
                    draws=jax_draws(key, (LAT, LAT, C), 999, 1000))
    assert_metrics_match(m, jm)
    assert_params_match(state.model.state_dict(), jstate.params, rtol=1e-4, atol=1e-6)

    # one CFG sample with noise norms from the updated UNet, then the decode
    skey = jax.random.PRNGKey(6)
    lat, norms = jax_sampling.sample_ddim_cfg(
        lambda x, t, c: fmodel.apply({"params": jstate.params}, x, t, c), jax_sd_schedule(),
        skey, (1, LAT, LAT, C), cond, uncond, guidance_scale=7.5, num_inference_steps=STEPS,
        track_noise_norm=True)
    images = np.clip((np.asarray(jax_decode(lat)) + 1) / 2, 0, 1)
    x_init = t_of(jax.random.normal(jax.random.split(skey)[1], (1, LAT, LAT, C)))
    got_lat, got_norms = pipe.sample_latents(got_cond, got_uncond, height=RES, width=RES,
                                             num_inference_steps=STEPS, track_noise_norm=True,
                                             unet=state.model, x_init=x_init)
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(lat), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(lat)).max())
    for k in ("uncond_norm", "text_norm"):
        assert got_norms[k].shape == (STEPS, 1)
        want = np.asarray(norms[k])
        np.testing.assert_allclose(got_norms[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    got_images = pipe.decode_images(got_lat)
    assert got_images.shape == (1, RES, RES, 3)
    np.testing.assert_allclose(got_images, images, rtol=0, atol=1e-4)
