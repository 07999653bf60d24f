"""The port's CFG sampler (``sampling.sample_ddim_cfg``) and SD pipeline
(``diffusion/sd_pipeline.py``) against the JAX package's, on the CPU.

JAX's draws come from the key chains of ``siss_tpu/diffusion`` (a split for
the start latents, then one split per step) and are handed to the port.
Two ε functions stand in for the UNet, each written in both packages: the
toy pipeline of ``tests/test_sd_pipeline.py`` (ε linear in x plus the
conditioning's mean) and the nonlinear conditioning mix of
``tests/test_sd_aug_parity.py`` (ε = 0.2·x + Σ_l tanh(c·P)·w_l + ...), whose
embedding gradients differ per token. Tolerances: a sampler or img2img
1e-5 (as ``tests/test_torch_sampling.py``); token gradients rtol 2e-4 /
atol 1e-6 and ``aug_prompt`` rtol 5e-4 / atol 5e-5, the tolerances
``tests/test_sd_aug_parity.py`` holds the JAX pipeline to torch's AdamW
with.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.diffusion import sampling as jax_sampling
from siss_tpu.diffusion.sd_pipeline import StableDiffusionPipeline as JaxPipeline
from siss_tpu.diffusion.sd_pipeline import sd_noise_schedule as jax_sd_schedule
from siss_tpu_torch.diffusion import sampling
from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline, sd_noise_schedule

L, D, C = 7, 16, 4
W_TOY = 0.2


def _toy_pair():
    """The toy UNet and VAE decode of ``tests/test_sd_pipeline.py``."""
    def jax_unet(params, x, t, ctx):
        return W_TOY * x + ctx.mean(axis=(1, 2))[:, None, None, None]

    def port_unet(unet, x, t, ctx):
        return W_TOY * x + ctx.mean(dim=(1, 2))[:, None, None, None]

    def jax_decode(params, z):
        return jnp.tanh(z.repeat(2, axis=1).repeat(2, axis=2)[..., :3])

    def port_decode(z):
        return torch.tanh(z.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., :3])

    return (jax_unet, {}, jax_decode), (port_unet, None, port_decode)


def _mix_pair(seed=0):
    """The nonlinear conditioning mix of ``tests/test_sd_aug_parity.py``."""
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(D, C)) * 0.5).astype(np.float32)
    tok_w = rng.normal(size=(L,)).astype(np.float32)

    def jax_unet(params, x, t, cond):
        w = jnp.tanh(cond @ params["proj"])
        shift = jnp.einsum("blc,l->bc", w, params["tok_w"])
        tt = t[:, None, None, None] / 1000.0
        return 0.2 * x + shift[:, None, None, :] + 0.01 * jnp.sin(x) * tt

    def port_unet(unet, x, t, cond):
        w = torch.tanh(cond @ unet["proj"])
        shift = torch.einsum("blc,l->bc", w, unet["tok_w"])
        tt = t[:, None, None, None] / 1000.0
        return 0.2 * x + shift[:, None, None, :] + 0.01 * torch.sin(x) * tt

    params = {"proj": jnp.asarray(proj), "tok_w": jnp.asarray(tok_w)}
    port = {"proj": torch.from_numpy(proj), "tok_w": torch.from_numpy(tok_w)}
    return (jax_unet, params, lambda p, z: z), (port_unet, port, lambda z: z)


def pipelines(kind):
    (ju, jp, jd), (pu, pp, pd) = _toy_pair() if kind == "toy" else _mix_pair()
    scale = 2 if kind == "toy" else 1
    jax_pipe = JaxPipeline(unet_apply=ju, unet_params=jp, vae_decode=jd, vae_params={},
                           schedule=jax_sd_schedule(), latent_channels=C, vae_scale_factor=scale)
    port_pipe = StableDiffusionPipeline(unet_apply=pu, unet=pp, vae_decode=pd,
                                        schedule=sd_noise_schedule(device="cpu"),
                                        latent_channels=C, vae_scale_factor=scale)
    return jax_pipe, port_pipe


def embeds(seed, batch=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, L, D)).astype(np.float32),
            (0.3 * rng.normal(size=(batch, L, D))).astype(np.float32))


def t_of(a):
    return torch.from_numpy(np.array(a))


def start_noise(key, shape):
    """JAX's start latents: the first split of ``key``."""
    return np.asarray(jax.random.normal(jax.random.split(key)[1], shape))


def step_noises(key, steps, shape):
    """The per-step draws of JAX's CFG loop: after the start split, one
    split per step."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(t_of(jax.random.normal(sub, shape)))
    return out


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("track", [True, False])
def test_sample_ddim_cfg_matches_jax(track, eta):
    (ju, jp, _), (pu, pp, _) = _mix_pair()
    cond, uncond = embeds(1, batch=2)
    shape, steps, key = (2, 6, 6, C), 10, jax.random.PRNGKey(4)
    x, norms = jax_sampling.sample_ddim_cfg(
        lambda x, t, c: ju(jp, x, t, c), jax_sd_schedule(), key, shape, jnp.asarray(cond),
        jnp.asarray(uncond), guidance_scale=7.5, num_inference_steps=steps,
        track_noise_norm=track, eta=eta)
    got, got_norms = sampling.sample_ddim_cfg(
        lambda x, t, c: pu(pp, x, t, c), sd_noise_schedule(device="cpu"), shape, t_of(cond),
        t_of(uncond), guidance_scale=7.5, num_inference_steps=steps, track_noise_norm=track,
        eta=eta, x_init=t_of(start_noise(key, shape)),
        step_noise=step_noises(key, steps, shape) if eta else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)
    if not track:
        assert got_norms is None and norms is None
        return
    for k in ("uncond_norm", "text_norm"):
        assert got_norms[k].shape == (steps, 2) and got_norms[k].dtype == torch.float32
        np.testing.assert_allclose(got_norms[k].numpy(), np.asarray(norms[k]), rtol=1e-5,
                                   atol=1e-5)


def test_sample_ddim_cfg_batches_uncond_then_cond():
    """One model call of batch 2B a step, unconditional rows first."""
    calls = []

    def eps(x, t, c):
        calls.append((x.shape[0], c[:, 0, 0].tolist()))
        return torch.zeros_like(x)

    cond, uncond = torch.ones(2, 3, 4), torch.zeros(2, 3, 4)
    sampling.sample_ddim_cfg(eps, sd_noise_schedule(device="cpu"), (2, 4, 4, C), cond, uncond,
                             num_inference_steps=3, generator=torch.Generator().manual_seed(0))
    assert calls == [(4, [0.0, 0.0, 1.0, 1.0])] * 3


@pytest.mark.parametrize("kind", ["toy", "mix"])
def test_pipeline_call_matches_jax(kind):
    jax_pipe, port_pipe = pipelines(kind)
    pe, ue = embeds(2)
    key, hw = jax.random.PRNGKey(0), 16
    imgs, norms = jax_pipe(jnp.asarray(pe), jnp.asarray(ue), key, height=hw, width=hw,
                           num_inference_steps=8, track_noise_norm=True)
    scale = port_pipe.vae_scale_factor
    x_init = t_of(start_noise(key, (1, hw // scale, hw // scale, C)))
    got, got_norms = port_pipe(t_of(pe), t_of(ue), height=hw, width=hw, num_inference_steps=8,
                               track_noise_norm=True, x_init=x_init)
    assert got.shape == imgs.shape and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, imgs, rtol=1e-5, atol=1e-5)
    for k in ("uncond_norm", "text_norm"):
        np.testing.assert_allclose(got_norms[k], norms[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["toy", "mix"])
def test_img2img_matches_jax(kind):
    jax_pipe, port_pipe = pipelines(kind)
    pe, ue = embeds(3)
    init = np.random.default_rng(4).normal(size=(1, 8, 8, C)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = jax_pipe.img2img(jnp.asarray(init), jnp.asarray(pe), jnp.asarray(ue), key,
                            strength=0.5, num_inference_steps=8)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], init.shape))
    got = port_pipe.img2img(t_of(init), t_of(pe), t_of(ue), strength=0.5, num_inference_steps=8,
                            noise=t_of(noise))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ts, n = port_pipe.get_timesteps(8, 0.5)
    jts, jn = jax_pipe.get_timesteps(8, 0.5)
    np.testing.assert_array_equal(ts, jts)
    assert n == jn


@pytest.mark.parametrize("kind,target_steps", [("toy", (0, 2)), ("mix", (0,)),
                                               ("mix", (0, 2, 4))])
def test_text_cond_grad_matches_jax(kind, target_steps):
    jax_pipe, port_pipe = pipelines(kind)
    pe, ue = embeds(5)
    key, hw = jax.random.PRNGKey(3), 16
    want = jax_pipe.get_text_cond_grad(jnp.asarray(pe), jnp.asarray(ue), key, height=hw,
                                       width=hw, num_inference_steps=8, target_steps=target_steps)
    scale = port_pipe.vae_scale_factor
    latents = t_of(start_noise(key, (1, hw // scale, hw // scale, C)))
    got = port_pipe.get_text_cond_grad(t_of(pe), t_of(ue), height=hw, width=hw,
                                       num_inference_steps=8, target_steps=target_steps,
                                       latents=latents)
    assert got.shape == (L,) and np.all(np.isfinite(got)) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("kind,kwargs", [
    ("toy", dict(lr=0.05, optim_iters=5)),
    ("mix", dict(lr=0.05, optim_iters=5)),
    ("mix", dict(lr=0.05, optim_iters=8, optim_epsilon=1e-4, alpha=0.5)),
    ("mix", dict(lr=0.05, optim_iters=50, target_loss=3.0)),
    ("toy", dict(lr=0.05, optim_iters=6, optim_epsilon=1e-4, target_loss=0.5)),
])
def test_aug_prompt_matches_jax(kind, kwargs):
    jax_pipe, port_pipe = pipelines(kind)
    pe, ue = embeds(6)
    key, hw = jax.random.PRNGKey(5), 16
    want = jax_pipe.aug_prompt(jnp.asarray(pe), jnp.asarray(ue), key, height=hw, width=hw,
                               num_inference_steps=8, target_steps=(1,), **kwargs)
    scale = port_pipe.vae_scale_factor
    latents = t_of(start_noise(key, (1, hw // scale, hw // scale, C)))
    got = port_pipe.aug_prompt(t_of(pe), t_of(ue), height=hw, width=hw, num_inference_steps=8,
                               target_steps=(1,), latents=latents, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    assert np.abs(got.numpy()[:, 1:] - pe[:, 1:]).max() > 1e-4


def test_prompt_embeds_load_from_npz_and_pt(tmp_path):
    e = np.random.default_rng(7).normal(size=(1, L, D)).astype(np.float32)
    np.savez(tmp_path / "p.npz", embeds=e)
    torch.save(torch.from_numpy(e), tmp_path / "p.pt")
    for name in ("p.npz", "p.pt"):
        got = StableDiffusionPipeline.load_prompt_embeds(str(tmp_path / name))
        np.testing.assert_array_equal(got.numpy(), e)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            JaxPipeline.load_prompt_embeds(str(tmp_path / name))))
