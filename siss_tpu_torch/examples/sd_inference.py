"""SD text-to-image inference with memorization diagnostics: port of
``examples/sd_inference.py``. Samples with a regular prompt or an augmented
prompt-embedding file, tracking per-step noise norms.

  python3 -m siss_tpu_torch.examples.sd_inference --model <sd dir> \\
      --prompt "a photo of ..." --n 4 --out sd.png
  python3 -m siss_tpu_torch.examples.sd_inference --model <sd dir> \\
      --prompt-embeds aug_prompt.npz --out sd_aug.png

``--model`` is a directory read as ``DeleteSD`` reads
``pretrained_model_name_or_path``: ``unet/``, ``vae/`` and
``text_encoder/`` each holding a state dict under diffusers and
transformers names (``diffusion_pytorch_model.bin`` or
``pytorch_model.bin``), and ``tokenizer/`` holding ``vocab.json`` and
``merges.txt`` (a diffusers SD-1.x snapshot as it is downloaded). The UNet
and VAE compute under bf16 autocast over fp32 weights, the text tower in
fp32, as the JAX script builds them. Images are sampled at the UNet's own
size (512² for SD-1.x); the start latents come from a generator seeded
with ``--seed``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def sd_configs(config=None):
    """(UNet, VAE and text-tower configs, the UNet and VAE's compute
    dtype): SD-1.x in bfloat16, with any of ``config``'s entries
    (``unet``, ``vae``, ``text_encoder``, ``dtype``) in their place."""
    from siss_tpu_torch.models import AutoencoderKLConfig, CLIPTextConfig, UNet2DConditionConfig

    config = config or {}
    return (config.get("unet") or UNet2DConditionConfig.sd_v1(),
            config.get("vae") or AutoencoderKLConfig.sd_v1(),
            config.get("text_encoder") or CLIPTextConfig.sd_v1(),
            config.get("dtype", torch.bfloat16))


def build_pipeline(model_dir: str, device="cuda", config=None):
    """The SD pipeline of ``model_dir``'s UNet, VAE, text tower and
    tokenizer on ``device`` (``config``: as ``sd_configs``)."""
    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.diffusion.sd_pipeline import StableDiffusionPipeline, sd_noise_schedule
    from siss_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet2DCondition,
                                       load_clip_tokenizer)
    from siss_tpu_torch.train import cond_unet_eps_apply
    from siss_tpu_torch.utils.checkpoint import load_frozen

    dev = resolve_device(device)
    unet_cfg, vae_cfg, text_cfg, dtype = sd_configs(config)
    unet = load_frozen(lambda: UNet2DCondition(unet_cfg, dtype=dtype),
                       os.path.join(model_dir, "unet"), dev)
    vae = load_frozen(lambda: AutoencoderKL(vae_cfg, dtype=dtype),
                      os.path.join(model_dir, "vae"), dev)
    text = load_frozen(lambda: CLIPTextModel(text_cfg), os.path.join(model_dir, "text_encoder"),
                       dev)
    if dev.type == "cuda":
        unet, vae = (m.to(memory_format=torch.channels_last) for m in (unet, vae))
    tokenizer = load_clip_tokenizer(os.path.join(model_dir, "tokenizer"))
    return StableDiffusionPipeline(
        unet_apply=cond_unet_eps_apply, unet=unet, vae_decode=vae.decode, text_encoder=text,
        tokenizer=tokenizer, schedule=sd_noise_schedule(device=dev),
        latent_channels=vae_cfg.latent_channels, vae_scale_factor=vae_cfg.scale_factor)


def image_size(pipe) -> int:
    """The side of the images the pipeline's UNet was built for."""
    return pipe.unet.config.sample_size * pipe.vae_scale_factor


def encode(pipe, prompt: str) -> torch.Tensor:
    """A prompt's embeddings at the text tower's length (77 for SD-1.x)."""
    return pipe.encode_prompt(prompt, pipe.text_encoder.config.max_position_embeddings)


def main(argv=None, config=None) -> dict:
    """Returns the PNG's path, the images [n, H, W, 3] in [0, 1] and the
    per-step noise norms [steps, n]."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True,
                   help="SD dir (unet/vae/text_encoder state dicts, tokenizer/)")
    p.add_argument("--prompt", default=None)
    p.add_argument("--prompt-embeds", default=None, help=".npz/.pt augmented prompt embeddings")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="sd_samples.png")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from PIL import Image

    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.evaluate import Evaluator

    device = resolve_device(args.device)
    pipe = build_pipeline(args.model, device, config)
    if args.prompt_embeds:
        pe = pipe.load_prompt_embeds(args.prompt_embeds, device)
    elif args.prompt:
        pe = encode(pipe, args.prompt)
    else:
        raise SystemExit("need --prompt or --prompt-embeds")
    pe = pe.reshape(1, *pe.shape[-2:]).expand(args.n, *pe.shape[-2:])
    ue = encode(pipe, "").expand(pe.shape)

    hw = image_size(pipe)
    with torch.inference_mode():
        imgs, norms = pipe(pe, ue, torch.Generator(device=device).manual_seed(args.seed),
                           height=hw, width=hw, num_inference_steps=args.steps,
                           guidance_scale=args.guidance, track_noise_norm=True)
    grid = Evaluator.make_grid_from_images(imgs)
    Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(args.out)
    print(f"wrote {args.out}")
    print("text-cond noise norms per step:",
          np.round(norms["text_norm"].mean(axis=1), 2).tolist())
    return {"out": args.out, "images": imgs, **norms}


if __name__ == "__main__":
    main()
