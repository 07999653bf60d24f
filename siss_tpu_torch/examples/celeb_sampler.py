"""Sample grids from a (possibly unlearned) CelebA-HQ checkpoint: port of
``examples/celeb_sampler.py``.

  python3 -m siss_tpu_torch.examples.celeb_sampler --checkpoint <run>/checkpoint-60 \\
      --n 16 --steps 50 --out samples.png

``--checkpoint``: a port bundle (its ``--subfolder`` item), ``<run
dir>/latest``, a diffusers model directory or snapshot, or a state-dict
file (``utils.hf_convert.load_unet2d``). The UNet computes under bf16
autocast over fp32 weights, as the JAX script builds it in bfloat16. The
DDPM draws come from a generator seeded with ``--seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, config=None) -> dict:
    """``config``: a ``UNet2DConfig`` in place of ``celebahq_256``. Returns
    the PNG's path, its uint8 grid and the samples (NHWC floats in [0, 1])."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="port bundle, diffusers model directory or state-dict file")
    p.add_argument("--subfolder", default="unet")
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="celeb_samples.png")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from PIL import Image

    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.evaluate import Evaluator
    from siss_tpu_torch.models import UNet2DConfig
    from siss_tpu_torch.train import unet_eps_apply
    from siss_tpu_torch.utils.hf_convert import load_unet2d

    device = resolve_device(args.device)
    ucfg = config or UNet2DConfig.celebahq_256()
    model = load_unet2d(args.checkpoint, ucfg, args.subfolder, torch.bfloat16, device)
    schedule = NoiseSchedule.create(1000, "linear", device=device)
    ev = Evaluator(unet_eps_apply, schedule, (ucfg.sample_size, ucfg.sample_size, ucfg.in_channels),
                   num_inference_steps=args.steps, random_seed=args.seed)
    with torch.inference_mode():
        imgs = ev.sample_images(model, args.n, set_generator=True)
    grid = (np.clip(Evaluator.make_grid_from_images(imgs), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(grid[..., 0] if grid.shape[-1] == 1 else grid).save(args.out)
    print(f"wrote {args.out}")
    return {"out": args.out, "grid": grid, "images": imgs}


if __name__ == "__main__":
    main()
