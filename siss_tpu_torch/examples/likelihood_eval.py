"""Exact NLL (bits/dim) of images under a diffusion checkpoint via the
probability-flow ODE: port of ``examples/likelihood_eval.py``.

  python3 -m siss_tpu_torch.examples.likelihood_eval --checkpoint <run>/checkpoint-60 \\
      --images img1.jpg img2.jpg [--arch mnist_tshirt] [--method rk4]

``--checkpoint`` is read as ``celeb_sampler``'s is. The Hutchinson probe
comes from the evaluator's generator seeded with its ``random_seed`` (0),
so a run repeats; the JAX script draws it from a random key.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, config=None) -> dict:
    """``config``: a ``UNet2DConfig`` in place of ``--arch``'s. Returns the
    images' paths, their bits/dim and the count of function evaluations."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--subfolder", default="unet")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--arch", default="celebahq_256", choices=["celebahq_256", "mnist_tshirt"])
    p.add_argument("--method", default="rk45", choices=["rk45", "rk4"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from PIL import Image

    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.diffusion.sde import VPSDE
    from siss_tpu_torch.metrics.likelihood import LikelihoodEvaluator
    from siss_tpu_torch.models import UNet2DConfig
    from siss_tpu_torch.train import unet_eps_apply
    from siss_tpu_torch.utils.hf_convert import load_unet2d

    device = resolve_device(args.device)
    ucfg = config or getattr(UNet2DConfig, args.arch)()
    model = load_unet2d(args.checkpoint, ucfg, args.subfolder, device=device)

    imgs = []
    for path in args.images:
        a = np.asarray(Image.open(path), np.float32) / 255.0 * 2 - 1
        if a.ndim == 2:
            a = a[..., None]
        imgs.append(a)
    batch = np.stack(imgs)

    schedule = NoiseSchedule.create(1000, "linear", device=device)
    ev = LikelihoodEvaluator(unet_eps_apply, VPSDE(), schedule=schedule, method=args.method,
                             device=device)
    bpd, _, nfe = ev.evaluate_likelihood(model, batch)
    bpd = bpd.cpu().numpy()
    for path, b in zip(args.images, bpd):
        print(f"{path}: {b:.4f} bits/dim  (nfe={int(nfe)})")
    return {"images": list(args.images), "bpd": bpd, "nfe": int(nfe)}


if __name__ == "__main__":
    main()
