"""SSCD copy-detection scoring: port of ``examples/sscd_score.py``. The
similarity of generated images to a memorized target image under the
external SSCD TorchScript model.

  python3 -m siss_tpu_torch.examples.sscd_score --model sscd_disc_mixup.torchscript.pt \\
      --target mem.png --images gen1.png gen2.png

The model runs on ``--device``; the script exits 1 when it cannot be
loaded, as the JAX script does.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Returns the images' paths and their similarities."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)

    from PIL import Image

    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.metrics.sscd import SSCDEvaluator

    device = resolve_device(args.device)
    sscd = SSCDEvaluator.load(args.model, device)
    if sscd is None:
        raise SystemExit(1)

    def load(path):
        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0

    target = load(args.target)
    imgs = np.stack([load(path) for path in args.images])
    sims = np.atleast_1d(sscd.similarities(imgs, target))
    for path, s in zip(args.images, sims):
        print(f"{path}: sscd={s:.4f}")
    return {"images": list(args.images), "sims": sims}


if __name__ == "__main__":
    main()
