"""Membership-loss-vs-timestep curve: port of ``examples/membership_curve.py``.
The keep-set and forget-set membership losses across timesteps, to find the
"Goldilocks zone" golden timestep.

  python3 -m siss_tpu_torch.examples.membership_curve --checkpoint <run>/checkpoint-300 \\
      --npz data/datasets/mnist_with_tshirt.npz --out curve.png

``--checkpoint`` is read as ``celeb_sampler``'s is. ``membership_losses``
computes the curve and needs no plotting package; ``main`` also draws it
with matplotlib, imported where the plot is drawn. The noise comes from a
generator seeded with the loss's seed (0).
"""

from __future__ import annotations

import argparse
from typing import List, Tuple


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--subfolder", default="unet")
    p.add_argument("--npz", required=True, help="mnist_with_tshirt.npz")
    p.add_argument("--class-label", type=int, default=10)
    p.add_argument("--time-frequency", type=int, default=50)
    p.add_argument("--num-images", type=int, default=32)
    p.add_argument("--num-noises", type=int, default=16)
    p.add_argument("--out", default="membership_curve.png")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    return p.parse_args(argv)


def membership_losses(args: argparse.Namespace, config=None
                      ) -> Tuple[List[int], List[Tuple[float, float]]]:
    """The timesteps and, at each, the (keep, forget) membership losses of
    ``args.checkpoint``'s mnist_tshirt UNet (``config``, a ``UNet2DConfig``,
    in its place)."""
    from siss_tpu_torch.data import LabeledImageDataset
    from siss_tpu_torch.device import resolve_device
    from siss_tpu_torch.diffusion import NoiseSchedule
    from siss_tpu_torch.metrics import MembershipLoss
    from siss_tpu_torch.models import UNet2DConfig
    from siss_tpu_torch.train import unet_eps_apply
    from siss_tpu_torch.utils.hf_convert import load_unet2d

    device = resolve_device(args.device)
    ds_all = LabeledImageDataset.from_npz("nondeletion", args.npz, class_to_remove=args.class_label)
    ds_del = LabeledImageDataset.from_npz("deletion", args.npz, class_to_remove=args.class_label)
    model = load_unet2d(args.checkpoint, config or UNet2DConfig.mnist_tshirt(), args.subfolder,
                        device=device)
    schedule = NoiseSchedule.create(1000, "linear", device=device)
    ml = MembershipLoss(unet_eps_apply, schedule, ds_all, ds_del, args.num_images,
                        args.num_noises, eval_batch_size=512)
    ml.sample_images()
    ml.sample_noises()
    timesteps = list(range(0, 1000, args.time_frequency))
    return timesteps, ml.compute_membership_losses(model, timesteps)


def plot_curve(timesteps, losses, out: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(timesteps, [pair[0] for pair in losses], label="all")
    ax.plot(timesteps, [pair[1] for pair in losses], label="deletion")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("Membership loss")
    ax.set_title("Loss over time")
    ax.legend()
    fig.savefig(out)
    plt.close(fig)


def main(argv=None, config=None) -> dict:
    """Returns the timesteps, the (keep, forget) losses and the plot's path."""
    args = parse_args(argv)
    timesteps, losses = membership_losses(args, config)
    plot_curve(timesteps, losses, args.out)
    print(f"wrote {args.out}")
    return {"timesteps": timesteps, "losses": losses, "out": args.out}


if __name__ == "__main__":
    main()
