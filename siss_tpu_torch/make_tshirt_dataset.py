"""Build the MNIST+t-shirt dataset npz (classes 0-9 digits + class 10
t-shirt): port of ``scripts/make_tshirt_dataset.py``.

  python3 -m siss_tpu_torch.make_tshirt_dataset [--out data/datasets/mnist_with_tshirt.npz]

Sources, in order of preference:
1. ``--hf claserken/mnist-with-tshirt`` via HF datasets (imported when
   asked for; offline it needs a local cache),
2. local MNIST/FashionMNIST idx files (``--mnist-dir``),
3. synthetic glyphs (``data.make_synthetic_mnist_tshirt``; the default,
   structurally equivalent).

Writes ``images`` (uint8 [N, 28, 28, 1]) and ``labels`` with
``np.savez_compressed``, and ``tshirt.png`` (the first t-shirt) beside
them, as the JAX script does. It runs on the host: it has no ``--device``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def main(argv=None) -> dict:
    """Returns the npz's path, its images and its labels."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="data/datasets/mnist_with_tshirt.npz")
    p.add_argument("--hf", default=None, help="HF dataset name (e.g. claserken/mnist-with-tshirt)")
    p.add_argument("--mnist-dir", default=None, help="dir with MNIST+FashionMNIST idx files")
    p.add_argument("--n-per-class", type=int, default=512, help="synthetic fallback size")
    args = p.parse_args(argv)

    if args.hf:
        import datasets as hfds

        ds = hfds.load_dataset(args.hf, split="train")
        images = np.stack([np.asarray(x)[..., None] for x in ds["image"]])
        labels = np.asarray(ds["label"])
    elif args.mnist_dir:
        mi = _read_idx(os.path.join(args.mnist_dir, "train-images-idx3-ubyte"))
        ml = _read_idx(os.path.join(args.mnist_dir, "train-labels-idx1-ubyte"))
        fi = _read_idx(os.path.join(args.mnist_dir, "fashion-train-images-idx3-ubyte"))
        fl = _read_idx(os.path.join(args.mnist_dir, "fashion-train-labels-idx1-ubyte"))
        tshirts = fi[fl == 0]  # FashionMNIST class 0 = t-shirt/top
        images = np.concatenate([mi, tshirts])[..., None]
        labels = np.concatenate([ml.astype(np.int64), np.full(len(tshirts), 10)])
    else:
        from siss_tpu_torch.data import make_synthetic_mnist_tshirt

        images, labels = make_synthetic_mnist_tshirt(n_per_class=args.n_per_class)
        print("NOTE: synthetic glyph dataset (no MNIST source available)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, images=images, labels=labels)
    # the canonical tshirt.png of the L2 detector
    # (configs/delete_tshirt.yaml: metrics.classifier.tshirt_path)
    from PIL import Image

    tshirt = images[labels == 10][0][..., 0]
    Image.fromarray(tshirt).save(os.path.join(os.path.dirname(args.out), "tshirt.png"))
    print(f"wrote {args.out}: images {images.shape}, classes {sorted(set(labels.tolist()))}")
    return {"out": args.out, "images": images, "labels": labels}


if __name__ == "__main__":
    main()
