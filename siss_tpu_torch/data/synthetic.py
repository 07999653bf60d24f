"""Synthetic stand-in for the MNIST-with-t-shirt dataset: port of
``siss_tpu/data/synthetic.py``.

28×28 grayscale digit-like glyphs for classes 0-9 plus a t-shirt shape as
class 10, deterministic in the seed and equal, image for image, to the JAX
package's (both draw from numpy's ``default_rng`` in the same order). The
t-shirt tasks write it where ``configs/*.yaml`` expect the dataset when that
file is missing.
"""

from __future__ import annotations

import numpy as np


def _glyph(rng: np.random.Generator, cls: int) -> np.ndarray:
    """A crude but class-distinctive 28×28 uint8 glyph."""
    img = np.zeros((28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    cx, cy = 14 + rng.normal(0, 1.2), 14 + rng.normal(0, 1.2)
    if cls == 10:
        # t-shirt: torso box + two sleeve boxes
        torso = (np.abs(xx - cx) < 6) & (np.abs(yy - cy) < 8)
        sleeves = (np.abs(yy - (cy - 5)) < 2.5) & (np.abs(xx - cx) < 11)
        img[torso | sleeves] = 1.0
    else:
        # digit proxy: cls+2 petals on a ring whose radius varies per class
        r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        theta = np.arctan2(yy - cy, xx - cx)
        ring = np.abs(r - (5 + 0.6 * cls)) < 1.8
        petals = np.cos((cls + 2) * theta) > 0.1
        img[ring & petals] = 1.0
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    img = np.clip(img, 0, 1)
    return (img * 255).astype(np.uint8)


def make_synthetic_mnist_tshirt(n_per_class: int = 64, num_classes: int = 11,
                                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images uint8 [N, 28, 28, 1], labels int64 [N]); class 10 is
    the t-shirt (``configs/delete_tshirt.yaml``'s ``deletion.class_label``)."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for cls in range(num_classes):
        for _ in range(n_per_class):
            images.append(_glyph(rng, cls)[..., None])
            labels.append(cls)
    perm = rng.permutation(len(images))
    return np.stack(images)[perm], np.asarray(labels, np.int64)[perm]
