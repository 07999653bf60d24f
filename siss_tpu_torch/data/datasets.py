"""Datasets with keep/forget filtering: port of ``siss_tpu/data/datasets.py``
for the labelled-image sets of the t-shirt task.

Images come back as float32 NHWC numpy arrays, as in the JAX package;
``normalize_to_unit_range`` maps uint8 [0, 255] to [-1, 1] (ToTensor +
Normalize(0.5, 0.5)). ``filter`` is one of ``all``, ``deletion`` (only the
class to remove) and ``nondeletion`` (everything else).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def normalize_to_unit_range(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] → float32 [-1, 1]. Integer inputs are
    scaled by their type, never by their values."""
    arr = np.asarray(img)
    if np.issubdtype(arr.dtype, np.integer):
        out = arr.astype(np.float32) / 255.0
    else:
        out = arr.astype(np.float32)
    return out * 2.0 - 1.0


def _to_nhwc(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


class ArrayDataset:
    """In-memory images (+ optional labels)."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None,
                 normalize: bool = False):
        self.images = images
        self.labels = labels
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = _to_nhwc(np.asarray(self.images[idx]))
        return normalize_to_unit_range(img) if self.normalize else np.asarray(img, np.float32)


class LabeledImageDataset(ArrayDataset):
    """Integer-labelled image set with deletion-class filtering, from arrays
    or from an ``.npz`` holding ``images`` and ``labels``."""

    def __init__(self, filter: str, images: np.ndarray, labels: np.ndarray,
                 class_to_remove: Optional[int] = None, normalize: bool = True):
        labels = np.asarray(labels)
        if filter == "all":
            keep = np.arange(len(labels))
        elif filter in ("deletion", "nondeletion"):
            if class_to_remove is None:
                raise ValueError(f"{filter.capitalize()} filter requires removal class to be "
                                 "specified.")
            keep = np.where((labels == class_to_remove) == (filter == "deletion"))[0]
        else:
            raise ValueError("Invalid filter.")
        super().__init__(images[keep], labels[keep], normalize=normalize)

    @classmethod
    def from_npz(cls, filter: str, path: str, class_to_remove: Optional[int] = None,
                 normalize: bool = True) -> "LabeledImageDataset":
        with np.load(path) as data:
            return cls(filter, data["images"], data["labels"], class_to_remove, normalize)
