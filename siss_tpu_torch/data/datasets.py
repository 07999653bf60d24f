"""Datasets with keep/forget filtering: port of ``siss_tpu/data/datasets.py``
for the labelled-image sets of the t-shirt task and the image folders of the
celeb task.

Images come back as float32 NHWC numpy arrays, as in the JAX package;
``normalize_to_unit_range`` maps uint8 [0, 255] to [-1, 1] (ToTensor +
Normalize(0.5, 0.5)). ``filter`` is one of ``all``, ``deletion`` (only the
class to remove) and ``nondeletion`` (everything else).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

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


def read_image(path: str) -> np.ndarray:
    """An image file decoded with PIL, as its stored array (uint8 [H, W] or
    [H, W, C])."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


class ImageFolderDataset:
    """A folder of images (CelebA-HQ style). ``filter``: ``all`` lists the
    folder's images (sorted), ``deletion`` takes ``remove_img_names`` as they
    are, ``nondeletion`` the folder's images less those."""

    def __init__(self, filter: str, data_path: str,
                 remove_img_names: Optional[Sequence[str]] = None, normalize: bool = True,
                 extensions: Tuple[str, ...] = (".jpg", ".jpeg", ".png")):
        self.data_path = data_path
        files = sorted(f for f in os.listdir(data_path) if f.lower().endswith(extensions))
        if filter == "all":
            self.image_files = files
        elif filter in ("deletion", "nondeletion"):
            if remove_img_names is None:
                raise ValueError(f"{filter.capitalize()} filter requires removal class to be "
                                 "specified.")
            if filter == "deletion":
                self.image_files = list(remove_img_names)
            else:
                remove = set(remove_img_names)
                self.image_files = [f for f in files if f not in remove]
        else:
            raise ValueError("Invalid filter.")
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = _to_nhwc(read_image(os.path.join(self.data_path, self.image_files[idx])))
        return normalize_to_unit_range(img) if self.normalize else np.asarray(img, np.float32)


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
