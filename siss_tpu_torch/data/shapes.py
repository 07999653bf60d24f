"""CLEVR-style shapes dataset: port of ``siss_tpu/data/shapes.py``.

Rendered shape images sit in one directory per (shape, color, size)
configuration; configurations are kept or dropped by name. No shipped
config uses it; it is kept for experiment parity.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from siss_tpu_torch.data.datasets import _to_nhwc, normalize_to_unit_range, read_image


class ShapesDataset:
    def __init__(self, data_path: str, include_configs: Optional[Sequence[str]] = None,
                 exclude_configs: Optional[Sequence[str]] = None, normalize: bool = True):
        """``data_path/<config>/<image files>``, where a config's name
        encodes its shape attributes (e.g. ``red_cube_large``)."""
        configs = sorted(
            d for d in os.listdir(data_path) if os.path.isdir(os.path.join(data_path, d)))
        if include_configs is not None:
            configs = [c for c in configs if c in set(include_configs)]
        if exclude_configs is not None:
            configs = [c for c in configs if c not in set(exclude_configs)]
        self.files: List[Tuple[str, str]] = []
        for c in configs:
            for f in sorted(glob.glob(os.path.join(data_path, c, "*"))):
                if f.lower().endswith((".png", ".jpg", ".jpeg")):
                    self.files.append((f, c))
        self.configs = configs
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = _to_nhwc(read_image(self.files[idx][0]))
        return normalize_to_unit_range(img) if self.normalize else np.asarray(img, np.float32)

    def config_of(self, idx: int) -> str:
        return self.files[idx][1]
