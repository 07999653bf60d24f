"""Static L2-threshold t-shirt detector: port of ``siss_tpu/metrics/tshirt.py``."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class TShirtClassifier:
    @staticmethod
    def get_tshirt_frequency(imgs, tshirt_img, threshold: float = 10.0) -> Tuple[float, np.ndarray]:
        """imgs: [N, H, W, C] in [0, 1]; tshirt_img: [H, W, C] in the same
        range. Returns (match frequency, boolean match mask): an image
        matches when its L2 distance to the t-shirt is below ``threshold``."""
        imgs = np.asarray(imgs, np.float32)
        target = np.asarray(tshirt_img, np.float32).reshape(-1)
        flat = imgs.reshape(imgs.shape[0], -1)
        dists = np.sqrt(np.sum((flat - target[None, :]) ** 2, axis=1))
        matches = dists < threshold
        return float(matches.mean()), matches
