"""k-means memorisation classifier: port of ``siss_tpu/metrics/kmeans_mem.py``.

The reference predicts with a joblib'd sklearn KMeans over flattened
255-scaled pixels; ``fraction`` is the mean predicted label (label 1 is the
memorised cluster). The centers come from that joblib artifact or from an
``.npz`` holding ``centers``; prediction is the argmin of the summed squared
differences, on ``device``.

The distances keep the direct form Σ(x − c)². The expanded form ‖x‖² − 2x·c
+ ‖c‖² cancels at this scale: each term is ~10¹⁰ over a 512² image, which
fp32 holds to ~10³, so a near tie would flip the label.
"""

from __future__ import annotations

import numpy as np
import torch

from siss_tpu_torch.device import resolve_device


class KMeansMemClassifier:
    def __init__(self, centers: np.ndarray, device="cuda"):
        self.device = resolve_device(device)
        self.centers = torch.as_tensor(np.asarray(centers, np.float32), device=self.device)

    @classmethod
    def load(cls, path: str, device="cuda") -> "KMeansMemClassifier":
        """Centers from an ``.npz`` (``centers``) or a joblib'd sklearn KMeans
        (``cluster_centers_``; needs joblib and sklearn)."""
        if path.endswith(".npz"):
            with np.load(path) as z:
                return cls(z["centers"], device)
        import joblib

        return cls(np.asarray(joblib.load(path).cluster_centers_), device)

    @torch.no_grad()
    def predict(self, imgs01: np.ndarray) -> np.ndarray:
        """imgs01: [N, H, W, C] in [0, 1] → cluster ids, from the NHWC
        flatten at 255 scale (the reference's SCALE_FACTOR)."""
        imgs = np.asarray(imgs01, np.float32)
        flat = torch.as_tensor(imgs.reshape(len(imgs), -1), device=self.device) * 255.0
        d = torch.stack([((flat - c) ** 2).sum(-1) for c in self.centers], dim=-1)
        return d.argmin(-1).cpu().numpy()

    def fraction(self, imgs01: np.ndarray) -> float:
        """Mean predicted label: the fraction memorised (labels are 0/1)."""
        return float(self.predict(imgs01).mean())
