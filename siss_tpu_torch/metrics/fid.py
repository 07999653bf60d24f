"""Fréchet Inception Distance with a pluggable feature extractor: port of
``siss_tpu/metrics/fid.py``.

The real set's statistics are computed once and cached; fake batches stream
through ``update``; ``compute`` takes the exact Fréchet distance on the host
(float64 ``scipy.linalg.sqrtm``) and clears the fake set. The feature
function is injected: InceptionV3's 2048-d pool, or the random-projection
embedder when no InceptionV3 weights are at hand (``metrics/inception_v3.py``).
An optional classifier drops one class from either set before embedding.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2√(Σ₁Σ₂)) in float64. When the square root is
    not finite (singular covariances), it is taken again with ``eps`` added
    to both diagonals; its real part is kept."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def _stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and unbiased covariance of [N, D] features."""
    return features.mean(axis=0), np.cov(features, rowvar=False)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class FIDEvaluator:
    """``feature_fn(imgs) -> [N, D]`` takes NHWC numpy float images in
    [0, 1] and returns a tensor or an array. ``metric_key`` is
    ``metrics/fid`` only for the ``inception_v3`` embedder; any other logs
    under ``metrics/fid_<embedder>``, so a random-projection FID is never
    taken for InceptionV3's."""

    def __init__(self, feature_fn: Callable, real_images: Optional[np.ndarray] = None,
                 inception_batch_size: int = 64, remove_class_classifier=None,
                 remove_class: Optional[int] = None, embedder: str = "inception_v3"):
        self.feature_fn = feature_fn
        self.embedder = embedder
        self.metric_key = ("metrics/fid" if embedder == "inception_v3"
                           else f"metrics/fid_{embedder}")
        self.batch_size = inception_batch_size
        self.remove_class_classifier = remove_class_classifier
        self.remove_class = remove_class
        self._fake_feats = []
        self._real_stats = None
        if real_images is not None:
            self.set_real_images(real_images)

    def _filter(self, imgs: np.ndarray) -> np.ndarray:
        if self.remove_class_classifier is None or self.remove_class is None:
            return imgs
        logits = self.remove_class_classifier.compute_logits(imgs)
        return imgs[logits.argmax(-1) != self.remove_class]

    def _features(self, imgs: np.ndarray) -> np.ndarray:
        return np.concatenate([_to_numpy(self.feature_fn(imgs[i:i + self.batch_size]))
                               for i in range(0, len(imgs), self.batch_size)], axis=0)

    def set_real_images(self, real_images: np.ndarray) -> None:
        self._real_stats = _stats(self._features(self._filter(np.asarray(real_images))))

    def update(self, fake_images: np.ndarray) -> None:
        self._fake_feats.append(self._features(self._filter(np.asarray(fake_images))))

    def compute(self) -> Tuple[float, float]:
        """(fid, seconds of this call: the statistics and the square root on
        the host); the fake set is cleared."""
        if self._real_stats is None:
            raise RuntimeError("call set_real_images first")
        start = time.perf_counter()
        mu_f, sig_f = _stats(np.concatenate(self._fake_feats, axis=0))
        fid = frechet_distance(*self._real_stats, mu_f, sig_f)
        self._fake_feats = []
        return fid, time.perf_counter() - start
