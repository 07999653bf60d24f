"""Classifier wrapper for the metrics: port of ``siss_tpu/metrics/classifier.py``.

Wraps an NCHW classifier module (the port's ResNet) with batched
``compute_logits`` on NHWC images in [0, 1] and ``compute_class_frequency``.
``load_classifier_state`` reads a classifier checkpoint: a torch ``.pt``
state dict (the reference's artifact) or a bundle that
``tasks/train_classifier.py`` wrote.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from siss_tpu_torch.utils.checkpoint import ITEM_FILE, CheckpointManager

#: The bundle item ``tasks/train_classifier.py`` saves the weights under.
CLASSIFIER_ITEM = "classifier"


def load_classifier_state(path: str) -> dict:
    """The state dict at ``path``: a ``.pt``/``.pth``/``.bin`` file, one
    ``checkpoint-<n>`` bundle, or a run directory (its latest bundle).
    Raises ``FileNotFoundError`` when there is none; creates nothing."""
    path = str(path).rstrip("/")
    if path.endswith((".pt", ".pth", ".bin")):
        return torch.load(path, map_location="cpu", weights_only=True)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no classifier checkpoint at {path}")
    if os.path.isfile(os.path.join(path, CLASSIFIER_ITEM, ITEM_FILE)):
        return CheckpointManager(os.path.dirname(path) or ".").restore_item(path, CLASSIFIER_ITEM)
    return CheckpointManager(path).restore_item("latest", CLASSIFIER_ITEM)


class Classifier:
    def __init__(self, model: torch.nn.Module, transform: Optional[Callable] = None,
                 batch_size: int = 2048):
        """``model(imgs_nchw) -> logits``; it is put in eval mode."""
        self.model = model.eval()
        self.transform = transform
        self.batch_size = batch_size

    @torch.no_grad()
    def compute_logits(self, imgs, batch_size: Optional[int] = None) -> np.ndarray:
        """imgs: [N, H, W, C] float in [0, 1] → logits [N, num_classes]."""
        bs = batch_size or self.batch_size
        imgs = np.asarray(imgs, np.float32)
        if self.transform is not None:
            imgs = np.asarray(self.transform(imgs), np.float32)
        device = next(self.model.parameters()).device
        outs = []
        for i in range(0, len(imgs), bs):
            x = torch.from_numpy(np.ascontiguousarray(imgs[i:i + bs])).to(device)
            outs.append(self.model(x.permute(0, 3, 1, 2)).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def compute_class_frequency(self, imgs, img_class: int) -> float:
        preds = self.compute_logits(imgs).argmax(-1)
        return float((preds == img_class).mean())
