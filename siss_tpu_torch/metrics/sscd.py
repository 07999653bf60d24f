"""SSCD copy-detection similarity: port of ``siss_tpu/metrics/sscd.py``.

The reference embeds images with the external ``sscd_disc_mixup``
TorchScript model (a ResNet-50 trunk) and scores them by a matmul against
the memorised image's embedding, without L2 normalisation. The port loads
the same TorchScript artifact onto ``device`` and runs it there; the JAX
package runs it on the host CPU in fp32 (on the card the task's TF32
setting holds: off in the shipped config). Inputs are ImageNet-normalised,
as the reference's transform config does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from siss_tpu_torch.device import resolve_device

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SSCDEvaluator:
    def __init__(self, ts_model, device="cuda"):
        self.device = resolve_device(device)
        self.model = ts_model
        self.mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(_IMAGENET_STD, device=self.device)

    @classmethod
    def load(cls, path: str, device="cuda") -> Optional["SSCDEvaluator"]:
        """The TorchScript model at ``path`` on ``device``, or None with the
        JAX package's message when it cannot be loaded."""
        try:
            return cls(torch.jit.load(path, map_location=resolve_device(device)).eval(), device)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"[sscd] unavailable ({e}); metric disabled")
            return None

    @torch.no_grad()
    def embed(self, imgs01: np.ndarray) -> torch.Tensor:
        """imgs01: [N, H, W, 3] in [0, 1] → the model's raw embeddings
        (not L2-normalised, as the reference scores them)."""
        x = torch.as_tensor(np.asarray(imgs01, np.float32), device=self.device)
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        return self.model(x).float()

    def similarities(self, imgs01: np.ndarray, mem_img01: np.ndarray) -> np.ndarray:
        """[N] dot products of each image's embedding with the memorised one's."""
        mem = self.embed(np.asarray(mem_img01)[None])
        return (mem @ self.embed(imgs01).T).squeeze(0).cpu().numpy()

    def mean_similarity(self, imgs01, mem_img01) -> float:
        return float(self.similarities(imgs01, mem_img01).mean())

    def max_similarity(self, imgs01, mem_img01) -> float:
        return float(self.similarities(imgs01, mem_img01).max())
