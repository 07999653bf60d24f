"""CLIP-IQA image quality: port of ``siss_tpu/metrics/clip_iqa.py``.

The reference scores with torchmetrics' ``CLIPImageQualityAssessment``: the
CLIP image embedding's cosine similarity to the "Good photo." and "Bad
photo." anchor embeddings, ×100 (CLIP's logit scale), softmaxed; the score
is the mean P(good). Here the CLIP ViT-L/14 vision tower
(``models/clip_vision.py``) embeds on ``device``: CLIP-normalise, resize
to 224² (bilinear, antialiased when it shrinks, as ``jax.image.resize``;
the two agree to ~2e-7 at 512² and 64²),
embed, L2-normalise.

Weights: ``<dir>/vision/`` holds the tower's transformers-layout state dict
(one of ``utils.checkpoint.WEIGHT_FILES``; ViT-L/14 unless a transformers
``config.json`` beside it says otherwise) and ``<dir>/iqa_anchors.npz`` the
two anchors (``good``, ``bad``), with ``<dir>`` from ``SISS_CLIP_DIR`` or
``checkpoints/clip``. The JAX package reads an orbax directory there,
which the port cannot read. Without the files the metric reports itself
unavailable, with the JAX package's messages.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from siss_tpu_torch.utils.checkpoint import read_state_dict, weights_file

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_SIZE = 224


def clip_image_embedder(vision: CLIPVisionModel) -> Callable[[torch.Tensor], torch.Tensor]:
    """``embed(imgs [N, H, W, 3] in [0, 1]) -> [N, projection_dim]`` unit
    vectors: CLIP-normalise, resize to 224², the tower, L2-normalise."""
    device = next(vision.parameters()).device
    mean = torch.tensor(_CLIP_MEAN, device=device)
    std = torch.tensor(_CLIP_STD, device=device)

    @torch.no_grad()
    def embed(imgs: torch.Tensor) -> torch.Tensor:
        x = ((imgs - mean) / std).permute(0, 3, 1, 2)
        # The triangle filter widens only when it shrinks, as in JAX.
        shrink = max(x.shape[-2:]) > CLIP_SIZE
        x = F.interpolate(x, size=(CLIP_SIZE, CLIP_SIZE), mode="bilinear", align_corners=False,
                          antialias=shrink)
        e = vision(x)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    return embed


class CLIPIQA:
    """score(imgs) = E softmax(100·cos(img, "Good photo."), 100·cos(img,
    "Bad photo."))[good]."""

    def __init__(self, image_embed_fn: Callable[[torch.Tensor], torch.Tensor],
                 good_embed: np.ndarray, bad_embed: np.ndarray, device="cuda"):
        self.device = resolve_device(device)
        self.image_embed_fn = image_embed_fn
        anchors = np.stack([good_embed, bad_embed]).astype(np.float32)
        anchors = anchors / np.linalg.norm(anchors, axis=-1, keepdims=True)
        self.anchors = torch.as_tensor(anchors, device=self.device)

    @classmethod
    def try_load(cls, model_dir: Optional[str] = None, device="cuda") -> Optional["CLIPIQA"]:
        """The metric from ``model_dir`` (else ``SISS_CLIP_DIR``, else
        ``checkpoints/clip``), or None with a message: callers treat the
        metric as disabled."""
        model_dir = model_dir or os.environ.get("SISS_CLIP_DIR", "checkpoints/clip")
        if not os.path.isdir(model_dir):
            print(f"[clip_iqa] no CLIP weights under {model_dir}; metric disabled")
            return None
        try:
            vision_dir = os.path.join(model_dir, "vision")
            path = weights_file(vision_dir)
            if path is None:
                raise FileNotFoundError(f"no vision tower state dict under {vision_dir}")
            config = CLIPVisionConfig.vit_l14()
            if os.path.isfile(os.path.join(vision_dir, "config.json")):
                with open(os.path.join(vision_dir, "config.json")) as f:
                    config = CLIPVisionConfig.from_transformers(json.load(f))
            vision = CLIPVisionModel(config)
            vision.load_state_dict(read_state_dict(path))
            vision = vision.to(resolve_device(device)).eval().requires_grad_(False)
            with np.load(os.path.join(model_dir, "iqa_anchors.npz")) as anchors:
                good, bad = anchors["good"], anchors["bad"]
        except (OSError, KeyError, RuntimeError, ValueError) as e:
            print(f"[clip_iqa] unavailable ({e}); metric disabled")
            return None
        return cls(clip_image_embedder(vision), good, bad, device)

    @torch.no_grad()
    def score(self, imgs01: np.ndarray) -> float:
        imgs = torch.as_tensor(np.asarray(imgs01, np.float32), device=self.device)
        e = torch.as_tensor(self.image_embed_fn(imgs), device=self.device, dtype=torch.float32)
        probs = torch.softmax(100.0 * e @ self.anchors.T, dim=-1)  # CLIP logit scale
        return float(probs[:, 0].mean())
