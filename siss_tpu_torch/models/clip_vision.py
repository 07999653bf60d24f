"""CLIP vision tower (ViT): port of ``siss_tpu/models/clip_vision.py``.

The image tower of CLIP ViT-L/14, which CLIP-IQA scores images with: a patch
convolution without bias, a class token, position embeddings,
``pre_layrnorm``, the text tower's pre-LN encoder layers without a mask,
``post_layernorm`` on the class token and ``visual_projection`` without
bias; ``model(pixel_values [B, 3, H, W]) -> [B, projection_dim]``. Module
names follow transformers' ``CLIPVisionModelWithProjection``
(``vision_model.embeddings.patch_embedding``, …,
``vision_model.encoder.layers.{i}.self_attn.q_proj``,
``vision_model.post_layernorm``, ``visual_projection``; ``pre_layrnorm`` is
transformers' spelling), so its state dict loads with ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.models.clip_text import CLIPEncoderLayer, CLIPTextConfig
from siss_tpu_torch.models.unet2d import init_weights


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_l14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64, projection_dim=16)

    @classmethod
    def from_transformers(cls, d: dict) -> "CLIPVisionConfig":
        """From a transformers ``config.json``: a vision config's keys, or a
        whole CLIP config's ``vision_config``."""
        d = d.get("vision_config", d)
        names = {"image_size": "image_size", "patch_size": "patch_size",
                 "hidden_size": "hidden_size", "num_hidden_layers": "num_layers",
                 "num_attention_heads": "num_heads", "intermediate_size": "intermediate_size",
                 "projection_dim": "projection_dim", "layer_norm_eps": "layer_norm_eps"}
        return cls(**{ours: d[theirs] for theirs, ours in names.items() if theirs in d})

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    def as_text_cfg(self) -> CLIPTextConfig:
        """The encoder layers' widths, in the text tower's config."""
        return CLIPTextConfig(vocab_size=1, hidden_size=self.hidden_size,
                              num_layers=self.num_layers, num_heads=self.num_heads,
                              intermediate_size=self.intermediate_size,
                              max_position_embeddings=self.num_positions,
                              layer_norm_eps=self.layer_norm_eps)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)  # [B, P, D]
        cls_tok = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls_tok, patches], dim=1)
        return x + self.position_embedding.weight[:x.shape[1]][None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        text_cfg = cfg.as_text_cfg()
        self.layers = nn.ModuleList([CLIPEncoderLayer(text_cfg) for _ in range(cfg.num_layers)])


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        no_mask = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.encoder.layers:
            x = layer(x, no_mask)
        return self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    """``model(pixel_values [B, 3, H, W] CLIP-normalised) ->
    [B, projection_dim]``: the projected pooled embedding, fp32. ``dtype``
    other than float32 runs the body under ``torch.autocast`` over fp32
    params."""

    def __init__(self, config: CLIPVisionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        with torch.autocast(pixel_values.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.visual_projection(self.vision_model(pixel_values))
        return out.float()

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor], strict: bool = True, **kw):
        """transformers' state dict: the ``position_ids`` buffer it may carry
        is not a parameter here."""
        sd = {k: v for k, v in state_dict.items() if not k.endswith("embeddings.position_ids")}
        return super().load_state_dict(sd, strict=strict, **kw)


@torch.no_grad()
def build_clip_vision(config: CLIPVisionConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                      device="cuda") -> CLIPVisionModel:
    """A randomly initialised ``CLIPVisionModel`` on ``device``, weights drawn
    on the host from ``seed`` (class and position embeddings ~
    N(0, 1/hidden_size))."""
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(CLIPVisionModel(config, dtype=dtype), gen)
    emb = model.vision_model.embeddings
    for p in (emb.class_embedding, emb.position_embedding.weight):
        p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(config.hidden_size))
    return model.to(resolve_device(device))
