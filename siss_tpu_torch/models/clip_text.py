"""CLIP text encoder (the ViT-L/14 text tower): port of
``siss_tpu/models/clip_text.py``.

The frozen conditioning model of the SD task: token and position
embeddings, pre-LN transformer layers with a causal mask and a quick-GELU
MLP, a final LayerNorm; ``model(input_ids) -> [B, N, hidden]``. Module names
follow transformers' ``CLIPTextModel`` (``text_model.embeddings.…``,
``text_model.encoder.layers.{i}.self_attn.q_proj``, ``….mlp.fc1``,
``text_model.final_layer_norm``), so a snapshot's
``text_encoder/pytorch_model.bin`` loads with ``load_state_dict`` (its
``text_model.embeddings.position_ids`` buffer is dropped on the way in).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.models.clip_bpe import CLIPBPETokenizer, load_native_clip_tokenizer
from siss_tpu_torch.models.unet2d import init_weights


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5

    @classmethod
    def sd_v1(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, max_position_embeddings=16)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head self-attention. The logits are fp32 with the causal mask
    (−1e9 above the diagonal) added before the softmax; the probabilities
    are cast to v's dtype for P·V, as in the flax module."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        d = cfg.hidden_size
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape

        def split(a):
            return a.reshape(B, N, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
            attn = torch.softmax(attn / math.sqrt(self.head_dim) + causal_mask, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        N = input_ids.shape[1]
        causal = torch.triu(torch.full((N, N), -1e9, dtype=torch.float32,
                                       device=input_ids.device), diagonal=1)[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """``model(input_ids [B, N] int) -> [B, N, hidden]``: the last hidden
    state, which SD feeds to the UNet's cross-attention. ``dtype`` other
    than float32 runs the body under ``torch.autocast`` over fp32 params;
    the output is fp32."""

    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        with torch.autocast(input_ids.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = self.text_model(input_ids.long())
        return out.float()

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor], strict: bool = True, **kw):
        """transformers' state dict: the ``position_ids`` buffer it may carry
        is not a parameter here."""
        sd = {k: v for k, v in state_dict.items() if not k.endswith("embeddings.position_ids")}
        return super().load_state_dict(sd, strict=strict, **kw)


@torch.no_grad()
def build_clip_text(config: CLIPTextConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                    device="cuda") -> CLIPTextModel:
    """A randomly initialised ``CLIPTextModel`` on ``device``, weights drawn
    on the host from ``seed`` (embeddings ~ N(0, 1/hidden_size))."""
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(CLIPTextModel(config, dtype=dtype), gen)
    for emb in (model.text_model.embeddings.token_embedding,
                model.text_model.embeddings.position_embedding):
        emb.weight.copy_(torch.randn(emb.weight.shape, generator=gen)
                         / math.sqrt(config.hidden_size))
    return model.to(resolve_device(device))


def load_clip_tokenizer(path: Optional[str] = None) -> Optional[CLIPBPETokenizer]:
    """The byte-level BPE tokenizer of ``path`` when it holds ``vocab.json``
    and ``merges.txt`` (an SD checkpoint's ``tokenizer/`` folder), else None:
    the task then needs precomputed prompt embeddings. The JAX module falls
    back to transformers' ``CLIPTokenizer`` from a hub cache; the port does
    not depend on transformers and has no such fallback."""
    if path and all(os.path.isfile(os.path.join(path, f)) for f in ("vocab.json", "merges.txt")):
        try:
            return load_native_clip_tokenizer(path)
        except (OSError, ValueError) as e:
            print(f"[clip] native tokenizer load failed ({e}); no tokenizer")
    return None
