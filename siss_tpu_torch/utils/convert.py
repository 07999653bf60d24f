"""Carry flax params into the port's modules.

The input is the nested dict of numpy arrays a flax param tree becomes under
``jax.tree.map(np.asarray, params)``. The name rules are the port's own copy
of the JAX package's converters and exporter (``siss_tpu/utils/sd_convert.py``
and ``siss_tpu/utils/export.py``), limited to the modules the port has:
``UNet2D``, ``UNet2DCondition``, the VAE (``AutoencoderKL``) and the CLIP
text tower. Block paths expand (``down_blocks_0_resnets_1`` →
``down_blocks.0.resnets.1``, ``transformer_blocks_0`` →
``transformer_blocks.0``, the VAE's ``down_blocks_0_downsamplers_0_conv`` →
``down_blocks.0.downsamplers.0.conv``, CLIP's ``layers_3`` →
``layers.3``), the GEGLU feed-forward's ``ff/geglu_proj`` and
``ff/out_proj`` become ``ff.net.0.proj`` and ``ff.net.2``, attention output
projections become ``to_out.0``, and flax leaf names map to torch's. The
CLIP text tower's keys take transformers' ``text_model.`` prefixes
(``clip_text_key``), the vision tower's its ``vision_model.`` ones, the
class embedding and the top-level ``visual_projection`` (``clip_vision_key``).
Kernels transpose from flax to torch layout: HWIO →
OIHW for convs, IO → OI for linears; embeddings keep their layout.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

_TOP_RE = re.compile(
    r"^(down_blocks|up_blocks)_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)$")
_MID_RE = re.compile(r"^mid_block_(resnets|attentions)_(\d+)$")
_TRANSFORMER_RE = re.compile(r"^transformer_blocks_(\d+)$")
_DOWNSAMPLER_CONV_RE = re.compile(r"^down_blocks_(\d+)_downsamplers_0_conv$")
_LAYERS_RE = re.compile(r"^layers_(\d+)$")
_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}


def _expand_block_names(parts: List[str]) -> List[str]:
    out = []
    for p in parts:
        m = _TOP_RE.match(p)
        if m:
            out += list(m.groups())
            continue
        m = _MID_RE.match(p)
        if m:
            out += ["mid_block", m.group(1), m.group(2)]
            continue
        m = _TRANSFORMER_RE.match(p)
        if m:
            out += ["transformer_blocks", m.group(1)]
            continue
        m = _DOWNSAMPLER_CONV_RE.match(p)
        if m:
            out += ["down_blocks", m.group(1), "downsamplers", "0", "conv"]
            continue
        m = _LAYERS_RE.match(p)
        if m:
            out += ["layers", m.group(1)]
            continue
        out.append(p)
    return out


def _fix_ff(parts: List[str]) -> List[str]:
    """ff/geglu_proj → ff.net.0.proj ; ff/out_proj → ff.net.2"""
    for i, p in enumerate(parts[:-1]):
        if p == "ff":
            if parts[i + 1] == "geglu_proj":
                return parts[:i] + ["ff", "net", "0", "proj"] + parts[i + 2:]
            if parts[i + 1] == "out_proj":
                return parts[:i] + ["ff", "net", "2"] + parts[i + 2:]
    return parts


def torch_key(names: Sequence[str]) -> str:
    """The diffusers state-dict key of the flax param at path ``names``."""
    names = _fix_ff([str(n) for n in names])
    parts = _expand_block_names(names[:-1])
    if parts and parts[-1] == "to_out":
        parts.append("0")
    return ".".join(parts + [_SUFFIX[names[-1]]])


# CLIP text: the flax module's top-level names → transformers' prefixes.
_CLIP_TEXT_PREFIX = {"token_embedding": "text_model.embeddings",
                     "position_embedding": "text_model.embeddings",
                     "layers": "text_model.encoder", "final_layer_norm": "text_model"}
_CLIP_MLP = {"mlp_fc1": ["mlp", "fc1"], "mlp_fc2": ["mlp", "fc2"]}


def clip_text_key(names: Sequence[str]) -> str:
    """transformers' ``CLIPTextModel`` key of the flax CLIP text param at
    path ``names``."""
    names = [str(n) for n in names]
    parts = []
    for p in _expand_block_names(names[:-1]):
        parts += _CLIP_MLP.get(p, [p])
    return ".".join([_CLIP_TEXT_PREFIX[parts[0]]] + parts + [_SUFFIX[names[-1]]])


# CLIP vision: the flax module's top-level names → transformers' prefixes
# (``visual_projection`` has none).
_CLIP_VISION_PREFIX = {"patch_embedding": "vision_model.embeddings",
                       "position_embedding": "vision_model.embeddings",
                       "layers": "vision_model.encoder", "pre_layrnorm": "vision_model",
                       "post_layernorm": "vision_model"}


def clip_vision_key(names: Sequence[str]) -> str:
    """transformers' ``CLIPVisionModelWithProjection`` key of the flax CLIP
    vision param at path ``names``."""
    names = [str(n) for n in names]
    if names == ["class_embedding"]:
        return "vision_model.embeddings.class_embedding"
    parts = []
    for p in _expand_block_names(names[:-1]):
        parts += _CLIP_MLP.get(p, [p])
    prefix = _CLIP_VISION_PREFIX.get(parts[0])
    return ".".join(([prefix] if prefix else []) + parts + [_SUFFIX[names[-1]]])


def _leaves(tree: Mapping[str, Any], prefix=()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path)
        else:
            yield path, sub


def params_from_flax(flax_params: Mapping[str, Any],
                     key_fn: Callable[[Sequence[str]], str] = torch_key) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) → torch state dict, keys by ``key_fn``:
    ``torch_key`` (diffusers names: the UNets and the VAE), ``clip_text_key``
    or ``clip_vision_key``."""
    sd: Dict[str, torch.Tensor] = {}
    for names, leaf in _leaves(flax_params):
        key = key_fn(names)
        arr = np.asarray(leaf)
        if arr.dtype not in (np.float32, np.float16, np.float64):
            arr = arr.astype(np.float32)
        if names[-1] == "kernel":
            if arr.ndim == 4:      # HWIO → OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:    # IO → OI
                arr = arr.transpose(1, 0)
        if key in sd:
            raise ValueError(f"key collision: {key} (from {'/'.join(names)})")
        sd[key] = torch.from_numpy(np.array(arr, order="C"))  # an owned, writable copy
    return sd


def load_flax_params(model: nn.Module, flax_params: Mapping[str, Any],
                     key_fn: Callable[[Sequence[str]], str] = torch_key) -> nn.Module:
    """Load a flax param tree into ``model`` with ``strict=True``."""
    model.load_state_dict(params_from_flax(flax_params, key_fn), strict=True)
    return model
