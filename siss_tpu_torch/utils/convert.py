"""Carry flax UNet params into the port's modules.

The input is the nested dict of numpy arrays a flax param tree becomes under
``jax.tree.map(np.asarray, params)``. The name rules are the port's own copy
of the JAX package's exporter (``siss_tpu/utils/sd_convert.py`` and
``siss_tpu/utils/export.py``), limited to what ``UNet2D`` uses: block paths
expand (``down_blocks_0_resnets_1`` → ``down_blocks.0.resnets.1``),
attention output projections become ``to_out.0``, and flax leaf names map to
torch's. Kernels transpose from flax to torch layout: HWIO → OIHW for convs,
IO → OI for linears.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

_TOP_RE = re.compile(
    r"^(down_blocks|up_blocks)_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)$")
_MID_RE = re.compile(r"^mid_block_(resnets|attentions)_(\d+)$")
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
        out.append(p)
    return out


def _leaves(tree: Mapping[str, Any], prefix=()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path)
        else:
            yield path, sub


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax UNet param tree (numpy leaves) → diffusers-named torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for names, leaf in _leaves(flax_params):
        parts = _expand_block_names(list(names[:-1]))
        if parts and parts[-1] == "to_out":
            parts.append("0")
        key = ".".join(parts + [_SUFFIX[names[-1]]])
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


def load_flax_params(model: nn.Module, flax_params: Mapping[str, Any]) -> nn.Module:
    """Load a flax param tree into ``model`` with ``strict=True``."""
    model.load_state_dict(params_from_flax(flax_params), strict=True)
    return model
