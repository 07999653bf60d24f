"""Diffusers ``UNet2DModel`` checkpoints into the port's ``UNet2D``: port of
``siss_tpu/utils/hf_convert.py``.

The port's modules carry diffusers names already, so the map is the
identity for a checkpoint written by diffusers ≥ 0.18. Older hub
checkpoints (google/ddpm-celebahq-256 among them) name the attention
projections ``query``/``key``/``value``/``proj_attn``, sometimes stored as
1×1 convolutions of shape [O, I, 1]; those are renamed and squeezed on the
way in. The conversion is a strict bijection, as the JAX package's: every
parameter of the model must find a tensor of its shape, and every tensor of
the checkpoint must be used or be on ``UNUSED_TORCH_ALLOWLIST``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import torch
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.utils.checkpoint import (ITEM_FILE, CheckpointManager, load_frozen,
                                             read_state_dict)

#: The file names a diffusers model directory may hold, in the JAX package's
#: order of preference.
MODEL_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
               "diffusion_pytorch_model.bin", "pytorch_model.bin")

#: Pre-0.18 attention names: the modern projection → the legacy one.
LEGACY_ATTENTION = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}

# Tensors a diffusers checkpoint may carry that no parameter takes. Anything
# else left over is a conversion fault and fails loudly.
UNUSED_TORCH_ALLOWLIST = (
    r".*num_batches_tracked$",        # BatchNorm counters
    r".*position_ids$",               # CLIP buffer, not a weight
    r".*attn\.masked_bias$",
    r".*logit_scale$",                # CLIP temperature
)


def _can_read_safetensors() -> bool:
    try:
        import safetensors.torch  # noqa: F401
    except ImportError:
        return False
    return True


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a diffusers model directory (the first of
    ``MODEL_FILES`` in it that can be read here) or of a state-dict file; a
    ``"state_dict"`` wrapper is unwrapped."""
    if os.path.isdir(path):
        found = [os.path.join(path, n) for n in MODEL_FILES
                 if os.path.exists(os.path.join(path, n))]
        if not found:
            raise FileNotFoundError(f"No model file under {path}")
        # without the safetensors package a .bin beside a .safetensors is
        # read; a lone .safetensors still goes to read_state_dict, whose
        # ImportError names the package
        readable = found if _can_read_safetensors() else [
            f for f in found if not f.endswith(".safetensors")]
        path = (readable or found)[0]
    sd = read_state_dict(path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def candidate_keys(name: str) -> List[str]:
    """The checkpoint keys that may hold the port parameter ``name``: its own
    (modern) name first, then the legacy attention name."""
    parts = name.split(".")
    module, leaf = ".".join(parts[:-1]), parts[-1]
    for modern, legacy in LEGACY_ATTENTION.items():
        if module == modern or module.endswith("." + modern):
            return [name, f"{module[:len(module) - len(modern)]}{legacy}.{leaf}"]
    return [name]


def convert_unet2d(state_dict: Dict[str, torch.Tensor], model: nn.Module,
                   allow_unused: tuple = ()) -> Dict[str, torch.Tensor]:
    """A state dict with ``model``'s names, filled from a diffusers
    ``UNet2DModel`` state dict (modern or legacy attention names), that
    loads strictly into ``model``. Raises ``KeyError`` on a parameter with
    no tensor and ``ValueError`` on a shape mismatch or on a tensor left
    over that neither ``UNUSED_TORCH_ALLOWLIST`` nor ``allow_unused``
    matches."""
    used = set()
    out = {}
    for name, param in model.state_dict().items():
        cands = candidate_keys(name)
        for key in cands:
            if key in state_dict:
                t = state_dict[key]
                if t.ndim == 3 and param.ndim == 2:   # legacy 1×1 attention conv [O, I, 1]
                    t = t[:, :, 0]
                if tuple(t.shape) != tuple(param.shape):
                    raise ValueError(f"shape mismatch for {name}: checkpoint {key} "
                                     f"{tuple(t.shape)} vs model {tuple(param.shape)}")
                out[name] = t
                used.add(key)
                break
        else:
            raise KeyError(f"No checkpoint tensor for parameter {name}; tried {cands}")

    patterns = [re.compile(p) for p in UNUSED_TORCH_ALLOWLIST + tuple(allow_unused)]
    unused = [k for k in state_dict
              if k not in used and not any(p.match(k) for p in patterns)]
    if unused:
        raise ValueError(
            f"{len(unused)} checkpoint tensors were not consumed by the conversion "
            f"(e.g. {unused[:6]}). The model does not cover the checkpoint; refusing a "
            "partial load. If these tensors are irrelevant, pass allow_unused=[...] patterns.")
    return out


def import_hf_unet(model_dir: str, model: nn.Module) -> nn.Module:
    """Load a diffusers model directory (``config.json`` and its weights)
    into ``model`` strictly; returns ``model``."""
    model.load_state_dict(convert_unet2d(load_torch_state_dict(model_dir), model))
    return model


def read_unet_weights(checkpoint: str, model: nn.Module,
                      subfolder: str = "unet") -> Dict[str, torch.Tensor]:
    """``model``'s state dict from ``checkpoint``: a port bundle
    (``checkpoint-<n>`` holding ``<subfolder>/item.pt``, or ``<run
    dir>/latest``, the run's newest bundle), else a diffusers snapshot
    (``<subfolder>/`` holding the model files), model directory or
    state-dict file, under modern or pre-0.18 names (``convert_unet2d``)."""
    path = checkpoint.rstrip("/")
    root, leaf = os.path.split(path)
    if leaf == "latest" and not os.path.exists(path) and os.path.isdir(root):
        path = CheckpointManager(root).latest() or path
    item = os.path.join(path, subfolder, ITEM_FILE)
    if os.path.isfile(item):
        return read_state_dict(item)
    if not os.path.exists(path):
        raise FileNotFoundError(checkpoint)
    sub = os.path.join(path, subfolder)
    return convert_unet2d(load_torch_state_dict(sub if os.path.isdir(sub) else path), model)


def load_unet2d(checkpoint: str, config, subfolder: str = "unet",
                dtype: torch.dtype = torch.float32, device="cuda") -> nn.Module:
    """A ``UNet2D(config)`` computing in ``dtype`` with ``checkpoint``'s
    weights (``read_unet_weights``), frozen and in eval mode on ``device``
    (channels_last on the card). It is built on the meta device: no random
    initialisation runs."""
    from siss_tpu_torch.models import UNet2D

    dev = resolve_device(device)
    model = load_frozen(lambda: UNet2D(config, dtype=dtype),
                        lambda m: read_unet_weights(checkpoint, m, subfolder), dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
