"""Port models and bundles → diffusers model directories: port of
``siss_tpu/utils/export.py``.

A diffusers model directory is ``config.json`` plus the weights under
diffusers ≥ 0.18 names, which ``UNet2DModel.from_pretrained`` /
``UNet2DConditionModel.from_pretrained`` load and which
``utils/hf_convert.py`` imports back bit for bit. The port's modules carry
those names already, so the state dict needs no key map; pre-0.18 attention
names in a state dict handed in are renamed. The weights are written as
``diffusion_pytorch_model.bin`` (``torch.save``), where the JAX package
writes ``.safetensors``: the safetensors package is not a dependency of the
port.

    python3 -m siss_tpu_torch.utils.export --checkpoint <run>/checkpoint-60 \\
        --preset celebahq_256 --out exported/celeb60
    python3 -m siss_tpu_torch.utils.export --checkpoint <bundle> \\
        --run-config <run>/config.json --out exported/run
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Mapping, Union

import torch
from torch import nn

from siss_tpu_torch.utils.checkpoint import ITEM_FILE
from siss_tpu_torch.utils.hf_convert import LEGACY_ATTENTION

WEIGHTS_NAME = "diffusion_pytorch_model.bin"
_MODERN = {legacy: modern for modern, legacy in LEGACY_ATTENTION.items()}


def export_diffusers_state_dict(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]
                                ) -> Dict[str, torch.Tensor]:
    """A diffusers-named state dict of host tensors: float32 (bfloat16 and
    the other types but float16/float64 promoted), C-contiguous and owning
    their storage. Covers UNet2D, UNet2DCondition and the VAE; a pre-0.18
    attention name becomes its modern one (a [O, I, 1] projection squeezed),
    and two tensors that land on one name raise ``ValueError``."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        parts = key.split(".")
        t = value.detach().to("cpu")
        if len(parts) >= 2 and parts[-2] in _MODERN:
            parts[-2:-1] = _MODERN[parts[-2]].split(".")
            if t.ndim == 3:
                t = t[:, :, 0]
        name = ".".join(parts)
        if t.dtype not in (torch.float32, torch.float16, torch.float64):
            t = t.float()
        if name in out:
            raise ValueError(f"export key collision: {name} (from {key})")
        # torch.save writes a tensor's whole storage and strides: a fresh
        # row-major copy keeps the file to this tensor, in C order.
        out[name] = t.clone(memory_format=torch.contiguous_format)
    return out


def unet2d_config_json(cfg) -> Dict[str, Any]:
    """``UNet2DConfig`` → the diffusers ``UNet2DModel`` config.json dict
    (field names per diffusers 0.27, the version the reference pins)."""
    return {
        "_class_name": "UNet2DModel",
        "_diffusers_version": "0.27.2",
        "sample_size": cfg.sample_size,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "center_input_sample": False,
        "time_embedding_type": "positional",
        "freq_shift": cfg.freq_shift,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types),
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": cfg.mid_block_scale_factor,
        "downsample_padding": cfg.downsample_padding,
        "downsample_type": "conv",
        "upsample_type": "conv",
        "dropout": cfg.dropout,
        "act_fn": "silu",
        "attention_head_dim": cfg.attention_head_dim,
        "norm_num_groups": cfg.norm_num_groups,
        "norm_eps": cfg.norm_eps,
        "resnet_time_scale_shift": "default",
        "add_attention": cfg.add_mid_attention,
    }


def sd_unet_config_json(cfg) -> Dict[str, Any]:
    """``UNet2DConditionConfig`` → the diffusers ``UNet2DConditionModel``
    config.json dict. Diffusers' SD-v1 configs call the per-block head COUNT
    ``attention_head_dim`` (a historical naming quirk); the config's
    ``num_attention_heads`` maps onto it."""
    return {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": "0.27.2",
        "sample_size": cfg.sample_size,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "center_input_sample": False,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": cfg.freq_shift,
        "down_block_types": list(cfg.down_block_types),
        "mid_block_type": "UNetMidBlock2DCrossAttn",
        "up_block_types": list(cfg.up_block_types),
        "only_cross_attention": False,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "downsample_padding": 1,
        "mid_block_scale_factor": 1,
        "act_fn": "silu",
        "norm_num_groups": cfg.norm_num_groups,
        "norm_eps": cfg.norm_eps,
        "cross_attention_dim": cfg.cross_attention_dim,
        "attention_head_dim": cfg.num_attention_heads,
        "use_linear_projection": False,
    }


def diffusers_config_for(ucfg) -> Dict[str, Any]:
    """Dispatch on the architecture dataclass type."""
    name = type(ucfg).__name__
    if name == "UNet2DConfig":
        return unet2d_config_json(ucfg)
    if name == "UNet2DConditionConfig":
        return sd_unet_config_json(ucfg)
    raise TypeError(f"No diffusers config emitter for {name}; "
                    "pass an explicit config dict to save_diffusers_model_dir")


def save_diffusers_model_dir(model_or_state_dict, config: Any, out_dir: str) -> str:
    """Write a diffusers model directory: ``config.json`` and
    ``diffusion_pytorch_model.bin``. ``config`` is an architecture dataclass
    (UNet2DConfig / UNet2DConditionConfig) or a ready config dict."""
    cfg_dict = config if isinstance(config, dict) else diffusers_config_for(config)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(export_diffusers_state_dict(model_or_state_dict),
               os.path.join(out_dir, WEIGHTS_NAME))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2, sort_keys=True)
    return out_dir


def export_bundle_to_diffusers(checkpoint_dir: str, config: Any, out_dir: str,
                               items: tuple = ("unet", "unet_ema")) -> Dict[str, str]:
    """A port bundle (``checkpoint-<n>/<item>/item.pt``) → one diffusers
    model directory under ``out_dir`` for each of ``items`` it holds;
    ``config`` as for ``save_diffusers_model_dir``. Raises
    ``FileNotFoundError`` when it holds none of them."""
    written = {}
    for item in items:
        path = os.path.join(os.path.abspath(checkpoint_dir), item, ITEM_FILE)
        if not os.path.isfile(path):
            continue
        sd = torch.load(path, map_location="cpu", weights_only=True)
        written[item] = save_diffusers_model_dir(sd, config, os.path.join(out_dir, item))
    if not written:
        raise FileNotFoundError(f"None of {items} found under {checkpoint_dir}")
    return written


PRESETS = ("celebahq_256", "mnist_tshirt", "sd_v1", "sd_tiny")


def architecture(preset: str = None, run_config: str = None):
    """The architecture dataclass of a ``--preset`` or of a run's
    ``config.json`` (its ``unet`` node, a ``_target_`` the port reads)."""
    from siss_tpu_torch.config import get_object
    from siss_tpu_torch.models import UNet2DConditionConfig, UNet2DConfig

    if run_config:
        with open(run_config) as f:
            node = dict(json.load(f).get("unet") or {})
        fn = get_object(node.pop("_target_", "siss_tpu.models.unet2d.UNet2DConfig"))
        for k in ("block_out_channels", "down_block_types", "up_block_types"):
            if isinstance(node.get(k), list):
                node[k] = tuple(node[k])
        return fn(**node)
    if preset in ("celebahq_256", "mnist_tshirt"):
        return getattr(UNet2DConfig, preset)()
    if preset in ("sd_v1", "sd_tiny"):
        return UNet2DConditionConfig.sd_v1() if preset == "sd_v1" else UNet2DConditionConfig.tiny()
    raise SystemExit(f"Unknown --preset {preset!r}; pass --run-config for custom architectures")


def main(argv=None) -> Dict[str, str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="bundle directory (checkpoint-N) holding unet/unet_ema items")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--preset", default=None, choices=PRESETS,
                    help="architecture preset (or use --run-config)")
    ap.add_argument("--run-config", default=None,
                    help="a run's config.json; its unet node defines the architecture")
    ap.add_argument("--items", nargs="+", default=["unet", "unet_ema"],
                    help="bundle items to export (default: unet unet_ema)")
    args = ap.parse_args(argv)
    if not args.preset and not args.run_config:
        ap.error("one of --preset / --run-config is required")
    written = export_bundle_to_diffusers(args.checkpoint,
                                         architecture(args.preset, args.run_config), args.out,
                                         items=tuple(args.items))
    for item, path in written.items():
        print(f"[export] {item} -> {path}")
    return written


if __name__ == "__main__":
    main()
