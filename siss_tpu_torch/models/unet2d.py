"""Unconditional 2D UNet (ε model): port of ``siss_tpu/models/unet2d.py``.

Architecture-compatible with diffusers ``UNet2DModel`` and with the flax
``UNet2D``: same blocks, the same skip stack with concat order [h, skip],
fp32 output. Module names are diffusers', so ``utils.convert`` carries a
flax param tree over with ``strict=True``. ``dtype=torch.bfloat16`` runs the
body under ``torch.autocast`` with fp32 master params, the counterpart of the
flax module's ``dtype=jnp.bfloat16``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    SpatialAttention,
    TimestepEmbedding,
    Upsample2D,
    get_timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """Static architecture description (the diffusers config keys)."""

    sample_size: int = 28
    in_channels: int = 1
    out_channels: int = 1
    block_out_channels: Tuple[int, ...] = (64, 128, 256)
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "AttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = ("UpBlock2D", "AttnUpBlock2D", "UpBlock2D")
    layers_per_block: int = 2
    attention_head_dim: Optional[int] = 8  # None → single head over all channels
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    dropout: float = 0.0
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    add_mid_attention: bool = True

    @classmethod
    def mnist_tshirt(cls) -> "UNet2DConfig":
        """Tiny MNIST UNet of the t-shirt task."""
        return cls()

    @classmethod
    def celebahq_256(cls) -> "UNet2DConfig":
        """google/ddpm-celebahq-256 architecture, the flagship unlearning model."""
        return cls(
            sample_size=256,
            in_channels=3,
            out_channels=3,
            block_out_channels=(128, 128, 256, 256, 512, 512),
            down_block_types=("DownBlock2D", "DownBlock2D", "DownBlock2D",
                              "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D",
                            "UpBlock2D", "UpBlock2D", "UpBlock2D"),
            attention_head_dim=None,
            flip_sin_to_cos=False,
            freq_shift=1,
            downsample_padding=0,
        )


def _num_heads(channels: int, head_dim: Optional[int]) -> int:
    return 1 if head_dim is None else max(channels // head_dim, 1)


class _Block(nn.Module):
    """A diffusers down/mid/up block: ``resnets``, ``attentions`` and an
    optional resampler list, under the names the state dict uses."""

    def __init__(self, resnets, attentions, resampler_name=None, resampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            self.add_module(resampler_name, nn.ModuleList([resampler]))


class UNet2D(nn.Module):
    """ε-prediction UNet: ``model(x_nchw, t) -> eps`` in fp32."""

    def __init__(self, config: UNet2DConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        if cfg.dropout != 0.0:
            raise NotImplementedError("dropout > 0 is not ported yet (ROADMAP Queue 1 item 6d)")
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        n = len(cfg.block_out_channels)

        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        skip_channels = [ch0]
        cur = ch0
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cur, out_ch, temb, g, eps))
                if block_type == "AttnDownBlock2D":
                    attns.append(SpatialAttention(out_ch, _num_heads(out_ch, cfg.attention_head_dim), g, eps))
                cur = out_ch
                skip_channels.append(cur)
            down = None
            if i != n - 1:
                down = Downsample2D(out_ch, out_ch, padding=cfg.downsample_padding)
                skip_channels.append(cur)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))

        mid = cfg.block_out_channels[-1]
        msf = cfg.mid_block_scale_factor
        mid_attns = ([SpatialAttention(mid, _num_heads(mid, cfg.attention_head_dim), g, eps, msf)]
                     if cfg.add_mid_attention else [])
        self.mid_block = _Block([ResnetBlock2D(mid, mid, temb, g, eps, msf),
                                 ResnetBlock2D(mid, mid, temb, g, eps, msf)], mid_attns)

        reversed_channels = tuple(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = reversed_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cur + skip_channels.pop(), out_ch, temb, g, eps))
                if block_type == "AttnUpBlock2D":
                    attns.append(SpatialAttention(out_ch, _num_heads(out_ch, cfg.attention_head_dim), g, eps))
                cur = out_ch
            up = Upsample2D(out_ch, out_ch) if i != n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        with torch.autocast(sample.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                           flip_sin_to_cos=cfg.flip_sin_to_cos,
                                           downscale_freq_shift=float(cfg.freq_shift))
            emb = self.time_embedding(t_emb)
            h = self.conv_in(sample)
            skips = [h]
            for block in self.down_blocks:
                for j, resnet in enumerate(block.resnets):
                    h = resnet(h, emb)
                    if len(block.attentions):
                        h = block.attentions[j](h)
                    skips.append(h)
                if hasattr(block, "downsamplers"):
                    h = block.downsamplers[0](h)
                    skips.append(h)

            h = self.mid_block.resnets[0](h, emb)
            if len(self.mid_block.attentions):
                h = self.mid_block.attentions[0](h)
            h = self.mid_block.resnets[1](h, emb)

            for block in self.up_blocks:
                for j, resnet in enumerate(block.resnets):
                    h = resnet(torch.cat([h, skips.pop()], dim=1), emb)
                    if len(block.attentions):
                        h = block.attentions[j](h)
                if hasattr(block, "upsamplers"):
                    h = block.upsamplers[0](h)

            h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()


def build_unet(config: UNet2DConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
               device="cuda") -> UNet2D:
    """A randomly initialised ``UNet2D`` on ``device``: fp32 params, compute
    in ``dtype``; channels_last memory format on the card. The weights are
    drawn on the host from ``seed``, so they do not depend on the device."""
    dev = resolve_device(device)
    model = init_weights(UNet2D(config, dtype=dtype), torch.Generator().manual_seed(seed))
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator``, in the flax initializers' spirit:
    conv and linear weights ~ N(0, 1/fan_in), biases 0, norms scale 1."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            noise = torch.randn(w.shape, generator=generator, device=generator.device)
            w.copy_(noise / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
