"""AutoencoderKL (the Stable Diffusion VAE): port of ``siss_tpu/models/vae.py``.

The frozen latent codec of the SD task: ``encode_sample`` turns images into
``latent_dist.sample() × scaling_factor`` for the train step, ``decode``
turns sampled latents back into images for validation. Module names follow
diffusers ``AutoencoderKL`` (``encoder.down_blocks.0.resnets.0.conv1``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``, …), so a
snapshot's ``vae/diffusion_pytorch_model.bin`` loads with
``load_state_dict``; the attention names of older checkpoints
(``query``/``key``/``value``/``proj_attn``, the CompVis SD-1.4 VAE) are
renamed on the way in.

The modules are NCHW inside (``channels_last`` on the card); the methods
take and return NHWC tensors, as the JAX module's do, through permuted
views. ``dtype`` other than float32 runs the convolutions under
``torch.autocast`` over fp32 params; moments, latents and images come out
in fp32. Random draws are arguments: ``encode_sample`` takes its normal
draw, or a ``torch.Generator`` to draw it from.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.models.layers import Downsample2D, ResnetBlock2D, SpatialAttention, Upsample2D
from siss_tpu_torch.models.unet2d import _Block, init_weights

_GN_EPS = 1e-6
# diffusers' pre-0.14 attention names → the current ones.
_OLD_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def sd_v1(cls) -> "AutoencoderKLConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "AutoencoderKLConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
                   latent_channels=4)

    @property
    def scale_factor(self) -> int:
        """Pixels per latent along each side."""
        return 2 ** (len(self.block_out_channels) - 1)


def _mid_block(ch: int, groups: int) -> _Block:
    return _Block([ResnetBlock2D(ch, ch, None, groups, _GN_EPS),
                   ResnetBlock2D(ch, ch, None, groups, _GN_EPS)],
                  [SpatialAttention(ch, num_heads=1, groups=groups, eps=_GN_EPS)])


def _run_mid(mid: _Block, h: torch.Tensor) -> torch.Tensor:
    h = mid.resnets[0](h, None)
    h = mid.attentions[0](h)
    return mid.resnets[1](h, None)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        g, chs = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = chs[0]
        for i, out_ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cur, out_ch, None, g, _GN_EPS))
                cur = out_ch
            # diffusers' VAE downsample: pad (0, 1) on H and W, then a
            # stride-2 VALID 3×3 convolution
            down = Downsample2D(out_ch, out_ch, padding=0) if i < len(chs) - 1 else None
            self.down_blocks.append(_Block(resnets, [], "downsamplers", down))
        self.mid_block = _mid_block(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=_GN_EPS)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h, None)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chs = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, chs[0], 3, padding=1)
        self.mid_block = _mid_block(chs[0], g)
        self.up_blocks = nn.ModuleList()
        cur = chs[0]
        for i, out_ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cur, out_ch, None, g, _GN_EPS))
                cur = out_ch
            up = Upsample2D(out_ch, out_ch) if i < len(chs) - 1 else None
            self.up_blocks.append(_Block(resnets, [], "upsamplers", up))
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=_GN_EPS)
        self.conv_out = nn.Conv2d(chs[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h, None)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: AutoencoderKLConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def _autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=self.dtype, enabled=self.dtype != torch.float32)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images in [−1, 1] → (mean, logvar), NHWC fp32, of the
        diagonal-Gaussian latent posterior; logvar clipped to [−30, 20]."""
        with self._autocast(x.device):
            moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.float().permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_sample(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(mean + exp(½·logvar)·noise) × scaling_factor``: NHWC latents,
        with ``noise`` given or drawn from ``generator`` after the encode."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents (scaled by ``scaling_factor``) → NHWC fp32 images."""
        with self._autocast(z.device):
            h = self.post_quant_conv((z / self.config.scaling_factor).permute(0, 3, 1, 2))
            out = self.decoder(h)
        return out.float().permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode_sample(x, noise, generator))

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor], strict: bool = True, **kw):
        """Also takes the old attention names (``…attentions.0.query.weight``
        → ``…attentions.0.to_q.weight``, ``proj_attn`` → ``to_out.0``), and
        attention projections stored as 1×1 convolutions."""
        sd = {}
        for key, value in state_dict.items():
            parts = key.split(".")
            if len(parts) >= 2 and parts[-2] in _OLD_ATTENTION:
                parts[-2:-1] = _OLD_ATTENTION[parts[-2]].split(".")
            if ".attentions." in key and value.ndim == 4 and value.shape[2:] == (1, 1):
                value = value[:, :, 0, 0]
            sd[".".join(parts)] = value
        return super().load_state_dict(sd, strict=strict, **kw)


def build_vae(config: AutoencoderKLConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
              device="cuda") -> AutoencoderKL:
    """A randomly initialised ``AutoencoderKL`` on ``device`` (weights drawn
    on the host from ``seed``); channels_last on the card."""
    dev = resolve_device(device)
    model = init_weights(AutoencoderKL(config, dtype=dtype), torch.Generator().manual_seed(seed))
    model = model.to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
