"""The unconditional DDPM UNet (diffusers ``UNet2DModel``), plain float32.

``forward(P, cfg, x, t)``: ε for NCHW ``x`` at integer timesteps ``t`` [B];
``cfg`` holds the diffusers config keys of the configuration file's
``unet`` group. Attention over the H×W grid: one head of all channels when
``attention_head_dim`` is null, else channels / head_dim heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.nn import (attention, conv, downsample, group_norm, linear, resnet,
                                    timestep_embedding, upsample)


def spatial_attention(P, x, name, ch, heads, groups, eps, out_scale=1.0):
    B, C, H, W = x.shape
    h = group_norm(P, x, f"{name}.group_norm", groups, ch, eps)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    d = C // heads

    def split(a):
        return a.reshape(B, H * W, heads, d).transpose(1, 2)

    q, k, v = (split(linear(P, h, f"{name}.{p}", ch, ch)) for p in ("to_q", "to_k", "to_v"))
    out = attention(P, q, k, v, 1.0 / math.sqrt(d)).transpose(1, 2).reshape(B, H * W, C)
    out = linear(P, out, f"{name}.to_out.0", ch, ch).reshape(B, H, W, C).permute(0, 3, 1, 2)
    return (out + x) / out_scale


def forward(P, cfg, x, t):
    boc = list(cfg["block_out_channels"])
    ch0, n, groups, eps = boc[0], len(boc), cfg["norm_num_groups"], cfg["norm_eps"]
    temb_ch = 4 * ch0
    hd = cfg["attention_head_dim"]

    def heads(ch):
        return 1 if hd is None else max(ch // hd, 1)

    emb = timestep_embedding(t, ch0, cfg["flip_sin_to_cos"], cfg["freq_shift"])
    emb = linear(P, F.silu(linear(P, emb, "time_embedding.linear_1", ch0, temb_ch)),
                 "time_embedding.linear_2", temb_ch, temb_ch)
    h = conv(P, x, "conv_in", cfg["in_channels"], ch0, 3, padding=1)
    skips, cur = [h], ch0
    for i, kind in enumerate(cfg["down_block_types"]):
        out = boc[i]
        for j in range(cfg["layers_per_block"]):
            h = resnet(P, h, emb, f"down_blocks.{i}.resnets.{j}", cur, out, temb_ch, groups, eps)
            if kind == "AttnDownBlock2D":
                h = spatial_attention(P, h, f"down_blocks.{i}.attentions.{j}", out, heads(out),
                                      groups, eps)
            cur = out
            skips.append(h)
        if i != n - 1:
            h = downsample(P, h, f"down_blocks.{i}.downsamplers.0", out,
                           cfg["downsample_padding"])
            skips.append(h)
    mid, msf = boc[-1], cfg["mid_block_scale_factor"]
    h = resnet(P, h, emb, "mid_block.resnets.0", mid, mid, temb_ch, groups, eps, msf)
    h = spatial_attention(P, h, "mid_block.attentions.0", mid, heads(mid), groups, eps, msf)
    h = resnet(P, h, emb, "mid_block.resnets.1", mid, mid, temb_ch, groups, eps, msf)
    for i, kind in enumerate(cfg["up_block_types"]):
        out = boc[n - 1 - i]
        for j in range(cfg["layers_per_block"] + 1):
            skip = skips.pop()
            h = resnet(P, torch.cat([h, skip], dim=1), emb, f"up_blocks.{i}.resnets.{j}",
                       cur + skip.shape[1], out, temb_ch, groups, eps)
            if kind == "AttnUpBlock2D":
                h = spatial_attention(P, h, f"up_blocks.{i}.attentions.{j}", out, heads(out),
                                      groups, eps)
            cur = out
        if i != n - 1:
            h = upsample(P, h, f"up_blocks.{i}.upsamplers.0", out)
    h = F.silu(group_norm(P, h, "conv_norm_out", groups, ch0, eps))
    return conv(P, h, "conv_out", ch0, cfg["out_channels"], 3, padding=1)
