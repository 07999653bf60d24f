"""The text-conditional Stable Diffusion 1.x UNet (diffusers
``UNet2DConditionModel``), plain float32.

``forward(P, cfg, x, t, context)``: ε for NCHW latents ``x`` at timesteps
``t`` [B] under prompt embeddings ``context`` [B, L, D]. Each
Transformer2D: GroupNorm (eps 1e-6) → 1×1 proj_in → LayerNorm →
self-attention, LayerNorm → cross-attention, LayerNorm → GEGLU feed-forward
(exact gelu), each with a residual → 1×1 proj_out, plus the skip. The
LayerNorms take eps 1e-6, as the flax UNet the port follows does (diffusers
uses 1e-5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.nn import (attention, conv, downsample, group_norm, layer_norm, linear,
                                    resnet, timestep_embedding, upsample)

LN_EPS = 1e-6
TRANSFORMER_GN_EPS = 1e-6


def cross_attention(P, x, name, ch, heads, context=None, context_dim=None):
    B, N, _ = x.shape
    src = x if context is None else context
    src_dim = ch if context is None else context_dim
    d = ch // heads

    def split(a):
        return a.reshape(B, a.shape[1], heads, d).transpose(1, 2)

    q = split(linear(P, x, f"{name}.to_q", ch, ch, bias=False))
    k = split(linear(P, src, f"{name}.to_k", src_dim, ch, bias=False))
    v = split(linear(P, src, f"{name}.to_v", src_dim, ch, bias=False))
    out = attention(P, q, k, v, 1.0 / math.sqrt(d)).transpose(1, 2).reshape(B, N, ch)
    return linear(P, out, f"{name}.to_out.0", ch, ch)


def transformer(P, x, context, name, ch, heads, context_dim, groups):
    B, C, H, W = x.shape
    h = group_norm(P, x, f"{name}.norm", groups, ch, TRANSFORMER_GN_EPS)
    h = conv(P, h, f"{name}.proj_in", ch, ch, 1).permute(0, 2, 3, 1).reshape(B, H * W, C)
    b = f"{name}.transformer_blocks.0"
    h = h + cross_attention(P, layer_norm(P, h, f"{b}.norm1", ch, LN_EPS), f"{b}.attn1", ch, heads)
    h = h + cross_attention(P, layer_norm(P, h, f"{b}.norm2", ch, LN_EPS), f"{b}.attn2", ch, heads,
                            context, context_dim)
    f = layer_norm(P, h, f"{b}.norm3", ch, LN_EPS)
    value, gate = linear(P, f, f"{b}.ff.net.0.proj", ch, 8 * ch).chunk(2, dim=-1)
    h = h + linear(P, value * F.gelu(gate), f"{b}.ff.net.2", 4 * ch, ch)
    h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return conv(P, h, f"{name}.proj_out", ch, ch, 1) + x


def forward(P, cfg, x, t, context):
    boc = list(cfg["block_out_channels"])
    ch0, n, groups, eps = boc[0], len(boc), cfg["norm_num_groups"], cfg["norm_eps"]
    temb_ch = 4 * ch0
    # SD-1.x's config calls its number of heads attention_head_dim (8 heads
    # of 40, 80 and 160 channels), a diffusers quirk kept under its own name.
    heads, ctx_dim = cfg["attention_head_dim"], cfg["cross_attention_dim"]

    def attn(h, name, ch):
        return transformer(P, h, context, name, ch, heads, ctx_dim, groups)

    emb = timestep_embedding(t, ch0, cfg["flip_sin_to_cos"], cfg["freq_shift"])
    emb = linear(P, F.silu(linear(P, emb, "time_embedding.linear_1", ch0, temb_ch)),
                 "time_embedding.linear_2", temb_ch, temb_ch)
    h = conv(P, x, "conv_in", cfg["in_channels"], ch0, 3, padding=1)
    skips, cur = [h], ch0
    for i, kind in enumerate(cfg["down_block_types"]):
        out = boc[i]
        for j in range(cfg["layers_per_block"]):
            h = resnet(P, h, emb, f"down_blocks.{i}.resnets.{j}", cur, out, temb_ch, groups, eps)
            if kind == "CrossAttnDownBlock2D":
                h = attn(h, f"down_blocks.{i}.attentions.{j}", out)
            cur = out
            skips.append(h)
        if i != n - 1:
            h = downsample(P, h, f"down_blocks.{i}.downsamplers.0", out, 1)
            skips.append(h)
    mid = boc[-1]
    h = resnet(P, h, emb, "mid_block.resnets.0", mid, mid, temb_ch, groups, eps)
    h = attn(h, "mid_block.attentions.0", mid)
    h = resnet(P, h, emb, "mid_block.resnets.1", mid, mid, temb_ch, groups, eps)
    for i, kind in enumerate(cfg["up_block_types"]):
        out = boc[n - 1 - i]
        for j in range(cfg["layers_per_block"] + 1):
            skip = skips.pop()
            h = resnet(P, torch.cat([h, skip], dim=1), emb, f"up_blocks.{i}.resnets.{j}",
                       cur + skip.shape[1], out, temb_ch, groups, eps)
            if kind == "CrossAttnUpBlock2D":
                h = attn(h, f"up_blocks.{i}.attentions.{j}", out)
            cur = out
        if i != n - 1:
            h = upsample(P, h, f"up_blocks.{i}.upsamplers.0", out)
    h = F.silu(group_norm(P, h, "conv_norm_out", groups, ch0, eps))
    return conv(P, h, "conv_out", ch0, cfg["out_channels"], 3, padding=1)
