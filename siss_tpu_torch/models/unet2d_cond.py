"""Text-conditional UNet (Stable Diffusion 1.x): port of
``siss_tpu/models/unet2d_cond.py``.

Architecture-compatible with diffusers ``UNet2DConditionModel`` and with the
flax ``UNet2DCondition``: cross-attention Transformer2D blocks (self-attention
→ text cross-attention → GEGLU feed-forward) interleaved with resnets.
Module names are diffusers' (``transformer_blocks.0``, ``ff.net.0.proj``,
``ff.net.2``, ``to_out.0``), so ``utils.convert`` carries a flax param tree
over with ``strict=True``. Activations are NCHW (``channels_last`` on the
card); ``dtype=torch.bfloat16`` runs the body under ``torch.autocast`` with
fp32 master params, the output is fp32.

``attention_impl`` picks the self-attention core as in the flax module:
``einsum`` (materialised fp32 logits), ``einsum_remat`` (the same math with
the QK→softmax→AV core checkpointed at the ≥1024-token self-attentions),
``flash`` (the port's CUDA flash-attention kernels, ``ops.flash_attention``,
wherever they apply) or ``auto``. ``gradient_checkpointing`` recomputes
each resnet, and each Transformer2D when ``remat_attention``, in the
backward; ``ff_impl="remat"`` recomputes the feed-forward. All checkpoints
are non-reentrant, so two ``autograd.grad`` pulls through one forward work.

``remat_policy`` picks what those checkpointed blocks save, as the flax
module's ``jax.checkpoint`` policies do: None saves nothing and recomputes
the whole block; ``"dots"`` (``checkpoint_dots``) saves the outputs of the
matmuls and convolutions and recomputes the rest; ``"dots_no_batch"``
(``dots_with_no_batch_dims_saveable``) saves only the matmuls without batch
dims (the linear layers), recomputing the convolutions and the attention's
batched products. The flash kernels' ``FlashAttention`` is no aten op that a
policy can name: its forward runs again in the recomputation under every
policy.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from siss_tpu_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    attention_core,
    get_timestep_embedding,
)
from siss_tpu_torch.models.unet2d import _Block, initialised
from siss_tpu_torch.ops.flash_attention import flash_attention
from siss_tpu_torch.parallel.tensor import TensorSplit, copy, local_size, row_linear


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    """Static architecture description; the knobs are the flax config's."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    gradient_checkpointing: bool = False
    attention_impl: str = "auto"   # "einsum" | "einsum_remat" | "flash" | "auto"
    ff_impl: str = "saved"         # "saved" | "remat"
    remat_attention: bool = True
    remat_policy: Optional[str] = None

    @classmethod
    def sd_v1(cls, gradient_checkpointing: bool = False, **kw) -> "UNet2DConditionConfig":
        return cls(gradient_checkpointing=gradient_checkpointing, **kw)

    @classmethod
    def tiny(cls) -> "UNet2DConditionConfig":
        """Small config for tests and dry runs."""
        return cls(
            sample_size=8, block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, num_attention_heads=4, cross_attention_dim=32,
            norm_num_groups=8,
        )


class CrossAttention(nn.Module):
    """diffusers ``Attention``: query from x, key/value from the context (or
    x for self-attention); heads × dim_head = inner channels.

    Under a ``tensor`` axis (``set_tensor_split``) ``to_q``/``to_k``/``to_v``
    hold this rank's heads/tp heads, on which the attention (the flash
    kernels included) runs locally, and ``to_out`` its block of input
    channels, whose partial output is summed over the tensor ranks."""

    _IMPLS = ("auto", "einsum", "einsum_remat", "flash")
    tensor_split = None

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, impl: str = "auto"):
        super().__init__()
        self.heads, self.dim_head, self.impl = heads, dim_head, impl
        inner = heads * dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def set_tensor_split(self, split: Optional[TensorSplit]) -> Tuple[str, ...]:
        """Run on this rank's heads under ``split`` (None: whole again).
        Returns the whole parameters used in a slice: none."""
        local_size(self.heads, split, "heads", "CrossAttention")
        self.tensor_split = split
        return ()

    def _use_flash(self, is_self: bool, n_q: int) -> bool:
        if self.impl not in self._IMPLS:
            raise ValueError(f"Unknown attention impl {self.impl!r}; "
                             f"expected one of {self._IMPLS}")
        # The kernels' sites: self-attention, N a multiple of 128, head_dim
        # ≤ 128. The 77-token cross-attention always stays einsum.
        compatible = is_self and n_q % 128 == 0 and self.dim_head <= 128
        if self.impl == "flash":
            return compatible
        # "auto" in the flax module also needs jax.default_backend() == "tpu"
        # (its kernel paid off there only at head_dim % 128 == 0). That clause
        # has no counterpart here, so auto never picks flash in the port; a
        # caller asks for the kernels with attention_impl="flash".
        return False

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        split = self.tensor_split
        x = copy(x, split)
        is_self = context is None
        context = x if is_self else copy(context, split)
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        B, Nq, inner = q.shape   # this rank's heads × dim_head under a split
        Nk = k.shape[1]

        def split_heads(a, n):  # [B, n, H·d] → a [B, H, n, d] view
            return a.reshape(B, n, -1, self.dim_head).transpose(1, 2)

        q, k, v = split_heads(q, Nq), split_heads(k, Nk), split_heads(v, Nk)
        scale = 1.0 / math.sqrt(self.dim_head)
        if self._use_flash(is_self, Nq):
            out = flash_attention(q, k, v, scale)
        elif self.impl == "einsum_remat" and is_self and Nq >= 1024 and torch.is_grad_enabled():
            # Save only q, k and v for the backward and recompute the logits,
            # instead of keeping the O(N²) softmax residuals.
            out = checkpoint(attention_core, q, k, v, scale, use_reentrant=False)
        else:
            out = attention_core(q, k, v, scale)
        out = out.transpose(1, 2).reshape(B, Nq, inner)
        return row_linear(out, self.to_out[0], split)


class GEGLU(nn.Module):
    """diffusers ``GEGLU``: one projection to 2·inner, split into value and
    gate, value × gelu(gate) with the exact (erf) gelu. Under a ``tensor``
    axis the projection holds this rank's block of the value's rows and the
    same block of the gate's, so the product stays local."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="none")


class GEGLUFeedForward(nn.Module):
    """diffusers ``FeedForward`` with GEGLU: ``net.0`` GEGLU, ``net.1`` the
    (inactive) dropout, ``net.2`` the output projection, row-split under a
    ``tensor`` axis: its partial output is summed over the tensor ranks."""

    tensor_split = None
    # The projection's rows are [h | gate]: two chunks, each split.
    tensor_chunks = {"net.0.proj.weight": 2, "net.0.proj.bias": 2}

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def set_tensor_split(self, split: Optional[TensorSplit]) -> Tuple[str, ...]:
        """Run on this rank's block of the inner channels under ``split``
        (None: whole again). Returns the whole parameters used in a slice:
        none."""
        local_size(self.inner, split, "inner channels", "GEGLUFeedForward")
        self.tensor_split = split
        return ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.tensor_split
        return row_linear(self.net[1](self.net[0](copy(x, split))), self.net[2], split)


class BasicTransformerBlock(nn.Module):
    """LayerNorm → self-attention, LayerNorm → cross-attention, LayerNorm →
    GEGLU feed-forward, each with a residual. The LayerNorms use flax's
    default eps 1e-6 (diffusers uses 1e-5)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 attention_impl: str = "auto", ff_impl: str = "saved"):
        super().__init__()
        if ff_impl not in ("saved", "remat"):
            raise ValueError(f"Unknown ff impl {ff_impl!r}; expected 'saved' or 'remat'")
        self.ff_impl = ff_impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, dim_head, impl=attention_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, impl=attention_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        h = self.norm3(x)
        if self.ff_impl == "remat" and torch.is_grad_enabled():
            return x + checkpoint(self.ff, h, use_reentrant=False)
        return x + self.ff(h)


class Transformer2D(nn.Module):
    """GroupNorm (eps 1e-6) → 1×1 proj_in → transformer block(s) → 1×1
    proj_out, plus the skip."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1,
                 groups: int = 32, attention_impl: str = "auto", ff_impl: str = "saved"):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads, context_dim,
                                  attention_impl, ff_impl)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        # NCHW → [B, HW, C]: a view when x is channels_last, as on the card.
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


_MATMULS = ("mm", "addmm")
_BATCHED_MATMULS = ("bmm", "baddbmm")
# The aten ops each remat policy saves: matmuls (the linear layers; under
# "dots" also the batched products) and, under "dots", convolutions.
_SAVED_OPS = {"dots": _MATMULS + _BATCHED_MATMULS + ("convolution",),
              "dots_no_batch": _MATMULS}


class _KeepOps(TorchDispatchMode):
    """The forward of a checkpointed block: keeps the outputs of the ops in
    ``names``, in call order."""

    def __init__(self, names, kept):
        super().__init__()
        self.names, self.kept = names, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.names:
            self.kept.append(out.detach())
        return out


class _ReuseOps(TorchDispatchMode):
    """A recomputation of that block: those ops' kept outputs in place of
    running them again. Every recomputation (one per backward pull) starts
    from the first."""

    def __init__(self, names, kept):
        super().__init__()
        self.names, self.kept, self.next = names, kept, 0

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ not in self.names:
            return func(*args, **(kwargs or {}))
        self.next += 1
        return self.kept[self.next - 1].detach()


def _policy_contexts(names):
    """``checkpoint``'s ``context_fn`` for a remat policy. PyTorch's own
    selective checkpointing hands each kept output out once, so a second
    pull through the same forward (the SISS step's two pulls) fails there;
    here the kept outputs serve every pull, as JAX's residuals do."""
    kept = []
    return _KeepOps(names, kept), _ReuseOps(names, kept)


class UNet2DCondition(nn.Module):
    """ε-prediction UNet: ``model(x_nchw, t, encoder_hidden_states) -> eps`` in fp32."""

    def __init__(self, config: UNet2DConditionConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        if (cfg.gradient_checkpointing and cfg.remat_policy is not None
                and cfg.remat_policy not in _SAVED_OPS):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        n = len(cfg.block_out_channels)

        def transformer(ch):
            return Transformer2D(ch, cfg.num_attention_heads, cfg.cross_attention_dim, groups=g,
                                 attention_impl=cfg.attention_impl, ff_impl=cfg.ff_impl)

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
                if block_type == "CrossAttnDownBlock2D":
                    attns.append(transformer(out_ch))
                cur = out_ch
                skip_channels.append(cur)
            down = None
            if i != n - 1:
                down = Downsample2D(out_ch, out_ch, padding=1)
                skip_channels.append(cur)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block([ResnetBlock2D(mid, mid, temb, g, eps),
                                 ResnetBlock2D(mid, mid, temb, g, eps)], [transformer(mid)])

        reversed_channels = tuple(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = reversed_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(cur + skip_channels.pop(), out_ch, temb, g, eps))
                if block_type == "CrossAttnUpBlock2D":
                    attns.append(transformer(out_ch))
                cur = out_ch
            up = Upsample2D(out_ch, out_ch) if i != n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def _remat(self, module, *args):
        """Run ``module``, recomputed in the backward when checkpointing, but
        for what ``remat_policy`` saves."""
        if not torch.is_grad_enabled():
            return module(*args)
        if self.config.remat_policy is None:
            return checkpoint(module, *args, use_reentrant=False)
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=functools.partial(_policy_contexts,
                                                       _SAVED_OPS[self.config.remat_policy]))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        res = trans = lambda module, *args: module(*args)  # noqa: E731
        if cfg.gradient_checkpointing:
            res = self._remat
            if cfg.remat_attention:
                trans = self._remat
        with torch.autocast(sample.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            context = encoder_hidden_states.to(self.dtype)
            t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                           flip_sin_to_cos=cfg.flip_sin_to_cos,
                                           downscale_freq_shift=float(cfg.freq_shift))
            emb = self.time_embedding(t_emb)
            h = self.conv_in(sample)
            skips = [h]
            for block in self.down_blocks:
                for j, resnet in enumerate(block.resnets):
                    h = res(resnet, h, emb)
                    if len(block.attentions):
                        h = trans(block.attentions[j], h, context)
                    skips.append(h)
                if hasattr(block, "downsamplers"):
                    h = block.downsamplers[0](h)
                    skips.append(h)

            h = res(self.mid_block.resnets[0], h, emb)
            h = trans(self.mid_block.attentions[0], h, context)
            h = res(self.mid_block.resnets[1], h, emb)

            for block in self.up_blocks:
                for j, resnet in enumerate(block.resnets):
                    h = res(resnet, torch.cat([h, skips.pop()], dim=1), emb)
                    if len(block.attentions):
                        h = trans(block.attentions[j], h, context)
                if hasattr(block, "upsamplers"):
                    h = block.upsamplers[0](h)

            h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()


def build_unet_cond(config: UNet2DConditionConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32, device="cuda") -> UNet2DCondition:
    """A randomly initialised ``UNet2DCondition`` on ``device``: fp32 params,
    compute in ``dtype``; channels_last memory format on the card. The
    weights are drawn on the host from ``seed``, so they do not depend on
    the device."""
    return initialised(lambda: UNet2DCondition(config, dtype=dtype), seed, device)
