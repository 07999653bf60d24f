"""The ``tensor`` axis: the UNets split Megatron-style over the ``tensor``
ranks of the mesh. The JAX package places each parameter with a Megatron
role by ``_tp_spec`` (``siss_tpu/parallel/mesh.py``) and lets GSPMD derive
the activations' layouts and insert the all-reduces; here the local modules
and their collectives are written out.

A column layer keeps its block of output channels, a row layer its block
of input channels, so that each attention block, each GEGLU feed-forward
and each resnet runs one all-reduce of its output in the forward:

* attention: ``to_q``/``to_k``/``to_v`` keep heads/tp heads (the celeb
  UNet's one head keeps channels/tp of its dimension, and its fp32 logits
  are all-reduced before the softmax), ``to_out`` is row-split;
* GEGLU: the projection keeps the r-th block of h and the r-th block of the
  gate (two chunks, so GEGLU stays local), ``net.2`` is row-split;
* resnet: ``conv1``, ``time_emb_proj`` and ``norm2`` keep channels/tp (and
  groups/tp), ``conv2`` keeps channels/tp inputs; its bias, like every row
  layer's, is added once, after the all-reduce.

Activations are whole on every tensor rank. ``copy`` marks where a whole
activation enters a split layer (its backward sums the ranks' partial
gradients), ``reduce`` where the ranks' partial outputs are summed (its
backward passes the whole gradient on): Megatron's f and g.

Each helper takes ``split`` None (no ``tensor`` axis) and then does what
the whole layer does, with no collective: a module has one forward.

``split_modules`` turns a whole model into this rank's local model. The
roles are ``tp_dim``'s alone (through ``param_dims``): each module that can
run split (``set_tensor_split``) and of whose parameters ``tp_dim`` splits
any is told its ``TensorSplit``; placement then keeps this rank's block of
each parameter that ``tp_dim`` splits (``parallel.fsdp.shard_module``), and
of that block its fsdp block where an ``fsdp`` axis splits it too. A module
whose roles the axis does not divide stays whole, as JAX replicates it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from siss_tpu_torch.ops.batched import rebatch, unbatch


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """What a local module knows of the ``tensor`` axis: its group (None:
    the world), its size and this rank's coordinate on it."""

    group: Any
    size: int
    rank: int

    def __deepcopy__(self, memo) -> "TensorSplit":
        return self   # a process group is not copied with the module


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` all-reduced (SUM) over ``group``, in ``t``'s memory
    format when it is dense (contiguous or channels_last)."""
    fmt = (torch.channels_last if t.ndim == 4 and not t.is_contiguous()
           and t.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    out = t.clone(memory_format=fmt)
    dist.all_reduce(out.as_strided((out.numel(),), (1,)), group=group)
    return out


class _Copy(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # A batched pull (``is_grads_batched``) reduces its physical stack.
        physical, level = unbatch(grad)
        out = _summed(physical, ctx.group)
        return (out if level is None else rebatch(out, level)), None


class _Reduce(torch.autograd.Function):
    """The forward sums over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """``x``, whole on every rank, as the input of a split layer."""
    return x if split is None else _Copy.apply(x, split.group)


def reduce(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """The sum over the tensor ranks of their partial ``x``."""
    return x if split is None else _Reduce.apply(x, split.group)


def block(t: torch.Tensor, split: Optional[TensorSplit], dim: int = 0) -> torch.Tensor:
    """This rank's block of a whole tensor along ``dim`` (a view)."""
    return t if split is None else take_chunked(t, dim, split.size, split.rank)


@dataclasses.dataclass
class TensorPlacement:
    """Per parameter of a model (``named_parameters`` order): the chunks its
    tensor-split dimension is cut into before each is split (2 for GEGLU's
    [h | gate]), and whether a whole parameter is used only in this rank's
    slice (its gradient is then summed over the tensor ranks)."""

    chunks: List[int]
    partial: List[bool]


def split_modules(model: torch.nn.Module, mesh, dims: List[Optional[int]]) -> TensorPlacement:
    """Tell each module of ``model`` that can run split, and of whose
    parameters the tensor dimensions ``dims`` (``named_parameters`` order;
    ``mesh.param_dims``) split any over ``mesh``'s tensor axis, its
    ``TensorSplit`` (the module's forward then runs locally), and return
    the rest of every parameter's placement. The parameters themselves are
    not touched. A module that does not divide over the axis raises in its
    ``set_tensor_split``."""
    split = TensorSplit(mesh.tensor_group, mesh.tensor, mesh.tensor_rank)
    dims = dict(zip((name for name, _ in model.named_parameters()), dims))
    chunks = dict.fromkeys(dims, 1)
    partial = dict.fromkeys(dims, False)
    for prefix, module in model.named_modules():
        if not hasattr(module, "set_tensor_split"):
            continue
        if all(dims[k] is None for k, _ in module.named_parameters(prefix)):
            continue
        inner = (lambda k: f"{prefix}.{k}") if prefix else (lambda k: k)
        for k in module.set_tensor_split(split):
            partial[inner(k)] = True
        for k, n in getattr(module, "tensor_chunks", {}).items():
            chunks[inner(k)] = n
    return TensorPlacement(list(chunks.values()), list(partial.values()))


def unsplit_modules(model: torch.nn.Module) -> None:
    """Make every local module of ``model`` whole again (its parameters are
    not touched): ``set_tensor_split(None)``."""
    for module in model.modules():
        if getattr(module, "tensor_split", None) is not None:
            module.set_tensor_split(None)


def take_chunked(t: torch.Tensor, dim: int, n: int, me: int, chunks: int = 1) -> torch.Tensor:
    """Block ``me`` of ``n`` of a whole tensor along ``dim``, taken from each
    of its ``chunks`` equal chunks along ``dim`` and concatenated (a view
    when ``chunks`` is 1)."""
    size = t.shape[dim] // (n * chunks)
    if chunks == 1:
        return t.narrow(dim, me * size, size)
    return torch.cat([c.narrow(dim, me * size, size) for c in t.chunk(chunks, dim)], dim)


def unchunk(t: torch.Tensor, dim: int, n: int, chunks: int) -> torch.Tensor:
    """The whole tensor of the ``n`` ranks' blocks of ``take_chunked``,
    concatenated in rank order along ``dim`` into ``t``."""
    if chunks == 1:
        return t
    blocks = [b.chunk(chunks, dim) for b in t.chunk(n, dim)]
    return torch.cat([blocks[r][c] for c in range(chunks) for r in range(n)], dim)


def row_linear(x: torch.Tensor, linear: torch.nn.Linear,
               split: Optional[TensorSplit]) -> torch.Tensor:
    """A row-split linear layer: this rank's partial product, summed over
    the tensor ranks, then the whole bias, once (in the product's type, as
    the layer adds it under autocast)."""
    if split is None:
        return linear(x)
    out = reduce(F.linear(x, linear.weight), split)
    return out if linear.bias is None else out + linear.bias.to(out.dtype)


def row_conv(x: torch.Tensor, conv: torch.nn.Conv2d, split: Optional[TensorSplit]) -> torch.Tensor:
    """A row-split convolution, as ``row_linear``: the partial output over
    this rank's input channels, summed, then the whole bias, once."""
    if split is None:
        return conv(x)
    out = reduce(conv._conv_forward(x, conv.weight, None), split)
    return out + conv.bias.to(out.dtype)[:, None, None]


def local_size(whole: int, split: Optional[TensorSplit], what: str, owner: str) -> int:
    """``whole`` heads, groups or channels divided over the tensor ranks:
    raises when they do not divide (a configuration the port does not
    split; JAX's GSPMD would reshard it)."""
    if split is None:
        return whole
    if whole % split.size:
        raise NotImplementedError(f"{owner}: {whole} {what} do not divide over tensor "
                                  f"{split.size}; such a configuration is not ported")
    return whole // split.size
