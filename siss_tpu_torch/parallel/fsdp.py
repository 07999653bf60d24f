"""The ``fsdp`` axis: a module's parameters split over the ``fsdp`` ranks of
the mesh. The JAX package places them with ``shard_params_fsdp`` and
``shard_state`` (``siss_tpu/parallel/mesh.py``) and lets XLA insert the
gathers and reduce-scatters; here they are written out.

``shard_module`` keeps on each rank its block, along ``fsdp_dim``, of every
parameter large enough to split: the module's parameters become those
blocks, the fp32 master copy, and the optimizer and EMA built on them hold
blocks too. Smaller parameters stay whole on every rank. The ranks along
``data`` hold the same blocks. A step then:

1. gathers the whole parameters once (``gather``), in the step's
   ``param_cast_dtype`` when it has one, and runs the model on them;
2. reduce-scatters each microbatch's pulled gradient trees into block-sized
   accumulators (``scatter_add_``), and after the last microbatch sums them
   over ``data`` (``finish_``);
3. forms every global scalar (norms, dot products, Adafactor's statistics)
   from each rank's partial sums (``sum_leaves``): the split leaves' parts
   summed over the ranks that split them, each whole leaf counted once.

Under a ``tensor`` axis (``parallel.tensor``) the parameters with a Megatron
role are split over the ``tensor`` ranks, and the model runs on those
blocks as they are: they are never gathered over ``tensor`` for the step.
With both axes, such a block is split once more over the ``fsdp`` ranks
along another dimension (``mesh.param_dims``, JAX's ``_param_spec``): the
step gathers it over ``fsdp`` alone, back to the tensor block the local
model computes on, and reduce-scatters its gradient over ``fsdp`` while it
stays split over ``tensor``. Each leaf's ``Layout`` records both splits;
the step's sums run over the group of the axes that split the leaf (the
``fsdp × tensor`` plane for a leaf split over both). The ranks of a tensor
group compute the same whole leaves' gradients, but for the whole biases
that a split layer uses only in its slice (``partial``): those are summed
over the tensor ranks (``scatter_add_``).

A ``Sharding`` over a mesh whose ``fsdp`` and ``tensor`` axes are 1 splits
nothing, and each of its collectives reduces to what the ``data`` axis
alone does. Its state dicts (``full_state_dict``) have the one-process
format on every mesh.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from siss_tpu_torch.parallel.distributed import RankMesh, world_size
from siss_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, param_dims
from siss_tpu_torch.parallel.multihost import (BUCKET_NUMEL, all_gather_along, all_reduce_,
                                               all_reduce_sum, reduce_scatter_add_)
from siss_tpu_torch.parallel.tensor import (TensorPlacement, split_modules, take_chunked,
                                            unchunk, unsplit_modules)


def world_mesh() -> RankMesh:
    """The mesh of a caller that names none: every rank on ``data``."""
    return RankMesh(data=world_size())


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    if t.ndim == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class Layout(NamedTuple):
    """How a tensor of a parameter's shape is split over the mesh: the
    dimension the ``tensor`` axis splits (None: whole over it), cut into
    ``chunks`` equal chunks that are each split (GEGLU's [h | gate]: 2),
    and the dimension the ``fsdp`` axis splits of that tensor block (None:
    whole over it)."""

    tensor: Optional[int] = None
    fsdp: Optional[int] = None
    chunks: int = 1

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes that split the tensor, ``fsdp`` first."""
        return tuple(a for a, d in (("fsdp", self.fsdp), ("tensor", self.tensor)) if d is not None)


class Sharding:
    """Which block of each of ``model``'s parameters this rank holds
    (``shard_module`` makes one). ``layouts[i]`` is parameter i's
    ``Layout``, ``partial[i]`` whether a whole parameter is used only in
    this rank's slice on the tensor axis, ``full_shapes[i]`` its whole
    shape."""

    def __init__(self, model: torch.nn.Module, mesh: RankMesh, layouts: Sequence[Layout],
                 full_shapes: Sequence[torch.Size], partial: Optional[Sequence[bool]] = None):
        self.model, self.mesh = model, mesh
        self.names = [name for name, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.layouts, self.full_shapes = list(layouts), list(full_shapes)
        self.partial = list(partial) if partial is not None else [False] * len(self.layouts)
        self.sharded = any(lay.axes for lay in self.layouts)
        #: Whether the step gathers parameters over ``fsdp`` (some are fsdp blocks).
        self.gathers = any(lay.fsdp is not None for lay in self.layouts)
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self._on = {axes: torch.tensor([lay.axes == axes for lay in self.layouts])
                    for axes in dict.fromkeys(lay.axes for lay in self.layouts) if axes}

    def layout(self, p: torch.Tensor):
        """(``Layout``, whole shape) of parameter ``p``."""
        i = self._index[id(p)]
        return self.layouts[i], self.full_shapes[i]

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes`` (one axis, or ``fsdp`` and ``tensor``)."""
        m = self.mesh
        return {("fsdp",): m.fsdp_group, ("tensor",): m.tensor_group,
                ("fsdp", "tensor"): m.plane_group}[tuple(axes)]

    def ranks(self, axes: Sequence[str]) -> int:
        """The ranks along ``axes``."""
        return math.prod(getattr(self.mesh, a) for a in axes)

    # -- blocks -------------------------------------------------------------

    def take(self, t: torch.Tensor, layout: Layout) -> torch.Tensor:
        """This rank's block of a whole tensor split as ``layout``: the
        fsdp block of the tensor block (``t`` when nothing splits it)."""
        m = self.mesh
        if layout.tensor is not None:
            t = take_chunked(t, layout.tensor, m.tensor, m.tensor_rank, layout.chunks)
        if layout.fsdp is not None:
            t = take_chunked(t, layout.fsdp, m.fsdp, m.fsdp_rank)
        return t

    def gather_along(self, tensors: Sequence[torch.Tensor],
                     layouts: Sequence[Layout]) -> List[torch.Tensor]:
        """The whole tensors of the blocks ``tensors`` split as ``layouts``
        (a tensor nothing splits as it is): gathered over ``fsdp``, back to
        the tensor blocks, then over ``tensor``. Collective over each axis."""
        out = list(tensors)
        for axis, n, group in (("fsdp", self.mesh.fsdp, self.mesh.fsdp_group),
                               ("tensor", self.mesh.tensor, self.mesh.tensor_group)):
            split = [i for i, lay in enumerate(layouts) if getattr(lay, axis) is not None]
            if not split:
                continue
            whole = all_gather_along([out[i] for i in split],
                                     [getattr(layouts[i], axis) for i in split], group)
            for i, t in zip(split, whole):
                lay = layouts[i]
                out[i] = t if axis == "fsdp" else unchunk(t, lay.tensor, n, lay.chunks)
        return out

    def gather(self, tensors: Optional[Sequence[torch.Tensor]] = None,
               dtype: Optional[torch.dtype] = None, axes=("fsdp", "tensor")) -> List[torch.Tensor]:
        """The whole parameters (detached; or the whole tensors of the
        parameter-shaped blocks ``tensors``, such as the EMA's), gathered
        over ``axes`` (blocks of another axis are returned as they are).
        With ``dtype``, fp32 blocks are cast before the gather, which equals
        a cast after it. A whole leaf is returned as it is unless cast."""
        tensors = [p.detach() for p in self.params] if tensors is None else list(tensors)
        if dtype is not None:
            tensors = [t.to(dtype) if t.dtype == torch.float32 else t for t in tensors]
        layouts = [Layout(lay.tensor if "tensor" in axes else None,
                          lay.fsdp if "fsdp" in axes else None, lay.chunks)
                   for lay in self.layouts]
        return self.gather_along(tensors, layouts)

    def gather_host(self, tensors: Sequence[torch.Tensor],
                    layouts: Optional[Sequence[Layout]] = None) -> List[torch.Tensor]:
        """``gather_along`` a bucket at a time, each whole tensor moved to
        the host before the next bucket is gathered: a checkpoint never
        holds a whole tree on the device. Whole leaves are returned as they
        are. ``layouts`` default to the parameters'."""
        layouts = self.layouts if layouts is None else layouts
        out = list(tensors)
        run: List[int] = []
        total = 0

        def flush():
            for i, t in zip(run, self.gather_along([tensors[i] for i in run],
                                                   [layouts[i] for i in run])):
                out[i] = t.cpu()
            run.clear()

        for i, lay in enumerate(layouts):
            if not lay.axes:
                continue
            n = tensors[i].numel() * self.ranks(lay.axes)
            if run and total + n > BUCKET_NUMEL:
                flush()
                total = 0
            run.append(i)
            total += n
        if run:
            flush()
        return out

    # -- the step's collectives -------------------------------------------

    def zeros(self, dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
        """Block-sized gradient accumulators in ``dtype`` (None: each
        parameter's)."""
        return [torch.zeros_like(p, dtype=dtype) for p in self.params]

    def scatter_add_(self, grads: Sequence[torch.Tensor], accs: Sequence[torch.Tensor]) -> None:
        """Add this rank's fsdp block of the ``fsdp`` ranks' sum of each
        gradient ``grads[i]`` to ``accs[i]`` (the sum of a leaf fsdp does
        not split; on ``fsdp`` 1, the gradient itself), cast to the
        accumulator's dtype. A gradient is the whole leaf's, or its tensor
        block's where ``tensor`` splits it; a whole leaf used in slices
        (``partial``) is summed over the tensor ranks first. Accumulators
        below fp32 take the blocks summed over ``data`` too, in the
        gradients' dtype before the cast (as JAX sums a batch-sharded
        gradient before it rounds it into a bf16 accumulator); fp32 ones are
        summed over ``data`` once, by ``finish_``."""
        grads = list(grads)
        parts = [i for i, used in enumerate(self.partial) if used]
        if parts:
            summed = [grads[i].clone() for i in parts]
            all_reduce_(summed, group=self.mesh.tensor_group)
            for i, t in zip(parts, summed):
                grads[i] = t
        if self._summed_early(accs):
            blocks = [torch.zeros_like(a, dtype=g.dtype) for g, a in zip(grads, accs)]
            self._add_blocks(grads, blocks)
            self.sum_over_data_(blocks)
            torch._foreach_add_(list(accs), [b.to(a.dtype) for b, a in zip(blocks, accs)])
        else:
            self._add_blocks(grads, accs)

    def finish_(self, accs: Sequence[torch.Tensor]) -> None:
        """After the last ``scatter_add_`` into ``accs``: their sum over
        ``data`` (fp32 accumulators; those below fp32 hold it already)."""
        if not self._summed_early(accs):
            self.sum_over_data_(accs)

    def _summed_early(self, accs: Sequence[torch.Tensor]) -> bool:
        return self.mesh.data > 1 and accs[0].dtype != torch.float32

    def _add_blocks(self, grads: Sequence[torch.Tensor], accs: Sequence[torch.Tensor]) -> None:
        if self.mesh.fsdp == 1:
            torch._foreach_add_(list(accs), [g.to(a.dtype) for g, a in zip(grads, accs)])
        else:
            reduce_scatter_add_(grads, [lay.fsdp for lay in self.layouts], accs,
                                self.mesh.fsdp_group)

    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One gradient tree summed over all ranks, as this rank's blocks
        (collective): all-reduced in place when nothing is split."""
        grads = list(grads)
        if not self.sharded:
            self.sum_over_data_(grads)
            return grads
        blocks = self.zeros(None)
        self.scatter_add_(grads, blocks)
        self.finish_(blocks)
        return blocks

    def sum_over_data_(self, tensors: Sequence[torch.Tensor]) -> None:
        """All-reduce (SUM) block-sized tensors in place over ``data``."""
        if self.mesh.data > 1:
            all_reduce_(tensors, group=self.mesh.data_group)

    def sum_leaves(self, values: torch.Tensor) -> torch.Tensor:
        """``values[..., i]``, a per-leaf value of this rank's leaf i (a
        block's part of it for a split leaf, the whole value for a whole
        one), summed over the leaves of the whole tree: the parts of the
        leaves split over each set of axes over those axes' ranks (one
        all-reduce a set), each whole leaf once."""
        if not self.sharded:
            return values.sum(-1)
        whole = torch.ones(values.shape[-1], dtype=torch.bool)
        total = 0
        for axes, on in self._on.items():
            total = total + all_reduce_sum(values[..., on.to(values.device)].sum(-1),
                                           self.group(axes))
            whole = whole & ~on
        return total + values[..., whole.to(values.device)].sum(-1)

    # -- whole models and state dicts -------------------------------------

    def full_copy(self) -> torch.nn.Module:
        """A copy of the model holding whole (uninitialised) parameters,
        whole modules and no gradients, for ``load_full``."""
        model = copy.deepcopy(self.model).requires_grad_(False)
        unsplit_modules(model)
        for p, shape in zip(model.parameters(), self.full_shapes):
            if tuple(p.shape) != tuple(shape):
                p.data = torch.empty(shape, dtype=p.dtype, device=p.device,
                                     memory_format=_memory_format(p))
        return model

    @torch.no_grad()
    def load_full(self, model: torch.nn.Module,
                  tensors: Optional[Sequence[torch.Tensor]] = None) -> torch.nn.Module:
        """Copy the whole parameters (or the whole tensors of the blocks
        ``tensors``) into ``model``, a ``full_copy``. Collective."""
        for p, t in zip(model.parameters(), self.gather(tensors)):
            p.copy_(t)
        return model

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole parameters (gathered to the
        host) on every rank: collective. Unsplit, the model's own."""
        sd = self.model.state_dict()
        if self.sharded:
            for name, t in zip(self.names, self.gather_host(self.params)):
                sd[name] = t.detach()
        return sd

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a one-process state dict: each rank keeps its blocks."""
        blocks = dict(sd)
        for name, lay in zip(self.names, self.layouts):
            if name in blocks:
                blocks[name] = self.take(blocks[name], lay)
        self.model.load_state_dict(blocks)


def shard_module(model: torch.nn.Module, mesh: Optional[RankMesh] = None,
                 min_size: int = FSDP_MIN_SIZE) -> Sharding:
    """Split ``model``'s parameters over ``mesh`` (the world's data axis by
    default: nothing split) as ``param_dims`` places them: over its
    ``tensor`` ranks each parameter with a Megatron role that the axis
    divides, its module made local (``parallel.tensor.split_modules``), and
    over its ``fsdp`` ranks each parameter of at least ``min_size``
    elements along a dimension the tensor axis left (a tensor block's fsdp
    block). Each split parameter becomes this rank's block of it, in the
    parameter's memory format, and the whole storage is released. Load
    whole weights before; afterwards, through the ``Sharding``."""
    mesh = mesh or world_mesh()
    named = list(model.named_parameters())
    dims = [param_dims(name.split("."), p.shape, mesh.fsdp, mesh.tensor, min_size)
            for name, p in named]
    placement = (split_modules(model, mesh, [t for t, _ in dims]) if mesh.tensor > 1
                 else TensorPlacement([1] * len(named), [False] * len(named)))
    sharding = Sharding(model, mesh, [Layout(t, f, c) for (t, f), c in zip(dims, placement.chunks)],
                        [p.shape for _, p in named], placement.partial)
    with torch.no_grad():
        for (_, p), lay in zip(named, sharding.layouts):
            if lay.axes:
                view = sharding.take(p.detach(), lay)
                block = torch.empty(view.shape, dtype=p.dtype, device=p.device,
                                    memory_format=_memory_format(p))
                p.data = block.copy_(view)
    return sharding
