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
   summed over the ``fsdp`` ranks, each whole leaf counted once.

Under a ``tensor`` axis (``parallel.tensor``) the parameters with a Megatron
role are split over the ``tensor`` ranks instead, and the model runs on
them as they are: they are never gathered for the step. Each leaf records
its split dimension and its axis, ``fsdp`` or ``tensor``; the step's sums
run over each leaf's own group. The ranks of a tensor group compute the
same whole leaves' gradients, but for the whole biases that a split layer
uses only in its slice (``partial``): those are summed over the tensor
ranks (``scatter_add_``).

A ``Sharding`` over a mesh whose ``fsdp`` and ``tensor`` axes are 1 splits
nothing, and each of its collectives reduces to what the ``data`` axis
alone does. Its state dicts (``full_state_dict``) have the one-process
format on every mesh.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch

from siss_tpu_torch.parallel.distributed import RankMesh, world_size
from siss_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, fsdp_dim
from siss_tpu_torch.parallel.multihost import (BUCKET_NUMEL, all_gather_along, all_reduce_,
                                               all_reduce_sum, reduce_scatter_add_)
from siss_tpu_torch.parallel.tensor import split_modules, take_chunked, unchunk, unsplit_modules


def world_mesh() -> RankMesh:
    """The mesh of a caller that names none: every rank on ``data``."""
    return RankMesh(data=world_size())


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    if t.ndim == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class Sharding:
    """Which block of each of ``model``'s parameters this rank holds
    (``shard_module`` makes one). ``dims[i]`` is the dimension along which
    parameter i is split, None where it is whole; ``axes[i]`` the mesh axis
    that splits it (``"fsdp"`` or ``"tensor"``), ``chunks[i]`` the equal
    chunks its split dimension is cut into before each is split (GEGLU's
    [h | gate]: 2), ``partial[i]`` whether a whole parameter is used only in
    this rank's slice on the tensor axis; ``full_shapes[i]`` its whole
    shape."""

    def __init__(self, model: torch.nn.Module, mesh: RankMesh, dims: Sequence[Optional[int]],
                 full_shapes: Sequence[torch.Size], axes: Optional[Sequence[Optional[str]]] = None,
                 chunks: Optional[Sequence[int]] = None, partial: Optional[Sequence[bool]] = None):
        self.model, self.mesh = model, mesh
        self.names = [name for name, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.dims, self.full_shapes = list(dims), list(full_shapes)
        self.axes = (list(axes) if axes is not None
                     else [None if d is None else "fsdp" for d in self.dims])
        self.chunks = list(chunks) if chunks is not None else [1] * len(self.dims)
        self.partial = list(partial) if partial is not None else [False] * len(self.dims)
        self.sharded = any(d is not None for d in self.dims)
        #: Whether the step gathers the whole parameters (some are fsdp blocks).
        self.gathers = "fsdp" in self.axes
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self._on = {axis: torch.tensor([a == axis for a in self.axes])
                    for axis in ("fsdp", "tensor") if axis in self.axes}

    def layout(self, p: torch.Tensor):
        """(split dimension or None, whole shape) of parameter ``p``."""
        i = self._index[id(p)]
        return self.dims[i], self.full_shapes[i]

    def split_of(self, p: torch.Tensor):
        """(axis, chunks) of parameter ``p``'s split."""
        i = self._index[id(p)]
        return self.axes[i], self.chunks[i]

    def axis_group(self, axis: str):
        """(ranks, this rank's coordinate, group) of a mesh axis."""
        m = self.mesh
        if axis == "tensor":
            return m.tensor, m.tensor_rank, m.tensor_group
        return m.fsdp, m.fsdp_rank, m.fsdp_group

    # -- blocks -------------------------------------------------------------

    def take(self, t: torch.Tensor, dim: Optional[int], axis: str = "fsdp",
             chunks: int = 1) -> torch.Tensor:
        """This rank's block along ``dim`` of a whole tensor split over
        ``axis`` (``t`` when ``dim`` is None)."""
        if dim is None:
            return t
        n, me, _ = self.axis_group(axis)
        return take_chunked(t, dim, n, me, chunks)

    def gather_along(self, tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                     axes: Optional[Sequence[Optional[str]]] = None,
                     chunks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """The whole tensors of the blocks ``tensors`` split along ``dims``
        over ``axes`` (``"fsdp"`` unless named; a tensor whose dim is None
        as it is). Collective over each axis."""
        axes = axes if axes is not None else ["fsdp"] * len(dims)
        chunks = chunks if chunks is not None else [1] * len(dims)
        out = list(tensors)
        for axis in ("fsdp", "tensor"):
            split = [i for i, d in enumerate(dims) if d is not None and axes[i] == axis]
            if not split:
                continue
            n, _, group = self.axis_group(axis)
            whole = all_gather_along([tensors[i] for i in split], [dims[i] for i in split], group)
            for i, t in zip(split, whole):
                out[i] = unchunk(t, dims[i], n, chunks[i])
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
        dims = [d if a in axes else None for d, a in zip(self.dims, self.axes)]
        return self.gather_along(tensors, dims, self.axes, self.chunks)

    def gather_host(self, tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                    axes: Optional[Sequence[Optional[str]]] = None,
                    chunks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """``gather_along`` a bucket at a time, each whole tensor moved to
        the host before the next bucket is gathered: a checkpoint never
        holds a whole tree on the device. Whole leaves are returned as they
        are. ``axes`` and ``chunks`` default to the parameters'."""
        axes = self.axes if axes is None else axes
        chunks = self.chunks if chunks is None else chunks
        out = list(tensors)
        run: List[int] = []
        total = 0

        def flush():
            for i, t in zip(run, self.gather_along([tensors[i] for i in run],
                                                   [dims[i] for i in run],
                                                   [axes[i] for i in run],
                                                   [chunks[i] for i in run])):
                out[i] = t.cpu()
            run.clear()

        for i, d in enumerate(dims):
            if d is None:
                continue
            n = tensors[i].numel() * self.axis_group(axes[i])[0]
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
        """Add this rank's block of the ``fsdp`` ranks' sum of each whole
        gradient ``grads[i]`` to ``accs[i]`` (the sum of a whole leaf; on
        ``fsdp`` 1, the gradient itself), cast to the accumulator's dtype.
        A tensor block's gradient is its own; a whole leaf used in slices
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
            reduce_scatter_add_(grads, self.dims, accs, self.mesh.fsdp_group)

    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One whole gradient tree summed over all ranks, as this rank's
        blocks (collective): all-reduced in place when nothing is split."""
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
        one), summed over the leaves of the whole tree: each axis's split
        leaves' parts over that axis's ranks (one all-reduce an axis), each
        whole leaf once."""
        if not self.sharded:
            return values.sum(-1)
        whole = torch.ones(values.shape[-1], dtype=torch.bool)
        total = 0
        for axis, on in self._on.items():
            on = on.to(values.device)
            total = total + all_reduce_sum(values[..., on].sum(-1), self.axis_group(axis)[2])
            whole = whole & ~on.cpu()
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
            for name, t in zip(self.names, self.gather_host(self.params, self.dims)):
                sd[name] = t.detach()
        return sd

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a one-process state dict: each rank keeps its blocks."""
        blocks = dict(sd)
        for name, dim, axis, n in zip(self.names, self.dims, self.axes, self.chunks):
            if name in blocks:
                blocks[name] = self.take(blocks[name], dim, axis, n)
        self.model.load_state_dict(blocks)


def shard_module(model: torch.nn.Module, mesh: Optional[RankMesh] = None,
                 min_size: int = FSDP_MIN_SIZE) -> Sharding:
    """Split ``model``'s parameters over ``mesh`` (the world's data axis by
    default: nothing split): over its ``fsdp`` ranks each parameter that
    ``fsdp_dim`` splits; over its ``tensor`` ranks each parameter with a
    Megatron role that ``tp_dim`` splits, its module made local
    (``parallel.tensor.split_modules``). Each split parameter becomes this
    rank's block of it, in the parameter's memory format, and the whole
    storage is released. Load whole weights before; afterwards, through the
    ``Sharding``."""
    mesh = mesh or world_mesh()
    params = list(model.parameters())
    shapes = [p.shape for p in params]
    if mesh.tensor > 1:
        placement = split_modules(model, mesh)
        sharding = Sharding(model, mesh, placement.dims, shapes,
                            [None if d is None else "tensor" for d in placement.dims],
                            placement.chunks, placement.partial)
    else:
        sharding = Sharding(model, mesh, [fsdp_dim(p.shape, mesh.fsdp, min_size) for p in params],
                            shapes)
    with torch.no_grad():
        for p, dim, axis, n in zip(params, sharding.dims, sharding.axes, sharding.chunks):
            if dim is not None:
                view = sharding.take(p.detach(), dim, axis, n)
                block = torch.empty(view.shape, dtype=p.dtype, device=p.device,
                                    memory_format=_memory_format(p))
                p.data = block.copy_(view)
    return sharding
