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
   over ``data`` (``sum_over_data_``);
3. forms every global scalar (norms, dot products, Adafactor's statistics)
   from each rank's partial sums (``sum_leaves``): the split leaves' parts
   summed over the ``fsdp`` ranks, each whole leaf counted once.

A ``Sharding`` over a mesh whose ``fsdp`` axis is 1 splits nothing, and each
of its collectives reduces to what the ``data`` axis alone does. Its state
dicts (``full_state_dict``) have the one-process format on every mesh.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch

from siss_tpu_torch.parallel.distributed import RankMesh, world_size
from siss_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, fsdp_dim
from siss_tpu_torch.parallel.multihost import (BUCKET_NUMEL, all_gather_along, all_reduce_,
                                               all_reduce_sum, reduce_scatter_add_)


def world_mesh() -> RankMesh:
    """The mesh of a caller that names none: every rank on ``data``."""
    return RankMesh(data=world_size(), fsdp=1)


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    if t.ndim == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class Sharding:
    """Which block of each of ``model``'s parameters this rank holds
    (``shard_module`` makes one). ``dims[i]`` is the dimension along which
    parameter i is split, None where it is whole; ``full_shapes[i]`` its
    whole shape."""

    def __init__(self, model: torch.nn.Module, mesh: RankMesh, dims: Sequence[Optional[int]],
                 full_shapes: Sequence[torch.Size]):
        self.model, self.mesh = model, mesh
        self.names = [name for name, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.dims, self.full_shapes = list(dims), list(full_shapes)
        self.sharded = any(d is not None for d in self.dims)
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self._split = torch.tensor([d is not None for d in self.dims])

    def layout(self, p: torch.Tensor):
        """(split dimension or None, whole shape) of parameter ``p``."""
        i = self._index[id(p)]
        return self.dims[i], self.full_shapes[i]

    # -- blocks -------------------------------------------------------------

    def take(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's block along ``dim`` of a whole tensor (``t`` when
        ``dim`` is None)."""
        if dim is None:
            return t
        size = t.shape[dim] // self.mesh.fsdp
        return t.narrow(dim, self.mesh.fsdp_rank * size, size)

    def gather_along(self, tensors: Sequence[torch.Tensor],
                     dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
        """The whole tensors of the blocks ``tensors`` split along ``dims``
        (a tensor whose dim is None as it is). Collective over ``fsdp``."""
        if not any(d is not None for d in dims):
            return list(tensors)
        split = [i for i, d in enumerate(dims) if d is not None]
        out = list(tensors)
        whole = all_gather_along([tensors[i] for i in split], [dims[i] for i in split],
                                 self.mesh.fsdp_group)
        for i, t in zip(split, whole):
            out[i] = t
        return out

    def gather(self, tensors: Optional[Sequence[torch.Tensor]] = None,
               dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """The whole parameters (detached; or the whole tensors of the
        parameter-shaped blocks ``tensors``, such as the EMA's). With
        ``dtype``, fp32 blocks are cast before the gather, which equals a
        cast after it. A whole leaf is returned as it is unless cast."""
        tensors = [p.detach() for p in self.params] if tensors is None else list(tensors)
        if dtype is not None:
            tensors = [t.to(dtype) if t.dtype == torch.float32 else t for t in tensors]
        return self.gather_along(tensors, self.dims)

    def gather_host(self, tensors: Sequence[torch.Tensor],
                    dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
        """``gather_along`` a bucket at a time, each whole tensor moved to
        the host before the next bucket is gathered: a checkpoint never
        holds a whole tree on the device. Whole leaves are returned as they
        are."""
        out = list(tensors)
        run: List[int] = []
        total = 0

        def flush():
            for i, t in zip(run, self.gather_along([tensors[i] for i in run],
                                                   [dims[i] for i in run])):
                out[i] = t.cpu()
            run.clear()

        for i, d in enumerate(dims):
            if d is None:
                continue
            n = tensors[i].numel() * self.mesh.fsdp
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
        ``fsdp`` 1, the gradient itself), cast to the accumulator's dtype."""
        if self.mesh.fsdp == 1:
            torch._foreach_add_(list(accs), [g.to(a.dtype) for g, a in zip(grads, accs)])
        else:
            reduce_scatter_add_(grads, self.dims, accs, self.mesh.fsdp_group)

    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One whole gradient tree summed over all ranks, as this rank's
        blocks (collective): all-reduced in place when nothing is split."""
        grads = list(grads)
        if self.sharded:
            blocks = self.zeros(None)
            self.scatter_add_(grads, blocks)
            grads = blocks
        self.sum_over_data_(grads)
        return grads

    def sum_over_data_(self, tensors: Sequence[torch.Tensor]) -> None:
        """All-reduce (SUM) block-sized tensors in place over ``data``."""
        if self.mesh.data > 1:
            all_reduce_(tensors, group=self.mesh.data_group)

    def sum_leaves(self, values: torch.Tensor) -> torch.Tensor:
        """``values[..., i]``, a per-leaf value of this rank's leaf i (a
        block's part of it for a split leaf, the whole value for a whole
        one), summed over the leaves of the whole tree: the split leaves'
        part over the ``fsdp`` ranks (one all-reduce), each whole leaf
        once."""
        if not self.sharded:
            return values.sum(-1)
        split = self._split.to(values.device)
        return (all_reduce_sum(values[..., split].sum(-1), self.mesh.fsdp_group)
                + values[..., ~split].sum(-1))

    # -- whole models and state dicts -------------------------------------

    def full_copy(self) -> torch.nn.Module:
        """A copy of the model holding whole (uninitialised) parameters,
        with no gradients, for ``load_full``."""
        model = copy.deepcopy(self.model).requires_grad_(False)
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
        for name, dim in zip(self.names, self.dims):
            if name in blocks:
                blocks[name] = self.take(blocks[name], dim)
        self.model.load_state_dict(blocks)


def shard_module(model: torch.nn.Module, mesh: Optional[RankMesh] = None,
                 min_size: int = FSDP_MIN_SIZE) -> Sharding:
    """Split ``model``'s parameters over ``mesh``'s ``fsdp`` ranks (the
    world's data axis by default: nothing split): each parameter that
    ``fsdp_dim`` splits becomes this rank's block of it, in the
    parameter's memory format, and the whole storage is released. Load
    whole weights before; afterwards, through the ``Sharding``."""
    mesh = mesh or world_mesh()
    params = list(model.parameters())
    dims = [fsdp_dim(p.shape, mesh.fsdp, min_size) for p in params]
    shapes = [p.shape for p in params]
    sharding = Sharding(model, mesh, dims, shapes)
    with torch.no_grad():
        for p, dim in zip(params, dims):
            if dim is not None:
                view = sharding.take(p.detach(), dim)
                block = torch.empty(view.shape, dtype=p.dtype, device=p.device,
                                    memory_format=_memory_format(p))
                p.data = block.copy_(view)
    return sharding
