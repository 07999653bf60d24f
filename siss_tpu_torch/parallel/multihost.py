"""Per-rank data and the collectives of the data-parallel step: counterpart
of ``siss_tpu/parallel/multihost.py``.

The reference feeds per-rank DataLoaders under DDP, each rank's
``InfiniteSampler(rank, num_replicas)`` a disjoint stripe of one shuffled
index stream (``data/utils/infinite_sampler.py:5-13``). The JAX package
stitches the processes' slices into one global array, process r's slice at
rows ``[r·b, (r+1)·b)``; the port keeps the slices apart and says which rows
of the global batch a rank holds (``rank_rows``). Every rank draws the
global batch's randomness and keeps its rows, so a step on R ranks is the
one-process step on the global batch up to the order of its sums. Under a
``tensor`` axis the ranks of a tensor group hold the same rows: the batch
is split by the ``data × fsdp`` coordinate (``RankMesh.batch_rank``) of a
``mesh`` passed in, never by the tensor coordinate.

The ``fsdp`` axis adds an all-gather and a reduce-scatter (SUM) along one
dimension of each tensor within a group (``all_gather_along``,
``reduce_scatter_add_``) and the sum of a short vector of partial sums
(``all_reduce_sum``). Under NCCL they are ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; gloo has neither for CUDA tensors, so under gloo
they are one ``all_reduce`` of a zero-filled buffer of every rank's blocks,
as ``gather_rows`` is. The backend picks the form (``_native_collectives``);
a collective that fails raises.

Every function here is correct without a process group (rank 0 of 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from siss_tpu_torch.parallel.distributed import collective_device, is_initialized, rank, world_size

#: Elements of the flat buffer that ``all_reduce_`` packs small tensors
#: into: 64 MiB in fp32, so a whole gradient tree never needs a second copy.
BUCKET_NUMEL = 2 ** 24


def _batch_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's block of the batch, the number of blocks): the world's
    rank and size without a ``mesh``, else its ``data × fsdp`` coordinate:
    the ranks of a ``tensor`` group share one block."""
    if mesh is None:
        return rank(), world_size()
    return mesh.batch_rank, mesh.batch_ranks


def process_batch_slice(global_batch_size: int, mesh=None) -> int:
    """This rank's share of the global batch, which the batch ranks (every
    rank without a ``mesh``) must divide."""
    n = _batch_coordinate(mesh)[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def make_rank_sampler(sampler_cls, dataset_len: int, mesh=None, **kwargs):
    """A sampler striped for this rank's block of the batch (the
    reference's rank/num_replicas contract)."""
    me, n = _batch_coordinate(mesh)
    return sampler_cls(dataset_len, rank=me, num_replicas=n, **kwargs)


def rank_rows(x: torch.Tensor, axis: int = 0, mesh=None) -> torch.Tensor:
    """This rank's contiguous block of the global ``x`` along ``axis``: rows
    ``[r·b, (r+1)·b)`` with r the rank's batch coordinate and b = size /
    the batch ranks (a view)."""
    b = process_batch_slice(x.shape[axis], mesh)
    return x.narrow(axis, _batch_coordinate(mesh)[0] * b, b)


def gather_rows(x: torch.Tensor, axis: int = 0, mesh=None) -> torch.Tensor:
    """The global tensor whose ``rank_rows`` on each rank is that rank's
    ``x``, on every rank. An all-reduce (SUM) of a zero-filled global buffer
    into which each rank writes its rows (one rank of each ``tensor`` group,
    whose ranks hold the same rows): gloo has no all-gather of CUDA
    tensors, and this form works under both backends."""
    if not is_initialized():
        return x
    me, n = _batch_coordinate(mesh)
    shape = list(x.shape)
    b = shape[axis]
    shape[axis] = b * n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if mesh is None or mesh.tensor_rank == 0:
        out.narrow(axis, me * b, b).copy_(x)
    dist.all_reduce(out)
    return out


def _group_size(group) -> int:
    """The ranks of ``group`` (None: the world); 1 without a process group."""
    return dist.get_world_size(group) if is_initialized() else 1


def _native_collectives(group) -> bool:
    """Whether ``group``'s backend gathers and scatters along a dimension
    itself (``all_gather_into_tensor``, ``reduce_scatter_tensor``): NCCL.
    Otherwise both go through one ``all_reduce``."""
    return dist.get_backend(group) == "nccl"


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a dense tensor's elements in memory order (contiguous
    or channels_last): an elementwise reduction does not care about order."""
    if not (t.is_contiguous() or (t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError(f"all_reduce_ needs dense tensors, got strides {t.stride()}")
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


def all_reduce_(tensors: Sequence[torch.Tensor], bucket_numel: int = BUCKET_NUMEL,
                group=None) -> Sequence[torch.Tensor]:
    """All-reduce (SUM) every tensor in place over ``group`` (None: the
    world), in its own dtype. Tensors below ``bucket_numel`` elements are
    packed, in order, into one flat buffer of that size and reduced a bucket
    at a time; larger ones are reduced alone. Over one rank it does
    nothing."""
    if _group_size(group) == 1:
        return tensors
    buffers = {}
    pending: List[torch.Tensor] = []
    pending_numel = 0

    def flush():
        nonlocal pending_numel
        if not pending:
            return
        key = (pending[0].dtype, pending[0].device)
        if key not in buffers:
            buffers[key] = torch.empty(bucket_numel, dtype=key[0], device=key[1])
        buf = buffers[key][:pending_numel]
        torch.cat([_flat(p) for p in pending], out=buf)
        dist.all_reduce(buf, group=group)
        for p, chunk in zip(pending, buf.split([p.numel() for p in pending])):
            _flat(p).copy_(chunk)
        pending.clear()
        pending_numel = 0

    for t in tensors:
        if t.numel() >= bucket_numel:
            dist.all_reduce(_flat(t), group=group)
            continue
        if pending and (t.dtype != pending[0].dtype or t.device != pending[0].device
                        or pending_numel + t.numel() > bucket_numel):
            flush()
        pending.append(t)
        pending_numel += t.numel()
    flush()
    return tensors


def _buckets(tensors: Sequence[torch.Tensor], numel, bucket_numel: int):
    """Runs of consecutive indices of ``tensors`` with one dtype and device
    whose ``numel(i)`` add up to at most ``bucket_numel`` (a larger one
    alone)."""
    run: List[int] = []
    total = 0
    for i, t in enumerate(tensors):
        if run and (t.dtype != tensors[run[0]].dtype or t.device != tensors[run[0]].device
                    or total + numel(i) > bucket_numel):
            yield run
            run, total = [], 0
        run.append(i)
        total += numel(i)
    if run:
        yield run


def _like(chunk: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 1-D ``chunk`` of ``like.numel()`` elements viewed with the shape and
    strides of the dense (contiguous or channels_last) ``like``."""
    _flat(like)
    return chunk.as_strided(like.shape, like.stride())


def all_gather_along(shards: Sequence[torch.Tensor], dims: Sequence[int], group=None,
                     bucket_numel: int = BUCKET_NUMEL) -> List[torch.Tensor]:
    """The whole tensors of which each rank of ``group`` holds, in rank
    order, the equal blocks ``shards[i]`` along ``dims[i]``, on every rank
    (new tensors in the shards' memory format; the shards themselves over
    one rank). The shards travel in memory order, packed into buckets of at
    most ``bucket_numel`` gathered elements."""
    n_ranks = _group_size(group)
    if n_ranks == 1:
        return list(shards)
    me = dist.get_rank(group)
    nccl = _native_collectives(group)
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for run in _buckets(shards, lambda i: n_ranks * shards[i].numel(), bucket_numel):
        sizes = [shards[i].numel() for i in run]
        n = sum(sizes)
        local = torch.cat([_flat(shards[i]) for i in run])
        if nccl:
            buf = torch.empty(n_ranks * n, dtype=local.dtype, device=local.device)
            dist.all_gather_into_tensor(buf, local, group=group)
        else:
            buf = torch.zeros(n_ranks * n, dtype=local.dtype, device=local.device)
            buf[me * n:(me + 1) * n].copy_(local)
            dist.all_reduce(buf, group=group)
        blocks = buf.view(n_ranks, n)
        for i, chunks in zip(run, zip(*(b.split(sizes) for b in blocks))):
            out[i] = torch.cat([_like(c, shards[i]) for c in chunks], dim=dims[i])
    return out


def reduce_scatter_add_(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                        outs: Sequence[torch.Tensor], group=None,
                        bucket_numel: int = BUCKET_NUMEL) -> None:
    """Add to each dense ``outs[i]`` (in its own dtype) this rank's block of
    the sum over ``group`` of ``tensors[i]``: block r along ``dims[i]`` on
    rank r, or the whole sum where ``dims[i]`` is None. The sums run in the
    tensors' dtype; the blocks travel in the outs' memory order, packed into
    buckets of at most ``bucket_numel`` elements before the scatter. Over
    one rank it adds each tensor to its out."""
    n_ranks = _group_size(group)
    if n_ranks == 1:
        torch._foreach_add_(list(outs), [t.to(o.dtype) for t, o in zip(tensors, outs)])
        return
    me = dist.get_rank(group)
    nccl = _native_collectives(group)
    for run in _buckets(tensors, lambda i: n_ranks * outs[i].numel(), bucket_numel):
        sizes = [outs[i].numel() for i in run]
        n = sum(sizes)
        t0 = tensors[run[0]]
        buf = torch.empty(n_ranks, n, dtype=t0.dtype, device=t0.device)
        for r, block in enumerate(buf):
            for i, chunk in zip(run, block.split(sizes)):
                part = tensors[i]
                if dims[i] is not None:
                    size = outs[i].shape[dims[i]]
                    part = part.narrow(dims[i], r * size, size)
                _like(chunk, outs[i]).copy_(part)
        if nccl:
            mine = torch.empty(n, dtype=buf.dtype, device=buf.device)
            dist.reduce_scatter_tensor(mine, buf.view(-1), group=group)
        else:
            dist.all_reduce(buf, group=group)
            mine = buf[me]
        for i, chunk in zip(run, mine.split(sizes)):
            outs[i].add_(_like(chunk, outs[i]).to(outs[i].dtype))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A short tensor of partial sums summed over ``group`` (a new tensor;
    ``x`` itself over one rank)."""
    if _group_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a tensor each rank holds (detached)."""
    if not is_initialized():
        return x.detach()
    out = x.detach().clone()
    dist.all_reduce(out)
    return out / world_size()


def any_rank(flag: bool, device: torch.device) -> bool:
    """True on every rank when ``flag`` is true on any: one MAX all-reduce
    (the preemption stop that every rank must agree on before a save)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=collective_device(device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
