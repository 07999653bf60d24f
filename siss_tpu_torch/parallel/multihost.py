"""Per-rank data and the collectives of the data-parallel step: counterpart
of ``siss_tpu/parallel/multihost.py``.

The reference feeds per-rank DataLoaders under DDP, each rank's
``InfiniteSampler(rank, num_replicas)`` a disjoint stripe of one shuffled
index stream (``data/utils/infinite_sampler.py:5-13``). The JAX package
stitches the processes' slices into one global array, process r's slice at
rows ``[r·b, (r+1)·b)``; the port keeps the slices apart and says which rows
of the global batch a rank holds (``rank_rows``). Every rank draws the
global batch's randomness and keeps its rows, so a step on R ranks is the
one-process step on the global batch up to the order of its sums.

Every function here is correct without a process group (rank 0 of 1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from siss_tpu_torch.parallel.distributed import collective_device, is_initialized, rank, world_size

#: Elements of the flat buffer that ``all_reduce_`` packs small tensors
#: into: 64 MiB in fp32, so a whole gradient tree never needs a second copy.
BUCKET_NUMEL = 2 ** 24


def process_batch_slice(global_batch_size: int) -> int:
    """This rank's share of the global batch, which the ranks must divide."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def make_rank_sampler(sampler_cls, dataset_len: int, **kwargs):
    """A sampler striped for this rank (the reference's rank/num_replicas
    contract)."""
    return sampler_cls(dataset_len, rank=rank(), num_replicas=world_size(), **kwargs)


def rank_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of the global ``x`` along ``axis``: rows
    ``[r·b, (r+1)·b)`` with b = size / world size (a view)."""
    b = process_batch_slice(x.shape[axis])
    return x.narrow(axis, rank() * b, b)


def gather_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The global tensor whose ``rank_rows`` on each rank is that rank's
    ``x``, on every rank. An all-reduce (SUM) of a zero-filled global buffer
    into which each rank writes its rows: gloo has no all-gather of CUDA
    tensors, and this form works under both backends."""
    if not is_initialized():
        return x
    shape = list(x.shape)
    b = shape[axis]
    shape[axis] = b * world_size()
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(axis, rank() * b, b).copy_(x)
    dist.all_reduce(out)
    return out


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a dense tensor's elements in memory order (contiguous
    or channels_last): an elementwise reduction does not care about order."""
    if not (t.is_contiguous() or (t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError(f"all_reduce_ needs dense tensors, got strides {t.stride()}")
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


def all_reduce_(tensors: Sequence[torch.Tensor],
                bucket_numel: int = BUCKET_NUMEL) -> Sequence[torch.Tensor]:
    """All-reduce (SUM) every tensor in place, in its own dtype. Tensors below
    ``bucket_numel`` elements are packed, in order, into one flat buffer of
    that size and reduced a bucket at a time; larger ones are reduced
    alone. Without a process group it does nothing."""
    if not is_initialized():
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
        dist.all_reduce(buf)
        for p, chunk in zip(pending, buf.split([p.numel() for p in pending])):
            _flat(p).copy_(chunk)
        pending.clear()
        pending_numel = 0

    for t in tensors:
        if t.numel() >= bucket_numel:
            dist.all_reduce(_flat(t))
            continue
        if pending and (t.dtype != pending[0].dtype or t.device != pending[0].device
                        or pending_numel + t.numel() > bucket_numel):
            flush()
        pending.append(t)
        pending_numel += t.numel()
    flush()
    return tensors


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
