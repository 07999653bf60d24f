"""Process groups for data parallelism: counterpart of
``siss_tpu/parallel/distributed.py``.

The reference launches with ``accelerate launch`` over NCCL process groups
with a 7200 s timeout (``delete_celeb.py:99-101``). The port is launched by
``python3 -m torch.distributed.run --nproc_per_node N -m siss_tpu_torch.main
...``, which sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT``; ``maybe_initialize_distributed`` reads them. One rank
drives one device. Every helper here is correct without a process group
(one process: rank 0 of 1).

``make_rank_mesh`` lays the ranks out as the resolved ``data × fsdp ×
tensor`` mesh, data-outermost and tensor-innermost as the JAX ``make_mesh``
reshapes its devices to (data, fsdp, tensor): rank r is at ``data``
coordinate r // (fsdp·tensor), ``fsdp`` coordinate (r // tensor) % fsdp and
``tensor`` coordinate r % tensor. An axis's group holds the ranks that
differ only along it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.parallel.mesh import MeshConfig, resolve_mesh

#: Seconds a collective waits for the other ranks before it fails: a rank
#: that dies then fails the others instead of hanging them. Rank 0 writing a
#: checkpoint while the others wait at the barrier is the longest wait.
DEFAULT_TIMEOUT_S = 1800


def _rank_device(device) -> torch.device:
    """``device`` with ``cuda`` read as ``cuda:LOCAL_RANK``, made current."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def initialize_distributed(device, backend: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None, init_method: str = "env://",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Initialise the default process group and return this rank's device.

    ``device`` ``"cuda"`` means ``cuda:LOCAL_RANK``; ``"cuda:N"`` is taken as
    named (several ranks may name one card, which only gloo allows). The
    backend is ``nccl`` for CUDA and ``gloo`` for the CPU unless named; a
    backend that fails raises, it is never swapped for another. ``rank`` and
    ``world_size`` default to ``RANK`` and ``WORLD_SIZE``."""
    dev = _rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=dev if backend == "nccl" else None)
    return dev


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """``initialize_distributed`` when ``WORLD_SIZE`` > 1 (a launch by
    ``torch.distributed.run`` with several ranks) and no group exists yet,
    else just the device. Returns this rank's device."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return resolve_device(device)
    if is_initialized():
        return _rank_device(device)
    return initialize_distributed(device, backend, timeout_s=timeout_s)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def collective_device(device: torch.device) -> torch.device:
    """Where a small host-side value goes for a collective: the card under
    NCCL (which takes only CUDA tensors), else the CPU."""
    return device if is_initialized() and dist.get_backend() == "nccl" else torch.device("cpu")


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (pickled); ``obj`` itself without a
    group."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's place in the ``data × fsdp × tensor`` mesh. Each axis's
    group holds the ranks that differ from this one only along that axis,
    ``plane_group`` those that differ only along ``fsdp`` and ``tensor``;
    None is the whole world. An axis of size 1 has no collective."""

    data: int = 1
    fsdp: int = 1
    data_group: Any = None
    fsdp_group: Any = None
    tensor: int = 1
    tensor_group: Any = None
    plane_group: Any = None

    @property
    def tensor_rank(self) -> int:
        """This rank's coordinate on the ``tensor`` axis: which block of
        each tensor-split parameter it holds."""
        return rank() % self.tensor

    @property
    def fsdp_rank(self) -> int:
        """This rank's coordinate on the ``fsdp`` axis: which shard it holds."""
        return rank() // self.tensor % self.fsdp

    @property
    def batch_ranks(self) -> int:
        """The ranks over which the batch is split: ``data × fsdp``."""
        return self.data * self.fsdp

    @property
    def batch_rank(self) -> int:
        """This rank's block of the batch: its ``data × fsdp`` coordinate.
        The ranks of a tensor group share it."""
        return rank() // self.tensor

    def __str__(self) -> str:
        out = f"data {self.data} x fsdp {self.fsdp}"
        return out + (f" x tensor {self.tensor}" if self.tensor > 1 else "")


#: The subgroups of each mesh built in this world: ``new_group`` is
#: collective, so a world builds each once, every rank in the same order.
_GROUPS: Dict[Tuple[int, int, int], Tuple[Any, Any, Any, Any]] = {}


def _group_along(sizes: Tuple[int, ...], strides: Tuple[int, ...]) -> Any:
    """This rank's group of the ranks that differ from it only along the
    axes of ``sizes`` (of ``strides`` in the rank): None where they span the
    world or are this rank alone, else a new group. Every rank creates every
    such group, in the same order."""
    world, me = world_size(), rank()
    if math.prod(sizes) in (1, world):
        return None
    offsets = sorted(sum(c * st for c, st in zip(coords, strides))
                     for coords in itertools.product(*map(range, sizes)))

    def start(r):
        return r - sum(r // st % n * st for n, st in zip(sizes, strides))

    mine = None
    for first in sorted({start(r) for r in range(world)}):
        members = [first + o for o in offsets]
        group = dist.new_group(members)
        if me in members:
            mine = group
    return mine


def _axis_groups(sizes: Tuple[int, int, int]) -> Tuple[Any, Any, Any, Any]:
    """This rank's group along each axis of a (data, fsdp, tensor) mesh of
    ``sizes``, then of the fsdp × tensor plane (``RankMesh``)."""
    _, fsdp, tensor = sizes
    axes = [_group_along((n,), (stride,)) for n, stride in zip(sizes, (fsdp * tensor, tensor, 1))]
    return (*axes, _group_along((fsdp, tensor), (tensor, 1)))


def make_rank_mesh(cfg: MeshConfig = MeshConfig()) -> RankMesh:
    """``cfg`` resolved over the ranks (``resolve_mesh``), with this rank's
    groups. Collective on every rank when two axes are above 1 and the
    world has not built that mesh's groups yet."""
    mesh = resolve_mesh(cfg, world_size())
    key = (mesh.data, mesh.fsdp, mesh.tensor)
    if key not in _GROUPS:
        _GROUPS[key] = _axis_groups(key)
    data_group, fsdp_group, tensor_group, plane_group = _GROUPS[key]
    return RankMesh(mesh.data, mesh.fsdp, data_group, fsdp_group, mesh.tensor, tensor_group,
                    plane_group)


def destroy_distributed() -> None:
    if is_initialized():
        _GROUPS.clear()
        dist.destroy_process_group()
