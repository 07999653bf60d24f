"""Data parallelism over ``torch.distributed``: port of the ``data`` axis of
``siss_tpu/parallel/``. The ``fsdp`` and ``tensor`` axes are not ported
(``mesh.resolve_mesh`` raises for them)."""

from siss_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_object,
    destroy_distributed,
    initialize_distributed,
    is_initialized,
    is_main,
    maybe_initialize_distributed,
    rank,
    world_size,
)
from siss_tpu_torch.parallel.mesh import MeshConfig, resolve_mesh
from siss_tpu_torch.parallel.multihost import (
    all_reduce_,
    all_reduce_mean,
    any_rank,
    gather_rows,
    make_rank_sampler,
    process_batch_slice,
    rank_rows,
)

__all__ = [
    "MeshConfig",
    "all_reduce_",
    "all_reduce_mean",
    "any_rank",
    "barrier",
    "broadcast_object",
    "destroy_distributed",
    "gather_rows",
    "initialize_distributed",
    "is_initialized",
    "is_main",
    "make_rank_sampler",
    "maybe_initialize_distributed",
    "process_batch_slice",
    "rank",
    "rank_rows",
    "resolve_mesh",
    "world_size",
]
