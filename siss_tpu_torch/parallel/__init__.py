"""Data, fully sharded data and tensor parallelism over
``torch.distributed``: port of the ``data``, ``fsdp`` and ``tensor`` axes of
``siss_tpu/parallel/``, alone or together (``data × fsdp × tensor``)."""

from siss_tpu_torch.parallel.distributed import (
    RankMesh,
    barrier,
    broadcast_object,
    destroy_distributed,
    initialize_distributed,
    is_initialized,
    is_main,
    make_rank_mesh,
    maybe_initialize_distributed,
    rank,
    world_size,
)
from siss_tpu_torch.parallel.fsdp import Layout, Sharding, shard_module, world_mesh
from siss_tpu_torch.parallel.mesh import MeshConfig, fsdp_dim, param_dims, resolve_mesh, tp_dim
from siss_tpu_torch.parallel.multihost import (
    all_gather_along,
    all_reduce_,
    all_reduce_mean,
    all_reduce_sum,
    any_rank,
    gather_rows,
    make_rank_sampler,
    process_batch_slice,
    rank_rows,
    reduce_scatter_add_,
)

__all__ = [
    "Layout",
    "MeshConfig",
    "RankMesh",
    "Sharding",
    "all_gather_along",
    "all_reduce_",
    "all_reduce_mean",
    "all_reduce_sum",
    "any_rank",
    "barrier",
    "broadcast_object",
    "destroy_distributed",
    "fsdp_dim",
    "gather_rows",
    "initialize_distributed",
    "is_initialized",
    "is_main",
    "make_rank_mesh",
    "make_rank_sampler",
    "maybe_initialize_distributed",
    "param_dims",
    "process_batch_slice",
    "rank",
    "rank_rows",
    "reduce_scatter_add_",
    "resolve_mesh",
    "shard_module",
    "tp_dim",
    "world_mesh",
    "world_size",
]
