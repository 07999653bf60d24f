"""How the ranks are laid out: counterpart of ``siss_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a (data, fsdp, tensor) mesh,
data-outermost. The port has one device per rank and ports the ``data``
and ``fsdp`` axes: global rank r sits at ``data`` coordinate r // fsdp and
``fsdp`` coordinate r % fsdp, the batch is split over all ranks (as
``batch_sharding`` splits it over ``("data", "fsdp")``), and each large
parameter is split over the ``fsdp`` ranks along the dimension that
``fsdp_dim`` picks (``parallel.fsdp``). ``tensor`` (the model split
Megatron-style) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

#: Tensors with fewer elements stay whole on every rank (JAX's ``min_size``).
FSDP_MIN_SIZE = 2 ** 16


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """``data`` is the data-parallel axis (-1: all remaining ranks);
    ``fsdp`` and ``tensor`` as in the JAX package."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        model = self.fsdp * self.tensor
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{self.fsdp}x{self.tensor} != {n_devices} devices")
        return MeshConfig(data=data, fsdp=self.fsdp, tensor=self.tensor)

    @classmethod
    def from_cfg(cls, node: Optional[Mapping[str, Any]]) -> "MeshConfig":
        """A config's ``mesh:`` node (None: all ranks on ``data``)."""
        node = node or {}
        return cls(data=int(node.get("data", -1)), fsdp=int(node.get("fsdp", 1)),
                   tensor=int(node.get("tensor", 1)))


def resolve_mesh(cfg: MeshConfig, world_size: int) -> MeshConfig:
    """``cfg`` resolved over ``world_size`` ranks, one device each. A
    ``tensor`` axis above 1 raises ``NotImplementedError`` first. Unlike the
    JAX ``make_mesh``, an explicit ``data`` that leaves ranks over raises
    (``resolve``) instead of leaving them idle."""
    if cfg.tensor > 1:
        raise NotImplementedError(
            f"mesh {cfg}: the tensor axis (the model split over ranks) is not ported yet "
            "(ROADMAP Queue 1 item 12c); use tensor: 1")
    return cfg.resolve(world_size)


def _flax_axes(ndim: int) -> Sequence[int]:
    """The torch dimension of each flax axis of a parameter: a conv kernel
    is flax HWIO and torch OIHW, a dense kernel flax [in, out] and torch
    [out, in]; any other rank keeps its order (``utils.convert``)."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def fsdp_dim(shape: Sequence[int], n: int, min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The torch dimension of a parameter of ``shape`` that an ``fsdp`` axis
    of ``n`` ranks splits, or None (replicated): JAX's ``_fsdp_spec``, read
    in the flax layout. A tensor under ``min_size`` elements stays whole;
    otherwise the last flax axis that ``n`` divides is split, so no shard
    is ever padded."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    if n <= 1 or numel < min_size:
        return None
    axes = _flax_axes(len(shape))
    for axis in reversed(range(len(shape))):
        dim = axes[axis]
        if shape[dim] % n == 0 and shape[dim] >= n:
            return dim
    return None
