"""How the ranks are laid out: counterpart of ``siss_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a (data, fsdp, tensor) mesh. The
port has one device per rank and ports the ``data`` axis: the batch is
split over the ranks, the parameters and optimizer state are replicated,
and the step all-reduces its two gradient trees (``parallel.multihost``).
``fsdp`` (parameters and optimizer state sharded) and ``tensor`` (the
model split Megatron-style) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


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
    """``cfg`` resolved over ``world_size`` ranks, one device each. An
    ``fsdp`` or ``tensor`` axis above 1 raises ``NotImplementedError``
    first. Unlike the JAX ``make_mesh``, an explicit ``data`` that is not
    the world size raises (``resolve``) instead of leaving ranks idle."""
    if cfg.fsdp > 1:
        raise NotImplementedError(
            f"mesh {cfg}: the fsdp axis (parameters and optimizer state sharded) is not "
            "ported yet (ROADMAP Queue 1 item 12b); use fsdp: 1")
    if cfg.tensor > 1:
        raise NotImplementedError(
            f"mesh {cfg}: the tensor axis (the model split over ranks) is not ported yet "
            "(ROADMAP Queue 1 item 12c); use tensor: 1")
    return cfg.resolve(world_size)
