"""How the ranks are laid out: counterpart of ``siss_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a (data, fsdp, tensor) mesh,
data-outermost. The port has one device per rank: global rank r sits at
``data`` coordinate r // (fsdp·tensor), ``fsdp`` coordinate
(r // tensor) % fsdp and ``tensor`` coordinate r % tensor. The batch is
split over the ``data × fsdp`` ranks (as ``batch_sharding`` splits it over
``("data", "fsdp")``) and replicated over ``tensor``. Each large parameter
is split over the ``fsdp`` ranks along the dimension that ``fsdp_dim``
picks (``parallel.fsdp``); with a ``tensor`` axis, each parameter with a
Megatron role is split over the ``tensor`` ranks along the dimension that
``tp_dim`` picks (``parallel.tensor``). With both axes, a parameter with a
Megatron role is split over ``tensor`` first and then over ``fsdp`` along
another dimension (``param_dims``: JAX's ``_param_spec``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

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
    """``cfg`` resolved over ``world_size`` ranks, one device each. Unlike
    the JAX ``make_mesh``, an explicit ``data`` that leaves ranks over raises
    (``resolve``) instead of leaving them idle."""
    return cfg.resolve(world_size)


def _flax_axes(ndim: int) -> Sequence[int]:
    """The torch dimension of each flax axis of a parameter: a conv kernel
    is flax HWIO and torch OIHW, a dense kernel flax [in, out] and torch
    [out, in]; any other rank keeps its order (``utils.convert``)."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def fsdp_dim(shape: Sequence[int], n: int, min_size: int = FSDP_MIN_SIZE,
             taken: Optional[int] = None) -> Optional[int]:
    """The torch dimension of a parameter of ``shape`` that an ``fsdp`` axis
    of ``n`` ranks splits, or None (replicated): JAX's ``_fsdp_spec``, read
    in the flax layout. A tensor under ``min_size`` elements stays whole;
    otherwise the last flax axis that ``n`` divides is split, so no shard
    is ever padded. ``taken``: a torch dimension the tensor axis splits,
    which fsdp leaves alone."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    if n <= 1 or numel < min_size:
        return None
    axes = _flax_axes(len(shape))
    for axis in reversed(range(len(shape))):
        dim = axes[axis]
        if dim != taken and shape[dim] % n == 0 and shape[dim] >= n:
            return dim
    return None


#: The Megatron role of each parameter that the ``tensor`` axis splits, by
#: its module's last name: the torch dimension split for the weight and for
#: the bias (None: the bias stays whole). Column layers split their output,
#: row layers their input. JAX's ``_tp_spec`` in the torch layout.
_ATTENTION_ROLES = {"to_q": (0, None), "to_k": (0, None), "to_v": (0, None), "to_out": (1, None)}
_RESNET_ROLES = {"conv1": (0, 0), "time_emb_proj": (0, 0), "norm2": (0, 0), "conv2": (1, None)}


def _tp_role(names: Sequence[str]) -> Optional[int]:
    """The torch dimension that JAX's ``_tp_spec`` splits for the parameter
    at the state-dict path ``names``, or None (no role)."""
    names = tuple(str(n) for n in names)
    leaf = names[-1]
    # to_out.0 and ff.net.{0.proj,2} carry a list index in torch.
    module = names[-3] if len(names) >= 3 and names[-2].isdigit() else names[-2]
    if names[-5:-1] == ("ff", "net", "0", "proj"):   # GEGLU's projection
        return 0
    if names[-4:-1] == ("ff", "net", "2"):            # the feed-forward's output
        return 1 if leaf == "weight" else None
    if module in _ATTENTION_ROLES:
        return _ATTENTION_ROLES[module][0 if leaf == "weight" else 1]
    if len(names) >= 4 and names[-4] == "resnets" and names[-2] in _RESNET_ROLES:
        return _RESNET_ROLES[names[-2]][0 if leaf == "weight" else 1]
    return None


def tp_dim(names: Sequence[str], shape: Sequence[int], n: int) -> Optional[int]:
    """The torch dimension of the parameter at the state-dict path ``names``
    (``key.split(".")``) of ``shape`` that a ``tensor`` axis of ``n`` ranks
    splits, or None (whole on every tensor rank): JAX's ``_tp_spec`` with
    ``_param_spec``'s guard, read in the torch layout. The attention
    projections ``to_q``/``to_k``/``to_v``, GEGLU's projection and a
    resnet's ``conv1``, ``time_emb_proj`` and ``norm2`` split their output
    (dim 0); ``to_out``, the feed-forward's output projection and a resnet's
    ``conv2`` their input (dim 1). A role splits only where ``n`` divides
    the dimension; otherwise the parameter stays whole, as JAX falls back
    to ``_fsdp_spec``, replicated at fsdp 1."""
    if n <= 1:
        return None
    dim = _tp_role(names)
    if dim is None or dim >= len(shape) or int(shape[dim]) % n:
        return None
    return dim


def param_dims(names: Sequence[str], shape: Sequence[int], fsdp: int, tensor: int,
               min_size: int = FSDP_MIN_SIZE) -> Tuple[Optional[int], Optional[int]]:
    """(tensor dimension, fsdp dimension) of the parameter at the state-dict
    path ``names`` of whole ``shape`` on a mesh of ``fsdp`` × ``tensor``
    ranks, either None: JAX's ``_param_spec`` read in the torch layout. The
    Megatron role comes first (``tp_dim``); ``fsdp_dim`` then runs on the
    whole shape (``min_size`` on its whole element count, divisibility on
    its whole dimensions) with the role's dimension taken. A role that the
    tensor axis does not divide leaves plain ``fsdp_dim``."""
    tdim = tp_dim(names, shape, tensor)
    return tdim, fsdp_dim(shape, fsdp, min_size, taken=tdim)
