"""Hydra-style config reader: port of ``siss_tpu/config/core.py``.

The port reads the same ``configs/*.yaml`` as the JAX package, with the same
subset of Hydra/OmegaConf semantics:

* YAML files resolved by name from a config directory
* defaults-list inheritance with ``_self_`` ordering
* ``${a.b}`` / ``${a.b[0]}`` interpolation, also inside strings
* dotted overrides ``a.b=value`` (``+a.b=value`` adds a new key)
* ``_target_`` instantiation and ``get_object`` import by dotted path
* attribute-style access and runtime mutation

Every ``_target_`` in ``configs/`` names a ``siss_tpu.…`` object.
``get_object`` maps that prefix to ``siss_tpu_torch.`` and never imports the
JAX package.
"""

from __future__ import annotations

import functools
import importlib
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_JAX_PACKAGE = "siss_tpu"
_PORT_PACKAGE = "siss_tpu_torch"


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with a fixed float resolver: PyYAML's YAML-1.1 regex
    rejects '1e-4' (no dot), which the configs use."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_YamlLoader)


class Config:
    """Attribute-accessible, mutable config node (dict-backed)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = _wrap(v)

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        self._data[key] = _wrap(value)

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def get(self, key, default=None):
        return self._data.get(key, default)

    def setdefault(self, key, default=None):
        if key not in self._data:
            self._data[key] = _wrap(default)
        return self._data[key]

    def __len__(self):
        return len(self._data)

    def __getattr__(self, key):
        if key.startswith("__") or key == "_data":
            raise AttributeError(key)  # keep pickling/copy probes sane
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key, value):
        self._data[key] = _wrap(value)

    def __repr__(self):
        return f"Config({self._data!r})"

    def __eq__(self, other):
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return to_dict(self) == other
        return NotImplemented


def _wrap(v):
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, Config):
        return v
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


def to_dict(node) -> Any:
    if isinstance(node, Config):
        return {k: to_dict(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_dict(v) for v in node]
    return node


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _select(root: Dict[str, Any], path: str) -> Any:
    """Resolve 'a.b[0].c' against the raw dict tree."""
    cur: Any = root
    for part in re.split(r"\.", path.strip()):
        m = re.match(r"^([^\[\]]+)((\[\d+\])*)$", part)
        if not m:
            raise KeyError(f"Bad interpolation path: {path!r}")
        key, idxs = m.group(1), m.group(2)
        cur = cur[key]
        for idx in re.findall(r"\[(\d+)\]", idxs):
            cur = cur[int(idx)]
    return cur


def _resolve(node: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 20:
        raise RecursionError("Interpolation cycle detected")
    if isinstance(node, dict):
        return {k: _resolve(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root, depth) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.fullmatch(node)
        if full:
            return _resolve(_select(root, full.group(1)), root, depth + 1)

        def sub(m):
            return str(_resolve(_select(root, m.group(1)), root, depth + 1))

        return _INTERP_RE.sub(sub, node)
    return node


def _parse_override_value(raw: str) -> Any:
    return _yaml_load(raw) if raw != "" else None


def _apply_override(tree: Dict[str, Any], dotted: str, value: Any, allow_new: bool):
    parts = dotted.split(".")
    cur = tree
    for p in parts[:-1]:
        if p in cur and not isinstance(cur[p], dict):
            raise KeyError(f"Override path {dotted!r}: {p!r} holds a value, not a section")
        if p not in cur:
            if not allow_new:
                raise KeyError(f"Override path {dotted!r}: unknown key {p!r} (prefix with + to add)")
            cur[p] = {}
        cur = cur[p]
    last = parts[-1]
    if not allow_new and last not in cur:
        raise KeyError(f"Override {dotted!r}: unknown key {last!r} (prefix with + to add)")
    cur[last] = value


def _load_raw(name: str, config_dir: str, _stack=()) -> Dict[str, Any]:
    if name in _stack:
        raise ValueError(f"defaults cycle: {' -> '.join(_stack + (name,))}")
    with open(os.path.join(config_dir, f"{name}.yaml")) as f:
        data = _yaml_load(f.read()) or {}
    defaults: List[Any] = data.pop("defaults", None) or []
    merged: Dict[str, Any] = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, data)
            self_seen = True
        else:
            merged = _deep_merge(merged, _load_raw(str(entry), config_dir, _stack + (name,)))
    if not self_seen:
        merged = _deep_merge(merged, data)
    return merged


def load_config(config_name: str, overrides: Optional[List[str]] = None,
                config_dir: Optional[str] = None) -> Config:
    """Load ``<config_dir>/<config_name>.yaml`` with defaults-list merging,
    apply CLI-style overrides, resolve interpolations."""
    config_dir = config_dir or os.path.join(os.path.dirname(__file__), "..", "..", "configs")
    tree = _load_raw(config_name, config_dir)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value: {ov!r}")
        key, raw = ov.split("=", 1)
        allow_new = key.startswith("+")
        _apply_override(tree, key.lstrip("+"), _parse_override_value(raw), allow_new)
    return Config(_resolve(tree, tree))


def port_path(path: str) -> str:
    """A ``siss_tpu.…`` dotted path as the port's ``siss_tpu_torch.…`` path;
    any other path unchanged."""
    head, _, rest = path.partition(".")
    return f"{_PORT_PACKAGE}.{rest}" if head == _JAX_PACKAGE and rest else path


def get_object(path: str) -> Any:
    """Import ``pkg.mod.attr`` (hydra.utils.get_object), with ``siss_tpu.``
    read as ``siss_tpu_torch.``."""
    path = port_path(path)
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"Not a dotted path: {path!r}")
    try:
        return getattr(importlib.import_module(module_path), attr)
    except (ImportError, AttributeError) as first_err:
        # the path may point at a nested attribute: pkg.mod.Class.method
        try:
            return getattr(get_object(module_path), attr)
        except (ImportError, AttributeError):
            raise first_err  # surface the real import failure, not the fallback's


def instantiate(node: Any, _recursive_: bool = False, **kwargs) -> Any:
    """Instantiate a ``_target_`` node (hydra.utils.instantiate subset).
    Non-recursive by default: nested ``_target_`` nodes reach the object as
    Config for it to instantiate itself."""
    if isinstance(node, Config):
        node = to_dict(node)
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"instantiate() needs a dict with _target_, got {node!r}")
    node = dict(node)
    target = node.pop("_target_")
    node.pop("_type", None)
    if node.pop("_partial_", False):
        return functools.partial(get_object(target), **{**node, **kwargs})
    if _recursive_:
        node = {k: instantiate(v, _recursive_=True) if isinstance(v, dict) and "_target_" in v else v
                for k, v in node.items()}
    merged = {**node, **kwargs}
    # Plain dicts become Config so targets get attribute-style access.
    merged = {k: Config(v) if isinstance(v, dict) else v for k, v in merged.items()}
    return get_object(target)(**merged)
