"""The benchmark's manifest, ``BENCHMARK.json`` at the root of the checkout,
and the files it names. Everything of one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own, found by name:

- ``configs/<config>.json`` (the manifest's ``file``): sizes, types and
  settings, and ``family``, the module ``families/<family>.py`` that builds
  the port's model and names the reference forward beside it;
- ``traffic/<traffic>.json``: a traffic mix, whose ``kind`` names the
  loop that drives it, ``loops/<kind>.py``;
- ``metrics/<metric>.py``: one metric, end-to-end or per-layer, a
  ``read(ctx)`` that returns a number or None when the run holds nothing
  to read. A metric ``<base>.<rest>`` that has no file of its own is read
  by ``metrics/<base>.py``: one quantity split by the end-to-end metric it
  moves keeps one reader;
- ``limits/<cell>.json``: the limit of each number a cell's run compares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"BENCHMARK.json has no {what} named {name!r}")
    return found[0]


def cell(manifest: dict, name: str) -> dict:
    return _one(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _one(manifest["configs"], name, "config")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "portbench" / "limits" / f"{cell_name}.json").read_text())


def family(name: str):
    return importlib.import_module(f"portbench.families.{name}")


def _load(path: Path, package: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench.{package}._" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(kind: str, root: Path = ROOT):
    """The module ``loops/<kind>.py`` that drives traffic of ``kind``."""
    path = root / "portbench" / "loops" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no loop for traffic of kind {kind!r} ({path})")
    return _load(path, "loops")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``, or else of
    ``metrics/<base>.py`` for the part of ``name`` before its first dot."""
    folder = root / "portbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.is_file():
        path = folder / f"{name.split('.')[0]}.py"
    return _load(path, "metrics").read


def reported(manifest: dict, section: str, cell_name: str) -> list:
    """The metrics of ``manifest[section]`` that a cell reports: those that
    list it under ``workloads``; one without that key, where the cell
    reports its end-to-end metric (``moves``), or always if it has none."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])}
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in e2e:
            out.append(m)
    return out
