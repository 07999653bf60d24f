"""Experiment tracking: port of ``siss_tpu/utils/tracker.py``.

The same key schema and files as the JAX package: a JSONL stream
(``metrics.jsonl``, line-series panels included), ``config.json``,
``summary.json`` and PNG image panels under ``images/``, plus wandb when
it is installed and asked for. The PNGs are written with the standard
library (zlib), so no imaging package is needed.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

_PNG_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → grey, grey+alpha, RGB, RGBA


def _to_scalar(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    return arr.item() if arr.size == 1 else arr.tolist()


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C in 1–4) image as an 8-bit PNG."""
    arr = np.ascontiguousarray(image, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _PNG_COLOR_TYPES:
        raise ValueError(f"PNG images have 1-4 channels, got {c}")
    # each scanline starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class Tracker:
    def __init__(self, project_name: str, output_dir: str, logger: str = "jsonl",
                 config: Optional[Dict[str, Any]] = None, main_process: bool = True):
        self.project_name = project_name
        self.output_dir = output_dir
        self.main_process = main_process
        self.summary: Dict[str, Any] = {}
        self._wandb = None
        self._jsonl = None
        if not main_process:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        if logger == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project=project_name, dir=output_dir, config=config or {})
            except Exception:  # offline environments fall back to the jsonl stream
                self._wandb = None
        if config is not None:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if not self.main_process:
            return
        record = {k: _to_scalar(v) for k, v in metrics.items()}
        record["_step"] = step
        record["_time"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def log_images(self, name: str, images: np.ndarray, step: Optional[int] = None):
        """images: [N, H, W, C] float in [0, 1], or one grid [H, W, C]."""
        if not self.main_process:
            return
        safe = name.replace("/", "_").replace(" ", "_")
        img_dir = os.path.join(self.output_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        paths = []
        for i, im in enumerate(arr):
            p = os.path.join(img_dir, f"{safe}_step{step}_{i}.png")
            write_png(p, (np.clip(im, 0, 1) * 255).astype(np.uint8))
            paths.append(p)
        self.log({f"{name}/files": paths}, step=step)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: [wandb.Image(p) for p in paths]}, step=step)

    def log_line_series(self, name: str, xs, ys, keys=None, title: str = "",
                        xname: str = "x", step: Optional[int] = None):
        """A wandb ``plot.line_series`` panel (the SD task's per-timestep
        noise-norm curves), always written to the JSONL stream too."""
        if not self.main_process:
            return
        record = {
            "_panel": "line_series", "_name": name, "_title": title,
            "_xname": xname, "xs": [_to_scalar(x) for x in xs],
            "ys": [[_to_scalar(y) for y in series] for series in ys],
            "keys": list(keys) if keys is not None else None,
            "_step": step, "_time": time.time(),
        }
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            import wandb

            self._wandb.log(
                {name: wandb.plot.line_series(xs=list(xs), ys=[list(s) for s in ys],
                                              keys=keys, title=title, xname=xname)},
                step=step)

    def log_summary(self, key: str, value: Any):
        """wandb ``run.summary`` equivalent."""
        if not self.main_process:
            return
        self.summary[key] = _to_scalar(value)
        with open(os.path.join(self.output_dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=2)
        if self._wandb is not None:
            self._wandb.summary[key] = value

    def finish(self):
        if not self.main_process:
            return
        if self._jsonl:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
