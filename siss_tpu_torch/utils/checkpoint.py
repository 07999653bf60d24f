"""Checkpoint save/restore with rotation and a latest scan: port of
``siss_tpu/utils/checkpoint.py``.

The layout is the JAX package's: ``<root>/checkpoint-<step>/<item>/`` for
each named item of a bundle (``state``, ``unet``, ``unet_ema``), written to
``checkpoint-<step>.tmp`` and renamed when complete, so an interrupted save
never leaves a bundle that ``latest()`` would pick. Each item is one
``torch.save`` file, ``<item>/item.pt``, of plain containers of CPU tensors
(state dicts), and loads back with ``weights_only=True``.

Under a process group every rank builds the bundle (``TrainState.state_dict``
gathers the blocks of a state split over ``fsdp``: a gather on rank 0 alone
would wait forever for the others), calls ``save_bundle`` and ``wait``; rank
0 writes and the others wait for it at a barrier. The bundle has the
one-process format whatever the mesh. Every rank restores: it reads the
whole file and keeps its blocks (``TrainState.load_state_dict``).
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import torch

from siss_tpu_torch.parallel.distributed import barrier, is_main

ITEM_FILE = "item.pt"


def to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


#: The state-dict file names a diffusers or transformers model folder holds.
WEIGHT_FILES = ("diffusion_pytorch_model.bin", "pytorch_model.bin",
                "diffusion_pytorch_model.safetensors", "model.safetensors")


def weights_file(directory: str) -> Optional[str]:
    """The first of ``WEIGHT_FILES`` in ``directory``, or None."""
    for name in WEIGHT_FILES:
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            return path
    return None


def read_state_dict(path: str) -> dict:
    """A state dict saved with ``torch.save`` (``.bin``, ``.pt``, ``.pth``),
    loaded with ``weights_only=True``, or a ``.safetensors`` file when the
    safetensors package is installed (else an ImportError naming it)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading .safetensors weights needs the safetensors "
                              "package, which is not installed; save the state dict with "
                              "torch.save (.pth/.pt/.bin) instead") from e
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_weights(directory: str) -> Optional[dict]:
    """The state dict in ``directory``: a bundle item's ``item.pt``, else
    the first of ``WEIGHT_FILES``; None if it holds neither."""
    item = os.path.join(directory, ITEM_FILE)
    found = item if os.path.isfile(item) else weights_file(directory)
    return None if found is None else read_state_dict(found)


def load_frozen(make, weights, device="cpu") -> torch.nn.Module:
    """The module ``make()`` builds, built on the meta device (no random
    initialisation runs) and given ``weights``: a directory
    (``read_weights``), or a function of the module that returns its state
    dict. Frozen and in eval mode on ``device``."""
    with torch.device("meta"):
        model = make()
    if callable(weights):
        sd = weights(model)
    else:
        sd = read_weights(weights)
        if sd is None:
            raise FileNotFoundError(f"no state dict under {weights} (one of "
                                    f"{(ITEM_FILE, *WEIGHT_FILES)})")
    model = model.to_empty(device="cpu")
    model.load_state_dict(sd)
    return model.to(device).requires_grad_(False).eval()


class CheckpointManager:
    """``async_save=True`` moves the disk write (and rotation) to one
    background thread; the device-to-host copy stays in ``save_bundle``, so
    the train loop may update its tensors right after. ``wait()`` drains the
    pending writes and re-raises the first write error."""

    def __init__(self, output_dir: str, total_limit: Optional[int] = None,
                 async_save: bool = False):
        self.root = os.path.abspath(output_dir)
        self.total_limit = total_limit
        os.makedirs(self.root, exist_ok=True)
        self.async_save = async_save
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _submit(self, job) -> None:
        if self._worker is None:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True, name="ckpt-writer")
            self._worker.start()
        self._queue.put(job)

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                job()
            except Exception as e:  # surfaced by the next wait()
                self._error = e
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        if self._queue is not None:
            self._queue.join()
        barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint-{step}")

    def list_checkpoints(self):
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"checkpoint-(\d+)", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def latest(self) -> Optional[str]:
        cps = self.list_checkpoints()
        return cps[-1][1] if cps else None

    def save_bundle(self, step: int, items: dict) -> str:
        """Save the named items (``None`` ones are skipped) under one
        ``checkpoint-<step>/``: on rank 0, the others waiting at a barrier
        until it has written (or, with ``async_save``, queued) them."""
        path = self._path(step)
        if is_main():
            items = {k: to_host(v) for k, v in items.items() if v is not None}
            if self.async_save:
                self._submit(lambda: self._write_bundle(path, items))
            else:
                self._write_bundle(path, items)
        barrier()
        return path

    def _write_bundle(self, path: str, items: dict) -> None:
        tmp = path + ".tmp"
        for stale in (path, tmp):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        for name, item in items.items():
            os.makedirs(os.path.join(tmp, name))
            torch.save(item, os.path.join(tmp, name, ITEM_FILE))
        os.rename(tmp, path)
        self._rotate()

    def _resolve(self, checkpoint_path: str) -> str:
        path = self.latest() if checkpoint_path == "latest" else checkpoint_path
        if path is None:
            raise FileNotFoundError(f"No checkpoints under {self.root}")
        if not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(self.root, path)
        return path

    def restore_item(self, checkpoint_path: str, name: str) -> Any:
        """One named item of a bundle, on the CPU; ``checkpoint_path`` may be
        'latest'."""
        path = os.path.join(self._resolve(checkpoint_path), name, ITEM_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def _rotate(self):
        """Keep the newest ``total_limit`` checkpoints."""
        if self.total_limit is None:
            return
        cps = self.list_checkpoints()
        for _, path in cps[:max(len(cps) - int(self.total_limit), 0)]:
            shutil.rmtree(path, ignore_errors=True)
