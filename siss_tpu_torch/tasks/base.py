"""Task base class and shared wiring: port of ``siss_tpu/tasks/base.py``.

A task runs on one device, the ``device`` it is given (``"cuda"`` unless the
caller asks for the CPU). The JAX package's device mesh is one device here:
a config asking for more raises. Precision: ``compute_dtype: float32`` runs
the model in full float32, so both TF32 switches are set off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``); ``bfloat16`` autocasts the model's
body over float32 params.
"""

from __future__ import annotations

import abc
import copy
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from siss_tpu_torch.config import Config, get_object, instantiate, to_dict
from siss_tpu_torch.data import make_synthetic_mnist_tshirt
from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.models import UNet2D, UNet2DConfig, build_unet
from siss_tpu_torch.train.state import TrainState
from siss_tpu_torch.utils import CheckpointManager, Tracker

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def boundary_crossed(prev_step: int, step: int, every) -> bool:
    """True when ``(prev_step, step]`` holds a multiple of ``every``: the
    step-frequency test that stays right when the loop advances
    ``steps_per_call`` steps at a time. A falsy ``every`` disables it; with
    ``prev_step = step − 1`` it is ``step % every == 0``."""
    if not every:
        return False
    every = int(every)
    return (step // every) > (prev_step // every)


class Task(abc.ABC):
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._check_mesh()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._ema_model = None
        #: Per-step seconds (host clock after a device synchronise) and
        #: seconds per evaluation, for the caller that measures the run.
        self.step_seconds: List[float] = []
        self.eval_seconds: List[float] = []

    @abc.abstractmethod
    def run(self) -> None:
        ...

    def _check_mesh(self) -> None:
        mcfg = self.cfg.get("mesh") or {}
        sizes = {axis: int(mcfg.get(axis, default)) for axis, default in
                 (("data", -1), ("fsdp", 1), ("tensor", 1))}
        if sizes["data"] not in (-1, 1) or sizes["fsdp"] > 1 or sizes["tensor"] > 1:
            raise NotImplementedError(
                f"mesh {sizes}: the port runs on one device; data, fsdp and tensor "
                "parallelism are not ported yet (ROADMAP Queue 1 item 12)")

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, seconds: List[float], fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its seconds appended to ``seconds``."""
        self.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    def make_tracker(self) -> Tracker:
        logging_cfg = self.cfg.get("logging") or Config({"logger": "jsonl"})
        return Tracker(project_name=str(self.cfg.project_name), output_dir=str(self.cfg.output_dir),
                       logger=str(logging_cfg.get("logger", "jsonl")), config=to_dict(self.cfg))

    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[str(self.cfg.get("compute_dtype", "float32"))]

    def build_unet(self) -> Tuple[UNet2D, UNet2DConfig]:
        """The UNet of ``cfg.unet`` (a UNet2DConfig target or a preset
        classmethod) on the task's device, random weights from
        ``random_seed``."""
        node = to_dict(self.cfg.unet)
        fn = get_object(node.pop("_target_", "siss_tpu.models.unet2d.UNet2DConfig"))
        for k in ("block_out_channels", "down_block_types", "up_block_types"):
            if isinstance(node.get(k), list):
                node[k] = tuple(node[k])
        ucfg = fn(**node)
        model = build_unet(ucfg, seed=int(self.cfg.random_seed), dtype=self.compute_dtype(),
                           device=self.device)
        return model, ucfg

    def build_schedule(self) -> NoiseSchedule:
        s = self.cfg.scheduler
        return NoiseSchedule.create(
            num_train_timesteps=int(s.get("num_train_timesteps", 1000)),
            beta_schedule=str(s.get("beta_schedule", "linear")),
            beta_start=float(s.get("beta_start", 1e-4)),
            beta_end=float(s.get("beta_end", 0.02)),
            prediction_type=str(s.get("prediction_type", "epsilon")),
            device=self.device)

    def build_dataset(self, node: Config):
        """Instantiate a dataset node; a missing MNIST-t-shirt ``.npz`` is
        synthesized first (offline environments)."""
        node_d = to_dict(node)
        if str(node_d.get("_target_", "")).endswith("LabeledImageDataset.from_npz"):
            path = node_d["path"]
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                images, labels = make_synthetic_mnist_tshirt(n_per_class=256)
                np.savez_compressed(path, images=images, labels=labels)
        return instantiate(node)

    def load_bundle_unet(self, model: torch.nn.Module, path: str) -> None:
        """Load ``model`` from a bundle, ``…/checkpoint-<n>`` or
        ``<run dir>/latest``: its ``subfolders.unet`` item (``unet`` when
        the config names none)."""
        path = path.rstrip("/")
        root, leaf = os.path.split(path)
        mgr = CheckpointManager(root if leaf == "latest" else os.path.dirname(path) or ".")
        subfolder = str((self.cfg.get("subfolders") or {}).get("unet") or "unet")
        model.load_state_dict(mgr.restore_item("latest" if leaf == "latest" else path, subfolder))

    def build_classifier(self):
        """The ``metrics.classifier_cfg`` classifier on the task's device:
        ``classifier_arch(**classifier_args)`` with the weights of
        ``classifier_ckpt``. Raises when it cannot be built."""
        from siss_tpu_torch.metrics import Classifier, load_classifier_state

        clf_cfg = self.cfg.metrics.classifier_cfg
        model = get_object(str(clf_cfg.classifier_arch))(
            **to_dict(clf_cfg.get("classifier_args") or {}))
        model.load_state_dict(load_classifier_state(str(clf_cfg.classifier_ckpt)))
        return Classifier(model.to(self.device))

    def to_device(self, batch: np.ndarray) -> torch.Tensor:
        """A host batch on the task's device (pinned, asynchronous copy)."""
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def eval_model(self, state: TrainState) -> torch.nn.Module:
        """The model to sample from: the EMA weights when the state keeps
        them (in a copy of the model refreshed on each call), else the
        model."""
        if state.ema is None:
            return state.model
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(state.model).requires_grad_(False)
        with torch.no_grad():
            for p, e in zip(self._ema_model.parameters(), state.ema.params):
                p.copy_(e)
        return self._ema_model

    @staticmethod
    def bundle(state: TrainState, generator: torch.Generator) -> dict:
        """A checkpoint bundle: the resumable ``state`` (with the step's
        generator), and the ``unet`` and ``unet_ema`` weights."""
        return {"state": {**state.state_dict(), "generator": generator.get_state()},
                "unet": state.model.state_dict(), "unet_ema": state.ema_state_dict()}

    @staticmethod
    def restore(state: TrainState, generator: torch.Generator, sd: dict) -> None:
        state.load_state_dict(sd)
        generator.set_state(sd["generator"])
