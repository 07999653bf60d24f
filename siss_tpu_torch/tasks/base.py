"""Task base class and shared wiring: port of ``siss_tpu/tasks/base.py``.

A task runs on the ``device`` it is given (``"cuda"`` unless the caller asks
for the CPU): under a process group, its rank's device. The config's
``mesh`` resolves over the ranks (``data: -1`` is all of them) into
``self.mesh`` with its process groups. The UNet tasks split their UNet
over the ``fsdp`` and the ``tensor`` axes (``parallel.shard_module``) after
loading its weights, as the JAX tasks call ``shard_params_fsdp``. Under
several ranks the batch is split over the ``data × fsdp`` ranks (the ranks
of a tensor group hold the same rows), the tracker writes on rank 0 only, every rank
gathers a checkpoint and rank 0 writes it, and the preemption stop is
agreed by all ranks before any saves. Precision: ``compute_dtype: float32`` runs
the model in full float32, so both TF32 switches are set off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``); ``bfloat16`` autocasts the model's
body over float32 params.
"""

from __future__ import annotations

import abc
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
from siss_tpu_torch.parallel import MeshConfig, any_rank, is_main, make_rank_mesh
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
        #: This rank's place in the data × fsdp × tensor mesh.
        self.mesh = make_rank_mesh(MeshConfig.from_cfg(cfg.get("mesh")))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._eval_model = None
        #: Per-step seconds (host clock after a device synchronise) and
        #: seconds per evaluation, for the caller that measures the run.
        self.step_seconds: List[float] = []
        self.eval_seconds: List[float] = []

    @abc.abstractmethod
    def run(self) -> None:
        ...

    def should_stop(self, guard) -> bool:
        """The preemption guard's stop, agreed by every rank (one MAX
        all-reduce): a signal to one rank stops all of them at the same
        step, so they save together."""
        return any_rank(guard.should_stop, self.device)

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
                       logger=str(logging_cfg.get("logger", "jsonl")), config=to_dict(self.cfg),
                       main_process=is_main())

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
        """The model to sample from, whole on every rank: the EMA weights
        when the state keeps them, else the model's, in a copy of the model
        refreshed (gathered, when split over ``fsdp`` or ``tensor`` or
        both) on each call; the model itself when it is whole and has no
        EMA. Collective."""
        sharding = state.sharding
        if state.ema is None and not sharding.sharded:
            return state.model
        if self._eval_model is None:
            self._eval_model = sharding.full_copy()
        return sharding.load_full(self._eval_model,
                                  None if state.ema is None else state.ema.params)

    @staticmethod
    def bundle(state: TrainState, generator: torch.Generator) -> dict:
        """A checkpoint bundle: the resumable ``state`` (with the step's
        generator), and the ``unet`` and ``unet_ema`` weights, whole in the
        one-process format. Collective: every rank builds it."""
        sd = state.state_dict()
        return {"state": {**sd, "generator": generator.get_state()}, "unet": sd["model"],
                "unet_ema": None if sd["ema"] is None else sd["ema"]["params"]}

    @staticmethod
    def restore(state: TrainState, generator: torch.Generator, sd: dict) -> None:
        state.load_state_dict(sd)
        generator.set_state(sd["generator"])
