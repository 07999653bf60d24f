"""Metric-classifier training: port of ``siss_tpu/tasks/train_classifier.py``.

Trains the grayscale ResNet-18 digit classifier of the Inception Score on
the task's labelled set (``configs/train_classifier.yaml``: the repository's
MNIST + t-shirt npz, 11 classes) with AdamW (optax's defaults: betas 0.9 /
0.999, eps 1e-8, weight decay 1e-4) on images in [0, 1], and saves its state
dict as the ``classifier`` item of ``<output_dir>/checkpoint-<steps>/``,
which ``metrics.classifier.load_classifier_state`` reads. Logs loss and
batch accuracy every 100 steps and ``final_accuracy`` at the end.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from siss_tpu_torch.data import InfiniteSampler
from siss_tpu_torch.metrics.classifier import CLASSIFIER_ITEM
from siss_tpu_torch.models.resnet import resnet18
from siss_tpu_torch.tasks.base import Task
from siss_tpu_torch.utils import CheckpointManager


class TrainClassifier(Task):
    def run(self) -> None:
        cfg = self.cfg
        tracker = self.make_tracker()
        dataset = self.build_dataset(cfg.dataset)
        with torch.random.fork_rng(devices=[]):   # seed the initial weights only
            torch.manual_seed(int(cfg.random_seed))
            model = resnet18(num_classes=int(cfg.get("num_classes", 10)), grayscale=True)
        model = model.to(self.device)
        opt = torch.optim.AdamW(model.parameters(), lr=float(cfg.get("lr", 1e-3)),
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

        def one_step(batch, targets):
            logits = model(batch)
            loss = F.cross_entropy(logits, targets)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach(), (logits.argmax(-1) == targets).float().mean()

        bs = int(cfg.get("train_batch_size", 256))
        steps = int(cfg.get("training_steps", 1000))
        sampler = iter(InfiniteSampler(len(dataset), seed=int(cfg.random_seed)))
        model.train()
        acc = torch.zeros(())
        for i in range(steps):
            idx = [next(sampler) for _ in range(bs)]
            imgs = (np.stack([dataset[j] for j in idx]) + 1.0) / 2.0   # [0, 1], NHWC
            batch = self.to_device(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))
            targets = self.to_device(np.asarray(dataset.labels[idx], np.int64))
            loss, acc = self.timed(self.step_seconds, one_step, batch, targets)
            if i % 100 == 0:
                tracker.log({"loss": loss, "accuracy": acc}, step=i)

        CheckpointManager(str(cfg.output_dir)).save_bundle(
            steps, {CLASSIFIER_ITEM: model.state_dict()})
        tracker.log({"final_accuracy": acc}, step=steps)
        tracker.finish()
