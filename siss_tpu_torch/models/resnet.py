"""Classifier ResNets for the metrics: port of ``siss_tpu/models/resnet.py``.

The grayscale-capable ResNet-18 digit classifier of the Inception Score and
the thin CIFAR ResNet-20/32/56 family, as NCHW ``nn.Module``s with
torchvision's names (``conv1``, ``bn1``, ``layer<i>.<j>.conv1``,
``downsample.0``/``.1``, ``fc``), so a torchvision-naming state dict, such
as the reference's MNIST classifier, loads straight into them
(``load_torch_resnet``).

BatchNorm follows flax's ``nn.BatchNorm``, not torch's, where they differ:
the running averages move by 1 − 0.99 = 0.01 of the batch statistic (torch's
``momentum=0.01``), and the running variance takes the *biased* batch
variance (the one that normalises the batch) where ``nn.BatchNorm2d`` takes
the unbiased one, n/(n − 1) times larger.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running statistics: momentum 0.99
    (torch's 0.01) and the biased batch variance."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(filters)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(nn.Conv2d(in_channels, filters, 1, stride, bias=False),
                                            BatchNorm2d(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class ResNet(nn.Module):
    """torchvision-style ResNet of BasicBlocks on NCHW input. ``small_input``
    (MNIST/CIFAR): a 3×3 stem and no max-pool; else the 7×7/2 stem and a
    3×3/2 max-pool."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10, num_filters: int = 64,
                 grayscale: bool = False, small_input: bool = True):
        super().__init__()
        in_ch = 1 if grayscale else 3
        if small_input:
            self.conv1 = nn.Conv2d(in_ch, num_filters, 3, 1, 1, bias=False)
            self.maxpool = None
        else:
            self.conv1 = nn.Conv2d(in_ch, num_filters, 7, 2, 3, bias=False)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.bn1 = BatchNorm2d(num_filters)
        channels = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            blocks = []
            for j in range(n_blocks):
                blocks.append(BasicBlock(channels, filters, 2 if i > 0 and j == 0 else 1))
                channels = filters
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            x = self.maxpool(x)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(num_classes: int = 10, grayscale: bool = True, **kw) -> ResNet:
    """The MNIST metric classifier's architecture."""
    return ResNet((2, 2, 2, 2), num_classes=num_classes, grayscale=grayscale, **kw)


def cifar_resnet(depth: int = 20, num_classes: int = 10, **kw) -> ResNet:
    """Thin CIFAR ResNet family: depth = 6n + 2."""
    if (depth - 2) % 6:
        raise ValueError(f"cifar_resnet depth must be 6n + 2, got {depth}")
    n = (depth - 2) // 6
    return ResNet((n, n, n), num_classes=num_classes, num_filters=16, **kw)


def load_torch_resnet(path_or_state, model: ResNet) -> ResNet:
    """Load a torchvision-naming ResNet state dict (a ``.pt`` path, or a
    mapping of tensors or arrays) into ``model``; every name and shape must
    match (``load_state_dict(strict=True)``). Returns the model."""
    if isinstance(path_or_state, str):
        sd = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        sd = {k: torch.as_tensor(v) for k, v in path_or_state.items()}
    model.load_state_dict(sd)
    return model
