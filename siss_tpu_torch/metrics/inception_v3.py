"""InceptionV3 features for FID: port of ``siss_tpu/metrics/inception_v3.py``.

* ``InceptionV3Features``: the InceptionV3 trunk up to the 2048-d average
  pool, NCHW, with torchvision's parameter names, so a torchvision or
  pt_inception state dict loads into it as it is (``fc.*`` and
  ``AuxLogits.*`` dropped). ``variant="fid"`` is the pytorch-fid /
  torchmetrics network the paper's FID runs (``count_include_pad=False``
  average pools in blocks A, C and 7b, a max pool in 7c's pool branch);
  ``variant="torchvision"`` pools as torchvision does.
* ``RandomEmbedder``: a seeded random-projection CNN, the fallback when no
  InceptionV3 weights are at hand. Its FID ("FID-rand", logged as
  ``metrics/fid_rand``) is not comparable with InceptionV3's.
* ``make_inception_feature_fn`` and ``build_fid_evaluator`` wire either into
  ``FIDEvaluator``. Images are resized to 299² with an antialiased bilinear
  filter, as ``jax.image.resize(..., "bilinear")`` does.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.utils.checkpoint import read_state_dict

INCEPTION_SIZE = 299


class BasicConv2d(nn.Module):
    """Convolution without bias, batch norm (eps 1e-3, running statistics),
    ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x, count_include_pad: bool):
    """3×3 stride-1 pad-1 average pool; ``count_include_pad=False`` divides by
    the window's elements inside the image (the FID network)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3(x, count_include_pad=not self.fid_pool))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int, fid_pool: bool = False):
        super().__init__()
        c7 = channels_7x7
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3(x, count_include_pad=not self.fid_pool))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_mode``: ``avg`` (torchvision), ``avg_nocount`` (the FID
    network's 7b) or ``max`` (its 7c)."""

    def __init__(self, in_ch: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3(x, count_include_pad=self.pool_mode == "avg")
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """InceptionV3 up to the 2048-d average pool: ``model(x) -> [N, 2048]``
    for NCHW 299² images in [−1, 1]."""

    def __init__(self, variant: str = "fid"):
        super().__init__()
        if variant not in ("fid", "torchvision"):
            raise ValueError(f"Unknown InceptionV3 variant {variant!r}: choose fid or torchvision")
        fid = variant == "fid"
        self.variant = variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_nocount" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def load_inception_state_dict(model: InceptionV3Features, sd: Mapping[str, object]) -> None:
    """Load a torchvision / pt_inception ``inception_v3`` state dict (numpy
    arrays or tensors) into ``model``; ``fc.*`` and ``AuxLogits.*`` are
    dropped, and a dict without batch-norm ``num_batches_tracked`` counters
    is accepted."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
          for k, v in sd.items() if not k.startswith(("fc.", "AuxLogits."))}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"InceptionV3 state dict: missing {missing}, unexpected {unexpected}")


class RandomEmbedder(nn.Module):
    """Three stride-2 3×3 convolutions with ReLU, a spatial mean and a dense
    layer to ``features``, random weights from ``seed``: the FID-rand
    embedder."""

    def __init__(self, features: int = 512, seed: int = 42):
        super().__init__()
        chans = (3, 32, 64, 128)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2, padding=1)
                                   for a, b in zip(chans[:-1], chans[1:]))
        self.dense = nn.Linear(chans[-1], features)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for mod in (*self.convs, self.dense):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen) / np.sqrt(np.prod(w.shape[1:])))
                mod.bias.zero_()

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.dense(x.mean(dim=(2, 3)))


def random_embedder_from_flax(params: Mapping[str, Mapping[str, np.ndarray]]) -> RandomEmbedder:
    """The port's ``RandomEmbedder`` with the JAX module's flax params
    (``Conv_0..2`` and ``Dense_0``, numpy HWIO / [in, out] kernels)."""
    model = RandomEmbedder(features=int(np.shape(params["Dense_0"]["kernel"])[1]))
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            p = params[f"Conv_{i}"]
            conv.weight.copy_(torch.tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(p["bias"])))
        model.dense.weight.copy_(torch.tensor(np.asarray(params["Dense_0"]["kernel"]).T))
        model.dense.bias.copy_(torch.tensor(np.asarray(params["Dense_0"]["bias"])))
    return model


def resize_to_inception(x: torch.Tensor) -> torch.Tensor:
    """NCHW images resized to 299² by antialiased bilinear interpolation."""
    return F.interpolate(x, size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                         align_corners=False, antialias=True)


def embedding_feature_fn(model: nn.Module, batch_input_range: str = "01",
                         device="cuda") -> Callable:
    """``feature_fn(imgs_nhwc) -> [N, D]`` over ``model`` on ``device``:
    gray images repeated to RGB, resized to 299², mapped from [0, 1] to
    [−1, 1] when ``batch_input_range`` is "01"."""
    dev = resolve_device(device)
    model = model.eval().requires_grad_(False).to(dev)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
    model = model.to(memory_format=fmt)

    @torch.inference_mode()
    def feature_fn(imgs) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(imgs), dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = resize_to_inception(x)
        if batch_input_range == "01":
            x = x * 2.0 - 1.0
        return model(x.contiguous(memory_format=fmt))

    return feature_fn


def make_inception_feature_fn(weights_path: Optional[str] = None, batch_input_range: str = "01",
                              variant: str = "fid", device="cuda") -> Tuple[Callable, str]:
    """``(feature_fn, embedder_name)``: InceptionV3 from a torchvision /
    pt_inception state dict at ``weights_path`` (``"inception_v3"``), or,
    when there is no such file, ``RandomEmbedder`` (``"rand"``)."""
    if weights_path and os.path.exists(weights_path):
        model = InceptionV3Features(variant=variant)
        load_inception_state_dict(model, read_state_dict(weights_path))
        name = "inception_v3"
    else:
        model, name = RandomEmbedder(), "rand"
    return embedding_feature_fn(model, batch_input_range, device), name


def build_fid_evaluator(fid_cfg: Mapping, real_dataset, max_real: int = 2048, device="cuda"):
    """An ``FIDEvaluator`` from a config node (``inception_weights``,
    ``inception_variant``, ``inception_batch_size``) with the statistics of
    the first ``max_real`` images of ``real_dataset`` ([−1, 1]) cached."""
    from siss_tpu_torch.metrics.fid import FIDEvaluator

    feature_fn, embedder = make_inception_feature_fn(
        fid_cfg.get("inception_weights"), variant=str(fid_cfg.get("inception_variant", "fid")),
        device=device)
    n = min(len(real_dataset), max_real)
    real = np.stack([(np.asarray(real_dataset[i]) + 1.0) / 2.0 for i in range(n)])
    return FIDEvaluator(feature_fn, real_images=real,
                        inception_batch_size=int(fid_cfg.get("inception_batch_size", 64)),
                        embedder=embedder)
