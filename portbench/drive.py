"""What every traffic loop (``portbench/loops/<kind>.py``) shares: the
seed's random streams and a configuration's model, weights and reference.

Every input is made from ``--seed`` with ``torch.Generator``s on the device,
one stream per purpose, so the reference can make the same again.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import manifest
from portbench.reference.nn import parameter_shapes

STREAMS = {"weights": 1, "data": 2, "draws": 3, "requests": 4, "checked": 5, "uncond": 6}


def sub_seed(seed: int, *keys: int) -> int:
    s = int(seed) % (2 ** 62)
    for k in keys:
        s = (s * 1_000_003 + 7919 * (int(k) + 1)) % (2 ** 62)
    return s


def generator(device, seed: int, stream: str, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, STREAMS[stream], *keys))


class Model:
    """A configuration's family, reference forward and parameter list."""

    def __init__(self, config: dict):
        self.config = config
        self.unet = config["unet"]
        self.family = manifest.family(config["family"])
        self.ref_eps = self.family.reference_eps(self.unet)
        self.image = tuple(self.family.image_shape(self.unet))
        x = torch.empty((1,) + self.image, device="meta")
        t = torch.empty((1,), dtype=torch.long, device="meta")
        cond = self.family.conditioning(self.unet, 1, None, "meta")
        self.shapes = parameter_shapes(self.ref_eps, x, t, cond)
        self.dtype = getattr(torch, config["compute_dtype"])

    def weights(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """The weights of ``seed``: one draw on the device, cut into leaves
        and scaled by kind (conv and linear weights N(0, 1/fan_in), biases
        N(0, 0.02²), norm scales 1 + N(0, 0.05²), norm shifts N(0, 0.05²))."""
        total = sum(math.prod(s) for s, _ in self.shapes.values())
        flat = torch.randn(total, generator=generator(device, seed, "weights"), device=device)
        out, off = {}, 0
        for name, (shape, kind) in self.shapes.items():
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if kind == "weight":
                t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif kind == "bias":
                t.mul_(0.02)
            elif kind == "norm_weight":
                t.mul_(0.05).add_(1.0)
            else:
                t.mul_(0.05)
            out[name] = t
        return out

    def port(self, seed: int, device):
        """The port's model with the weights of ``seed``, and its ε function."""
        model, eps_apply = self.family.build_port(self.unet, self.config["port"], self.dtype,
                                                  device)
        with torch.no_grad():
            model.load_state_dict(self.weights(seed, device), strict=True)
        if device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model, eps_apply


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
