"""Batch-inference HTTP server sampling from a checkpoint: port of
``siss_tpu/serve.py``.

A service without dependencies beyond the standard library (and PIL for
the PNG) that answers

    POST /sample   {"n": 4, "steps": 50, "seed": 0, "sampler": "ddpm"|"dpm"}
      → PNG grid
    GET  /healthz  → {"ok": true, "model": ..., "compiled": [...]}

``compiled`` keeps the JAX server's name for the (n, steps, sampler) keys
served so far; eager PyTorch has nothing to compile or warm up, so a key's
first request samples as every later one does.

Run:  python3 -m siss_tpu_torch.serve --checkpoint <bundle-or-state-dict> \\
          --arch celebahq_256 --port 8500 [--device cuda]

``ThreadingHTTPServer`` answers each request on a thread of its own; they
share the model on one device. Each request draws from a generator of its
own, seeded with its ``seed`` in the thread that samples, so a request's
images depend on its seed alone.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from siss_tpu_torch.device import resolve_device
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.diffusion.sampling import sample_ddpm, sample_dpm_solver_2m
from siss_tpu_torch.evaluate import Evaluator
from siss_tpu_torch.models import UNet2DConfig
from siss_tpu_torch.train.step import unet_eps_apply
from siss_tpu_torch.utils.hf_convert import load_unet2d


class SamplerService:
    """``checkpoint``: a port bundle (``checkpoint-<n>`` holding
    ``<subfolder>/item.pt``, or ``<run dir>/latest``), or a state-dict file
    or diffusers model directory with diffusers ``UNet2DModel`` names
    (modern or pre-0.18), read through ``hf_convert.load_unet2d``. The UNet
    is ``UNet2DConfig.<arch>()`` computing in ``dtype``; the schedule the
    linear 1000-step one."""

    def __init__(self, checkpoint: str, arch: str = "celebahq_256", subfolder: str = "unet",
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.arch = arch
        ucfg = getattr(UNet2DConfig, arch)()
        self.shape = (ucfg.sample_size, ucfg.sample_size, ucfg.in_channels)
        self.model = load_unet2d(checkpoint, ucfg, subfolder, dtype, self.device)
        self.schedule = NoiseSchedule.create(1000, "linear", device=self.device)
        self._served = set()
        self._lock = threading.Lock()

    def _eps_fn(self, x: torch.Tensor, t: torch.Tensor, cond) -> torch.Tensor:
        return unet_eps_apply(self.model, x, t, cond)

    def _generator(self, seed: int) -> torch.Generator:
        """A generator of the calling thread's own on the service's device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def served_keys(self) -> list:
        with self._lock:
            return sorted(self._served)

    def sample_grid(self, n: int = 4, steps: int = 50, seed: int = 0,
                    sampler: str = "ddpm") -> np.ndarray:
        """The grid of ``n`` samples drawn from ``seed``: float NHWC in [0, 1]."""
        fn = sample_dpm_solver_2m if sampler == "dpm" else sample_ddpm
        imgs = fn(self._eps_fn, self.schedule, (n, *self.shape), steps,
                  generator=self._generator(seed)).float().cpu().numpy()
        with self._lock:
            self._served.add((n, steps, sampler))
        return Evaluator.make_grid_from_images(np.clip((imgs + 1) / 2, 0, 1))

    def sample_png(self, n: int = 4, steps: int = 50, seed: int = 0,
                   sampler: str = "ddpm") -> bytes:
        from PIL import Image

        arr = (self.sample_grid(n, steps, seed, sampler) * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()


def make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes = b"", content_type: str = None):
            self.send_response(code)
            if content_type:
                self.send_header("Content-Type", content_type)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, e: Exception):
            self._send(code, json.dumps({"error": str(e)}).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404)
                return
            compiled = [list(k) for k in service.served_keys()]
            self._send(200, json.dumps({"ok": True, "model": service.arch,
                                        "compiled": compiled}).encode(), "application/json")

        def do_POST(self):
            if self.path != "/sample":
                self._send(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                args = dict(n=int(req.get("n", 4)), steps=int(req.get("steps", 50)),
                            seed=int(req.get("seed", 0)), sampler=str(req.get("sampler", "ddpm")))
            except (ValueError, TypeError, AttributeError) as e:  # a malformed body
                self._error(400, e)
                return
            try:
                png = service.sample_png(**args)
            except Exception as e:  # the service's own fault
                self._error(500, e)
                return
            self._send(200, png, "image/png")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--arch", default="celebahq_256")
    p.add_argument("--subfolder", default="unet")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    service = SamplerService(args.checkpoint, args.arch, args.subfolder, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    host, port = server.server_address[:2]
    print(f"[siss_tpu_torch.serve] {args.arch} on {service.device} at http://{host}:{port}",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
