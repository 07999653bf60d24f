"""The ``sample_requests`` traffic: one client, closed loop. Each request
is one call of the port's sampler (``sample_ddpm``, or ``sample_ddim_cfg``
under classifier-free guidance) for ``images`` images, its start noise,
step noise and prompt embeddings made from the seed and the request's
number; it ends when its images reach the host. Requests run back to back
and none starts after ``seconds``. Set-up warms up a request's shapes with
a two-step call. Once the window has closed, ``checked_images`` rows of one
finished request, both drawn from the seed, are compared with the
reference's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import compare as cmp
from portbench.drive import STREAMS, generator, sub_seed
from portbench.reference import sampling as ref_sampling
from portbench.reference.nn import Params
from portbench.reference.schedule import Schedule
from portbench.trace import Capture


class LazyNoise:
    """The step noise of one request, made from the seed when a step asks."""

    def __init__(self, seed, request, shape, steps, device):
        self.seed, self.request, self.shape, self.steps, self.device = (
            seed, request, shape, steps, device)

    def __len__(self):
        return self.steps

    def __getitem__(self, i):
        return torch.randn(self.shape, device=self.device,
                           generator=generator(self.device, self.seed, "requests", self.request,
                                               i + 1))


def request_inputs(m, traffic: dict, seed: int, device, r: int, rows=None):
    """Request ``r``'s start noise, prompt embeddings and unconditional
    embeddings (``rows``: only those rows)."""
    shape = (traffic["images"],) + m.image
    g = generator(device, seed, "requests", r)
    x = torch.randn(shape, generator=g, device=device)
    cond = m.family.conditioning(m.unet, shape[0], g, device)
    uncond = m.family.conditioning(m.unet, 1, generator(device, seed, "uncond"), device)
    if uncond is not None:
        uncond = uncond.expand_as(cond)
    if rows is not None:
        x = x[rows]
        cond = None if cond is None else cond[rows]
        uncond = None if uncond is None else uncond[rows]
    return x, cond, uncond


def checked_rows(traffic: dict, seed: int, r: int) -> List[int]:
    """The rows of request ``r`` that a run compares, drawn from the seed."""
    g = torch.Generator().manual_seed(sub_seed(seed, STREAMS["checked"], r))
    return sorted(torch.randperm(traffic["images"], generator=g)[:traffic["checked_images"]]
                  .tolist())


def checked(traffic: dict, seed: int, requests: int):
    """The (request, row) pairs a run compares: ``checked_images`` rows of
    one request that the window finished, both drawn from the seed."""
    g = torch.Generator().manual_seed(sub_seed(seed, STREAMS["checked"]))
    r = int(torch.randint(requests, (1,), generator=g))
    return [(r, row) for row in checked_rows(traffic, seed, r)]


class Work:
    """The ``sample_requests`` traffic on one configuration."""

    per = "request"

    def __init__(self, model, traffic: dict, seed: int, device):
        self.m, self.traffic, self.seed, self.device = model, traffic, seed, device
        self.shape = (traffic["images"],) + model.image
        from siss_tpu_torch.diffusion import NoiseSchedule

        s = model.config["schedule"]
        self.schedule = NoiseSchedule.create(s["num_train_timesteps"], s["beta_schedule"],
                                             s["beta_start"], s["beta_end"],
                                             clip_sample=s["clip_sample"], device=device)
        self.model, eps_apply = model.port(seed, device)
        self.eps_fn = lambda x, t, c: eps_apply(self.model, x, t, c)
        self.outputs: List[dict] = []
        self.requests_done = 0

    def sample(self, r: int, steps: int, eps_fn=None):
        from siss_tpu_torch.diffusion import sampling

        eps_fn = eps_fn or self.eps_fn
        x, cond, uncond = request_inputs(self.m, self.traffic, self.seed, self.device, r)
        tr = self.traffic
        if tr["sampler"] == "ddpm":
            return sampling.sample_ddpm(eps_fn, self.schedule, self.shape, steps, x_init=x,
                                        step_noise=LazyNoise(self.seed, r, self.shape, steps,
                                                             self.device)), None
        return sampling.sample_ddim_cfg(eps_fn, self.schedule, self.shape, cond, uncond,
                                        tr["guidance_scale"], steps,
                                        track_noise_norm=tr["track_noise_norm"], x_init=x)

    def set_up(self):
        """Every shape of a request: two sampler steps at its batch."""
        self.sample(-1, 2)

    def run(self, eps_fn=None):
        r = self.requests_done
        images, norms = self.sample(r, self.traffic["steps"], eps_fn)
        out = {"images": images.cpu()}
        if norms is not None:
            out["norms"] = torch.stack([norms["uncond_norm"], norms["text_norm"]]).cpu()
        self.outputs.append(out)
        self.requests_done += 1
        return out

    def window(self, seconds, trace, log):
        """Requests back to back; none starts after ``seconds``. With
        ``trace``, ``trace_calls`` UNet calls in the middle of the first
        request run under the profiler."""
        failed, traced, spans = 0, {}, []
        tr = self.traffic
        n_traced = tr["trace_calls"]
        first = tr["steps"] // 2 - n_traced // 2
        rows = tr["images"] * (2 if tr["sampler"] == "ddim_cfg" else 1)
        calls = 0

        def traced_eps(x, t, c):
            nonlocal calls
            i, calls = calls, calls + 1
            if i == first:
                traced["cap"] = Capture()
                traced["cap"].start()
                traced["t0"] = time.perf_counter()
            elif i == first + n_traced:
                traced["trace"] = traced["cap"].stop()
                traced["s"] = traced["trace"].window_s
                traced["request_extra"] = time.perf_counter() - traced["t0"] - traced["s"]
            return self.eps_fn(x, t, c)

        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t0 = time.perf_counter()
            out = self.run(traced_eps if trace and not traced else None)
            failed += not self.finite(out)
            spans.append(time.perf_counter() - t0)
        elapsed = time.perf_counter() - t_start
        untraced_s = None
        if trace:
            untraced_s = ((spans[0] - traced["s"] - traced["request_extra"])
                          / (tr["steps"] - n_traced))
            log(f"trace overhead: {traced['s'] / n_traced:.4f} s a traced UNet call against "
                f"{untraced_s:.4f} s an untraced one of the same request")
        return dict(attempted=len(spans), failed=failed, elapsed=elapsed,
                    images=len(spans) * tr["images"], trace=traced.get("trace"),
                    units=n_traced, rows=rows, untraced_s=untraced_s)

    @staticmethod
    def finite(out) -> bool:
        return bool(torch.isfinite(out["images"]).all())

    def answers(self):
        """The program's answers at the checked pairs, and those pairs."""
        pairs = checked(self.traffic, self.seed, self.requests_done)
        return {(r, row): {"images": self.outputs[r]["images"][row],
                           "norms": (self.outputs[r]["norms"][:, :, row]
                                     if "norms" in self.outputs[r] else None)}
                for r, row in pairs}, pairs

    def release(self):
        del self.model, self.eps_fn


def reference(m, traffic: dict, seed: int, device, pairs, precision="float32") -> dict:
    """The reference's answers at ``pairs``: images, and under guidance the
    per-step noise norms ([2, steps])."""
    sched = Schedule(m.config["schedule"], device)
    P = Params(m.weights(seed, device), precision)
    steps = traffic["steps"]
    shape = (traffic["images"],) + m.image
    by_request: Dict[int, List[int]] = {}
    for r, row in pairs:
        by_request.setdefault(r, []).append(row)
    out = {}
    for r, rows in by_request.items():
        x, cond, uncond = request_inputs(m, traffic, seed, device, r, rows)
        norms = None
        if traffic["sampler"] == "ddpm":
            noise = LazyNoise(seed, r, shape, steps, device)
            img = ref_sampling.ddpm(lambda z, t: m.ref_eps(P, z, t, None), sched, x,
                                    lambda i: noise[i][rows], steps)
        else:
            img, un, tx = ref_sampling.ddim_cfg(lambda z, t, c: m.ref_eps(P, z, t, c), sched, x,
                                                cond, uncond, traffic["guidance_scale"], steps)
            norms = torch.stack([un, tx]).cpu()
        for j, row in enumerate(rows):
            out[(r, row)] = {"images": img[j].cpu(),
                             "norms": None if norms is None else norms[:, :, j]}
    return out


def compare(prog: dict, ref: dict, log=None) -> dict:
    return cmp.sampling(prog, ref)
