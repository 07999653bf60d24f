"""The ``unlearn_step`` traffic: the SISS unlearning step of the port
(``siss_tpu_torch.train.build_deletion_train_step``, draws injected) on
global batches of ``microbatch`` × ``accumulation`` rows.

A pool of ``pool`` batches and their draws is made from the seed on the
device and cycled. Set-up builds the one training state, drives it through
its first ``check_steps`` steps (the reference follows them from the seed's
weights) and hands it on to the window. A window step ends in a
synchronise, as the task's loop does when it logs the step; the window runs
steps back to back, the last being the one that ends after ``seconds``.
Once the window has closed, the same call takes one step more (the "late"
step) from the state the window left, and the reference follows that step
from a copy of the program's state taken just before it.
"""

from __future__ import annotations

import json
import time

import torch

from portbench import compare as cmp
from portbench.drive import generator, sync
from portbench.reference import train as ref_train
from portbench.reference.schedule import Schedule
from portbench.trace import Capture

TRACE_FROM = 0.3   # the traced steps start this far into the window


def _images(config, shape, gen, device):
    if config["data"] == "uniform":
        return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
    return torch.randn(shape, generator=gen, device=device)


def _leaf_norms(names, tensors, scale=1.0):
    return {n: float(t.norm()) * scale for n, t in zip(names, tensors)}


def train_pool(m, traffic: dict, seed: int, device):
    """The pool of global batches ("all", "deletion", and "conditioning"
    under a conditional UNet, [A, mb, ...]) and their draws ("noise", "t",
    "u")."""
    cfg, train = m.config, m.config["train"]
    A, mb = traffic["accumulation"], traffic["microbatch"]
    pool, draws = [], []
    shape = (A, mb) + m.image
    for p in range(traffic["pool"]):
        g = generator(device, seed, "data", p)
        batch = {"all": _images(cfg, shape, g, device), "deletion": _images(cfg, shape, g, device)}
        cond = m.family.conditioning(m.unet, A * mb, g, device)
        if cond is not None:
            batch["conditioning"] = cond.reshape((A, mb) + cond.shape[1:])
        pool.append(batch)
        g = generator(device, seed, "draws", p)
        draws.append({"noise": torch.randn(shape, generator=g, device=device),
                      "t": torch.randint(train["t_min"], train["t_max"], (A, mb), generator=g,
                                         device=device),
                      "u": torch.rand((A, mb), generator=g, device=device)})
    return pool, draws


class Work:
    """The ``unlearn_step`` traffic on one configuration."""

    per = "step"

    def __init__(self, model, traffic: dict, seed: int, device):
        self.m, self.traffic, self.seed, self.device = model, traffic, seed, device
        cfg, train = model.config, model.config["train"]
        self.images_per_step = traffic["accumulation"] * traffic["microbatch"]
        self.pool, self.draws = train_pool(model, traffic, seed, device)
        self.readings = {"loss": [], "weights": []}

        import siss_tpu_torch.train as T
        from siss_tpu_torch.diffusion import NoiseSchedule

        self.model, eps_apply = model.port(seed, device)
        self.names = [n for n, _ in self.model.named_parameters()]
        opt, sched = T.build_optimizer(train["optimizer"], self.model.parameters())
        self.state = T.TrainState.create(self.model, opt, sched, use_ema=bool(train["ema"]))
        s = cfg["schedule"]
        schedule = NoiseSchedule.create(s["num_train_timesteps"], s["beta_schedule"],
                                        s["beta_start"], s["beta_end"],
                                        clip_sample=s["clip_sample"], device=device)
        ema = train["ema"] or {}
        step_cfg = T.DeletionStepConfig(
            loss_fn=train["loss_fn"], loss_params=(("lambd", train["lambd"]),),
            scaling_norm=train["scaling_norm"], max_grad_norm=train["max_grad_norm"],
            grad_accum_steps=traffic["accumulation"], t_min=train["t_min"], t_max=train["t_max"],
            use_ema=bool(train["ema"]), ema_inv_gamma=ema.get("inv_gamma", 1.0),
            ema_power=ema.get("power", 0.75), ema_max_decay=ema.get("max_decay", 0.9999))
        self.step_fn = T.build_deletion_train_step(eps_apply, schedule, step_cfg)
        self.steps_done = 0

    def run(self):
        """One step on the next batch of the pool; its metrics."""
        i = self.steps_done % len(self.pool)
        self.state, metrics = self.step_fn(self.state, self.pool[i], draws=self.draws[i])
        self.steps_done += 1
        return metrics

    def _moments(self):
        """Each leaf's AdamW moments; a leaf the optimizer never updated
        holds none and reads zeros."""
        opt = self.state.optimizer
        return [(opt.state[p].get("exp_avg", torch.zeros_like(p)),
                 opt.state[p].get("exp_avg_sq", torch.zeros_like(p)))
                for p in self.model.parameters()]

    def _step_readings(self, readings, metrics):
        readings["loss"].append([metrics["loss_x/mean"].item(), metrics["loss_a/mean"].item()])
        readings["weights"].append([metrics[f"importance_weight_{k}/{stat}"].item()
                                    for k in "xa" for stat in ("mean", "std")])

    def _changes(self, params0, ema0):
        with torch.no_grad():
            change = _leaf_norms(self.names, (p - params0[n] for n, p in
                                              zip(self.names, self.model.parameters())))
            if self.state.ema is not None:
                change.update(_leaf_norms([f"ema.{n}" for n in self.names],
                                          (e - ema0[n] for n, e in
                                           zip(self.names, self.state.ema.params))))
        return change

    def set_up(self):
        """The first steps, which the reference follows; their readings."""
        beta1 = self.m.config["train"]["optimizer"]["betas"][0]
        for s in range(self.traffic["check_steps"]):
            self._step_readings(self.readings, self.run())
            if s == 0:
                # The gradient as AdamW holds it: its first moment over 1 − β1.
                self.readings["grad"] = _leaf_norms(
                    self.names, (m for m, _ in self._moments()), 1.0 / (1.0 - beta1))
        w0 = self.m.weights(self.seed, self.device)
        self.readings["change"] = self._changes(w0, w0)
        del w0

    def window(self, seconds, trace, log):
        """Steps back to back; the last is the one that ends after ``seconds``."""
        plain, failed, traced, n_traced = [], 0, None, self.traffic["trace_steps"]
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if trace and traced is None and t0 - t_start >= TRACE_FROM * seconds:
                cap = Capture()
                cap.start()
                for _ in range(n_traced):
                    failed += not self.finite(self.run())
                traced = cap.stop()
            else:
                failed += not self.finite(self.run())
                sync(self.device)
                plain.append(time.perf_counter() - t0)
            if time.perf_counter() - t_start >= seconds and (not trace or traced is not None):
                break
        elapsed = time.perf_counter() - t_start
        untraced_s = sum(plain) / len(plain) if plain else None
        if trace:
            log(f"trace overhead: {traced.window_s / n_traced:.4f} s a traced step against "
                f"{untraced_s} s an untraced one")
        steps = len(plain) + (n_traced if trace else 0)
        return dict(attempted=steps, failed=failed, elapsed=elapsed,
                    images=steps * self.images_per_step, trace=traced, units=n_traced,
                    rows=self.images_per_step, untraced_s=untraced_s)

    def answers(self):
        """The readings of the set-up's steps and of one late step, taken
        through the same call from the state the window left; and the copy
        of that state, from which the reference follows the late step."""
        beta1 = self.m.config["train"]["optimizer"]["betas"][0]
        with torch.no_grad():
            params = {n: p.detach().clone() for n, p in
                      zip(self.names, self.model.parameters())}
            moments = self._moments()
            start = {"adam": {n: (m.clone(), v.clone()) for n, (m, v) in
                              zip(self.names, moments)},
                     "step": int(self.state.step),
                     "index": self.steps_done % len(self.pool)}
            start["ema"] = (None if self.state.ema is None else
                            {n: e.clone() for n, e in zip(self.names, self.state.ema.params)})
        late = {"loss": [], "weights": []}
        self._step_readings(late, self.run())
        late["grad"] = _leaf_norms(self.names, ((m1 - beta1 * m0) / (1.0 - beta1) for (m1, _), (m0, _)
                                                in zip(self._moments(), start["adam"].values())))
        late["change"] = self._changes(params, start["ema"] or params)
        start["params"] = params
        return {"first": self.readings, "late": late}, start

    @staticmethod
    def finite(metrics) -> bool:
        return bool(torch.isfinite(metrics["gradient/pre_clip_norm"]).item())

    def release(self):
        del self.state, self.model, self.step_fn, self.pool, self.draws


def reference(m, traffic: dict, seed: int, device, start: dict, precision="float32") -> dict:
    """The reference's readings over the first ``check_steps`` steps from the
    seed's weights, and over the late step from ``start``, on the same
    batches and draws."""
    pool, draws = train_pool(m, traffic, seed, device)
    args = (m.config["train"], Schedule(m.config["schedule"], device))
    first = ref_train.run_steps(m.ref_eps, m.weights(seed, device), *args, pool, draws,
                                traffic["check_steps"], traffic["reference_rows"], precision)
    i = start["index"]
    late = ref_train.run_steps(m.ref_eps, start["params"], *args, [pool[i]], [draws[i]], 1,
                               traffic["reference_rows"], precision, state=start)
    return {"first": first, "late": late}


def compare(prog: dict, ref: dict, log=None) -> dict:
    """``portbench.compare.training`` of the first steps, and of the late
    step under the prefix ``late_``."""
    if log is not None:
        log("worst leaves: " + json.dumps({k: cmp.worst_leaves(prog[k], ref[k]) for k in ref}))
    late = cmp.training(prog["late"], ref["late"])
    return {**cmp.training(prog["first"], ref["first"]),
            **{f"late_{k}": v for k, v in late.items()}}
