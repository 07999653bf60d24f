"""The SISS unlearning step, plain float32: the reference that the port's
training steps are held to.

Per microbatch: q(x_t | x_0) noising of the keep and forget images with
shared noise, the Bernoulli(λ) mixture (a row keeps its keep-set image when
u > λ), one UNet forward, the importance-weighted ε-MSE sums

    iw_x = 1 / ((1 − λ) + λ·e^d),   iw_a = 1 / ((1 − λ)·e^(−d) + λ),
    d = (‖x_t − γ·x‖² − ‖x_t − γ·a‖²) / (2σ²),

and two gradients from that forward, of Σ iw_x·‖ε − (x_t − γ·x)/σ‖² / mb
and of Σ iw_a·‖ε − (x_t − γ·a)/σ‖² / mb. They are summed over the rows
(in blocks of ``rows``) and averaged over the microbatches. Then the
surgery g = g_x − (scaling_norm / ‖g_a‖)·g_a, the clip of g to
``max_grad_norm``, AdamW (``torch.optim.AdamW``'s update, written out) and
the EMA (diffusers' decay 1 − (1 + step)^(−power), at most max_decay).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from portbench.reference.nn import Params


def _per_sample_sum(x):
    return x.reshape(x.shape[0], -1).sum(1)


def adamw_(params: List[torch.Tensor], grads, state, step: int, lr, betas, eps, wd):
    b1, b2 = betas
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, (m, v) in zip(params, grads, state):
        p.mul_(1.0 - lr * wd)
        m.lerp_(g, 1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.addcdiv_(m, (v.sqrt() / math.sqrt(bc2)).add_(eps), value=-lr / bc1)


def ema_decay(step: int, inv_gamma: float, power: float, max_decay: float) -> float:
    return min(max(1.0 - (1.0 + step / inv_gamma) ** -power, 0.0), max_decay)


def run_steps(eps_fn, weights: Dict[str, torch.Tensor], train: dict, sched, pool, draws,
              steps: int, rows: int, precision: str = "float32",
              state: Optional[dict] = None) -> dict:
    """``steps`` steps from ``weights`` on ``pool[s]`` and ``draws[s]``;
    ``eps_fn(P, x_nhwc, t, cond)``. Without ``state`` they are the first
    steps (zero moments, the EMA at ``weights``); with it, they follow
    ``state["step"]`` steps already taken, from its AdamW moments
    (``state["adam"]``: (m, v) by leaf) and EMA (``state["ema"]``, or None).
    Returns the readings: each step's mean keep and forget ε-MSE ("loss":
    [[lx, la], ...]) and the importance weights' mean and std ("weights":
    [[x mean, x std, a mean, a std], ...]), each leaf's norm of the first
    of these steps' clipped gradient ("grad"), and each leaf's norm of its
    change over the steps ("change"; "ema." leaves too, with an EMA)."""
    names = list(weights)
    leaves = [weights[n].detach().clone().requires_grad_(True) for n in names]
    P = Params(dict(zip(names, leaves)), precision)
    opt = train["optimizer"]
    lr, betas, wd = float(opt["lr"]), tuple(opt["betas"]), float(opt["weight_decay"])
    adam_eps = float(opt["eps"])
    ema_cfg = train.get("ema")
    if state is None:
        adam = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
        ema0, taken = (weights if ema_cfg else None), 0
    else:
        adam = [tuple(x.detach().clone().float() for x in state["adam"][n]) for n in names]
        ema0, taken = state["ema"], state["step"]
    ema = [ema0[n].detach().clone() for n in names] if ema_cfg else None
    lam = float(train["lambd"])
    out = {"loss": [], "weights": []}
    for s in range(steps):
        batch, dr = pool[s], draws[s]
        A, mb = batch["all"].shape[:2]
        gx = [torch.zeros_like(p) for p in leaves]
        ga = [torch.zeros_like(p) for p in leaves]
        lx_all, la_all, iw_all = [], [], {"x": [], "a": []}
        for a in range(A):
            for r0 in range(0, mb, rows):
                sl = slice(r0, r0 + rows)
                keep, forget = batch["all"][a, sl], batch["deletion"][a, sl]
                cond = batch["conditioning"][a, sl] if "conditioning" in batch else None
                noise, t, u = dr["noise"][a, sl], dr["t"][a, sl], dr["u"][a, sl]
                shape = (-1,) + (1,) * (keep.ndim - 1)
                g, sg = sched.gamma[t].reshape(shape), sched.sigma[t].reshape(shape)
                mix = torch.where((u > lam).reshape(shape), sched.q_sample(keep, noise, t),
                                  sched.q_sample(forget, noise, t))
                preds = eps_fn(P, mix, t, cond)
                rx, ra = mix - g * keep, mix - g * forget
                lx = _per_sample_sum((preds - rx / sg) ** 2)
                la = _per_sample_sum((preds - ra / sg) ** 2)
                d = (_per_sample_sum(rx ** 2) - _per_sample_sum(ra ** 2)) / (2.0 * sched.sigma[t] ** 2)
                log_l, log_1ml = math.log(lam), math.log1p(-lam)
                iw_x = torch.exp(-torch.logaddexp(torch.full_like(d, log_1ml), log_l + d))
                iw_a = torch.exp(-torch.logaddexp(log_1ml - d, torch.full_like(d, log_l)))
                px = torch.autograd.grad((iw_x * lx).sum() / mb, leaves, retain_graph=True)
                pa = torch.autograd.grad((iw_a * la).sum() / mb, leaves)
                torch._foreach_add_(gx, px)
                torch._foreach_add_(ga, pa)
                pixels = keep[0].numel()
                lx_all.append(lx.detach() / pixels)
                la_all.append(la.detach() / pixels)
                iw_all["x"].append(iw_x.detach())
                iw_all["a"].append(iw_a.detach())
                del preds, px, pa
        torch._foreach_div_(gx, A)
        torch._foreach_div_(ga, A)
        out["loss"].append([torch.cat(lx_all).mean().item(), torch.cat(la_all).mean().item()])
        # Each microbatch's mean and population std, averaged over them.
        out["weights"].append([float(f(torch.cat(iw_all[k]).reshape(A, mb)).mean())
                               for k in "xa" for f in (lambda v: v.mean(1),
                                                       lambda v: v.std(1, correction=0))])
        with torch.no_grad():
            norm_a = torch.sqrt(sum((x.float() ** 2).sum() for x in ga))
            scale = train["scaling_norm"] / norm_a
            scale = torch.where(torch.isfinite(scale), scale, torch.zeros_like(scale))
            g = [x - scale * y for x, y in zip(gx, ga)]
            pre = torch.sqrt(sum((x ** 2).sum() for x in g))
            clip = torch.clamp(train["max_grad_norm"] / (pre + 1e-6), max=1.0)
            g = [x * clip for x in g]
            if s == 0:
                out["grad"] = dict(zip(names, (x.norm().item() for x in g)))
            adamw_(leaves, g, adam, taken + s + 1, lr, betas, adam_eps, wd)
            if ema is not None:
                k = 1.0 - ema_decay(taken + s + 1, ema_cfg["inv_gamma"], ema_cfg["power"],
                                    ema_cfg["max_decay"])
                for e, p in zip(ema, leaves):
                    e.sub_(k * (e - p))
        del gx, ga, g
    with torch.no_grad():
        change = {n: (p - weights[n]).norm().item() for n, p in zip(names, leaves)}
        if ema is not None:
            change.update({f"ema.{n}": (e - ema0[n]).norm().item() for n, e in zip(names, ema)})
    out["change"] = change
    return out
