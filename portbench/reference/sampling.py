"""The evaluation samplers, plain float32: DDPM ancestral sampling and
classifier-free-guidance DDIM with the per-step noise norms."""

from __future__ import annotations

import torch


@torch.no_grad()
def ddpm(eps, sched, x, step_noise, steps):
    """``eps(x_nhwc, t_batch)``; ``step_noise(i)`` the noise of step i."""
    for i, (t, p) in enumerate(sched.grid(steps)):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        x = sched.ddpm_step(x, eps(x, tb), t, p, step_noise(i) if p >= 0 else None)
    return x


@torch.no_grad()
def ddim_cfg(eps, sched, x, cond, uncond, guidance, steps):
    """``eps(x_nhwc, t_batch, context)``. Returns (latents, [steps, B]
    ‖ε_uncond‖, [steps, B] ‖ε_text − ε_uncond‖)."""
    both = torch.cat([uncond, cond], dim=0)
    dims = tuple(range(1, x.ndim))
    un, tx = [], []
    B = x.shape[0]
    for t, p in sched.grid(steps):
        tb = torch.full((2 * B,), t, dtype=torch.long, device=x.device)
        e = eps(torch.cat([x, x], dim=0), tb, both)
        e_u, delta = e[:B], e[B:] - e[:B]
        un.append(torch.linalg.vector_norm(e_u, dim=dims))
        tx.append(torch.linalg.vector_norm(delta, dim=dims))
        x = sched.ddim_step(x, e_u + guidance * delta, t, p)
    return x, torch.stack(un), torch.stack(tx)
