"""Faults planted in the port underneath a run, to show that ``correct``
catches them (``portbench/tests``) and to read them on the card
(``python3 -m portbench.control --fault``). Each is a patch of the port's
modules that ``plant`` applies and its returned function undoes.

- ``unchanged``: a step returns its state unchanged (training: no
  optimizer or EMA update; sampling: each reverse step returns x_t);
- ``half_batch``: half of the batch left out (training: the step sees the
  first half of each microbatch and takes its means over it; sampling: the
  UNet runs on the first half of its batch and that half stands in for
  the rest);
- ``altered``: an answer altered where it is produced (training: one row's
  ε prediction in each microbatch doubled; sampling: the first checked
  image of each request negated).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _patch(module, name, value, undo):
    undo.append((module, name, getattr(module, name)))
    setattr(module, name, value)


def _double_row0(eps_apply):
    def altered(*args):
        out = eps_apply(*args)
        return torch.cat([2.0 * out[:1], out[1:]])
    return altered


def _half(eps_apply):
    def half(model, x, t, cond):
        h = x.shape[0] // 2
        e = eps_apply(model, x[:h], t[:h], None if cond is None else cond[:h])
        return torch.cat([e, e])
    return half


def plant(fault: str, kind: str, traffic: dict, seed: int):
    """Apply ``fault`` for a run of ``kind``; returns the undo function."""
    import siss_tpu_torch.train as T
    import siss_tpu_torch.train.step as S
    from siss_tpu_torch.diffusion import sampling

    from portbench.loops.sample_requests import checked_rows

    undo = []
    if kind == "unlearn_step" and fault == "unchanged":
        _patch(S, "_apply_update", lambda state, *a: setattr(state, "step", state.step + 1), undo)
    elif kind == "unlearn_step" and fault == "half_batch":
        build = T.build_deletion_train_step

        def build_half(*a, **k):
            step = build(*a, **k)

            def half(state, batch, generator=None, dyn_scalars=None, draws=None):
                h = batch["all"].shape[1] // 2
                return step(state, {n: v[:, :h] for n, v in batch.items()}, generator,
                            dyn_scalars, {n: v[:, :h] for n, v in draws.items()})
            return half
        _patch(T, "build_deletion_train_step", build_half, undo)
    elif kind == "unlearn_step" and fault == "altered":
        for name in ("unet_eps_apply", "cond_unet_eps_apply"):
            _patch(T, name, _double_row0(getattr(T, name)), undo)
    elif fault == "unchanged":
        for name in ("ddpm_step", "ddim_step"):
            _patch(sampling, name, lambda schedule, x_t, *a, **k: x_t, undo)
    elif fault == "half_batch":
        for name in ("unet_eps_apply", "cond_unet_eps_apply"):
            _patch(T, name, _half(getattr(T, name)), undo)
    elif fault == "altered":
        requests = [0]
        # Where each sampler takes its number of steps.
        for name, steps_at in (("sample_ddpm", 3), ("sample_ddim_cfg", 6)):
            def altered(*a, _f=getattr(sampling, name), _at=steps_at, **k):
                out = _f(*a, **k)
                if a[_at] != traffic["steps"]:   # the warm-up's short call
                    return out
                img = out[0] if isinstance(out, tuple) else out
                row = checked_rows(traffic, seed, requests[0])[0]
                requests[0] += 1
                with torch.inference_mode():
                    img[row] = -img[row]
                return out
            _patch(sampling, name, altered, undo)
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def restore():
        for module, name, value in reversed(undo):
            setattr(module, name, value)
    return restore
