"""Stacked cotangents in the kernels' autograd Functions.

``torch.autograd.grad(outputs, inputs, grad_outputs, is_grads_batched=True)``
pulls a stack of cotangents through the graph in one backward: PyTorch runs
the engine under its vmap (``torch._vmap_internals``), so each Function's
``backward`` receives batched tensors, whose logical shape hides the stack.
A kernel reads raw pointers through ctypes and cannot see such a tensor. So
``SissCore`` and ``FlashAttention`` take the physical stack out
(``unbatch``), run their kernels over it, and wrap their gradients back
(``rebatch``). The train step's ``batched_dual_backward`` is the caller: a
stack of two seeds, (1, 0) and (0, 1).

One library op cannot run under that vmap either: GroupNorm's backward asks
its saved input whether it is channels_last, which a batched tensor cannot
answer (``NYI: querying is_contiguous inside of vmap``). The UNets' inputs
are channels_last (NHWC latents viewed as NCHW; channels_last weights on the
card), so ``contiguous_norm_inputs`` hands every GroupNorm a contiguous copy
of its input for the forward, backward and recomputation of a batched pull.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch


def unbatch(t: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], Optional[int]]:
    """(the physical tensor with the stack as dim 0, the vmap level) of a
    batched cotangent; (t, None) for a plain tensor or None."""
    if t is None or not torch._C._functorch.is_legacy_batchedtensor(t):
        return t, None
    # The innermost vmap level that ``t`` is batched at. ``_remove_batch_dim``
    # expands a tensor not batched at ``level`` to the given batch size, 0
    # here, so an empty result means another level.
    top = torch._C._vmapmode_increment_nesting()
    torch._C._vmapmode_decrement_nesting()
    for level in range(top, 0, -1):
        physical = torch._remove_batch_dim(t, level, 0, 0)
        if physical.shape[0]:
            return physical, level
    raise RuntimeError(f"a batched cotangent of logical shape {tuple(t.shape)} is batched at no "
                       f"vmap level up to {top}")


def rebatch(t: torch.Tensor, level: int) -> torch.Tensor:
    """A batched gradient whose stack is ``t``'s dim 0, at ``level``."""
    return torch._add_batch_dim(t, 0, level)


@contextlib.contextmanager
def contiguous_norm_inputs(model: torch.nn.Module, enabled: bool = True) -> Iterator[None]:
    """While open, every ``nn.GroupNorm`` of ``model`` normalises a
    contiguous copy of its input: its backward then runs under the vmap of
    a batched pull. Does nothing unless ``enabled``."""
    if not enabled:
        yield
        return
    hooks = [m.register_forward_pre_hook(lambda _, args: (args[0].contiguous(),) + args[1:])
             for m in model.modules() if isinstance(m, torch.nn.GroupNorm)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
