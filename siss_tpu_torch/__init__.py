"""PyTorch/CUDA port of siss_tpu (data unlearning for diffusion models).

The JAX package ``siss_tpu`` is the reference this package is held against;
nothing here imports it or JAX. Entry points take ``device=`` and default to
``"cuda"``; they raise when no card is present unless the caller asks for
``"cpu"`` (the CPU tests do).
"""

from siss_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
