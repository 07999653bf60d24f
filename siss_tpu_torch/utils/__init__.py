from siss_tpu_torch.utils.checkpoint import CheckpointManager
from siss_tpu_torch.utils.convert import load_flax_params, params_from_flax
from siss_tpu_torch.utils.preemption import PreemptionGuard
from siss_tpu_torch.utils.tracker import Tracker

__all__ = ["CheckpointManager", "load_flax_params", "params_from_flax", "PreemptionGuard",
           "Tracker"]
