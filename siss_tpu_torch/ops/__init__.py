from collections import ChainMap

from siss_tpu_torch.ops import flash_attention as _flash
from siss_tpu_torch.ops import siss as _siss
from siss_tpu_torch.ops.siss import (
    siss_weighted_sums,
    siss_weighted_sums_reference,
)

#: Kernel launches since the last ``reset_launch_counts()``, by kernel name:
#: one live mapping over each kernel module's own ``launch_counts`` dict.
launch_counts = ChainMap(_siss.launch_counts, _flash.launch_counts)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for counts in launch_counts.maps:
        for k in counts:
            counts[k] = 0


__all__ = ["launch_counts", "reset_launch_counts", "siss_weighted_sums",
           "siss_weighted_sums_reference"]
