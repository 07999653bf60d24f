from siss_tpu_torch.ops.siss import (
    launch_counts,
    reset_launch_counts,
    siss_weighted_sums,
    siss_weighted_sums_reference,
)

__all__ = ["launch_counts", "reset_launch_counts", "siss_weighted_sums",
           "siss_weighted_sums_reference"]
