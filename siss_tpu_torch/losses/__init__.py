from siss_tpu_torch.losses.deletion import (
    LOSS_DRAWS,
    LOSS_FUNCTIONS,
    SCALAR_PATH_LOSSES,
    SHARED_FORWARD_LOSSES,
    DeletionLoss,
    DeletionLossOutputs,
)

__all__ = ["LOSS_DRAWS", "LOSS_FUNCTIONS", "SCALAR_PATH_LOSSES", "SHARED_FORWARD_LOSSES",
           "DeletionLoss", "DeletionLossOutputs"]
