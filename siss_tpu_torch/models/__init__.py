from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, build_unet, init_weights
from siss_tpu_torch.models.unet2d_cond import (
    UNet2DCondition,
    UNet2DConditionConfig,
    build_unet_cond,
)

__all__ = ["UNet2D", "UNet2DConfig", "build_unet", "init_weights", "UNet2DCondition",
           "UNet2DConditionConfig", "build_unet_cond"]
