from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, build_unet, init_weights

__all__ = ["UNet2D", "UNet2DConfig", "build_unet", "init_weights"]
