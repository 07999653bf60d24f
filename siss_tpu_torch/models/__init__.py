from siss_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModel,
    build_clip_text,
    load_clip_tokenizer,
)
from siss_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel, build_clip_vision
from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, build_unet, init_weights
from siss_tpu_torch.models.unet2d_cond import (
    UNet2DCondition,
    UNet2DConditionConfig,
    build_unet_cond,
)
from siss_tpu_torch.models.vae import AutoencoderKL, AutoencoderKLConfig, build_vae

__all__ = ["UNet2D", "UNet2DConfig", "build_unet", "init_weights", "UNet2DCondition",
           "UNet2DConditionConfig", "build_unet_cond", "AutoencoderKL", "AutoencoderKLConfig",
           "build_vae", "CLIPTextConfig", "CLIPTextModel", "build_clip_text",
           "load_clip_tokenizer", "CLIPVisionConfig", "CLIPVisionModel", "build_clip_vision"]
