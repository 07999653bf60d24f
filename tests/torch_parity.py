"""Shared set-up of the parity tests between siss_tpu (JAX) and its PyTorch
port siss_tpu_torch: CPU-only torch with few threads and no TF32, the tiny
UNet configs, and the flax → torch model carry."""

import numpy as np
import torch

# The suite runs under xdist with several workers; keep each one's torch small.
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY_UNET = dict(
    sample_size=8,
    block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=2,
    norm_num_groups=8,
)
# mnist-like: multi-head attention, flipped sin/cos, symmetric downsample pad.
MNIST_LIKE = dict(TINY_UNET, in_channels=1, out_channels=1, attention_head_dim=8,
                  flip_sin_to_cos=True, freq_shift=0, downsample_padding=1)
# celeb-like: single head, no flip, freq_shift=1, asymmetric (0,1) downsample pad.
CELEB_LIKE = dict(TINY_UNET, in_channels=3, out_channels=3, attention_head_dim=None,
                  flip_sin_to_cos=False, freq_shift=1, downsample_padding=0)


def flax_unet(kwargs, seed=0):
    """(flax module, params, numpy param tree) for a tiny UNet config."""
    import jax

    from siss_tpu.models.unet2d import UNet2D, UNet2DConfig

    model = UNet2D(UNet2DConfig(**kwargs))
    params = model.init_params(jax.random.PRNGKey(seed))
    return model, params, jax.tree.map(np.asarray, params)


def torch_unet(kwargs, np_params):
    """The port's UNet2D on the CPU with the flax params carried over."""
    from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
    from siss_tpu_torch.utils.convert import load_flax_params

    return load_flax_params(UNet2D(UNet2DConfig(**kwargs)), np_params)
