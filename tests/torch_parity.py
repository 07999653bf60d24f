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


# TinyEps: a two-convolution ε model with a timestep table, the same function
# in JAX (jax_tiny_apply on a numpy param dict) and torch (TinyEps, params in
# the same HWIO layout and names), for tests of the step's logic that need
# no UNet: eps = conv2(silu(conv1(x) + b1 + temb[t])) + b2, NHWC.
def tiny_params(seed=0, channels=2, width=8, T=1000):
    """Numpy params of TinyEps: eps = conv2(silu(conv1(x) + temb[t]))."""
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(0, 0.3, (3, 3, channels, width)).astype(np.float32),
            "b1": rng.normal(0, 0.1, (width,)).astype(np.float32),
            "temb": rng.normal(0, 0.5, (T, width)).astype(np.float32),
            "w2": rng.normal(0, 0.3, (3, 3, width, channels)).astype(np.float32),
            "b2": rng.normal(0, 0.1, (channels,)).astype(np.float32)}


def jax_tiny_apply(p, x, t, cond=None):
    import jax

    dn = ("NHWC", "HWIO", "NHWC")
    h = jax.lax.conv_general_dilated(x, p["w1"], (1, 1), "SAME", dimension_numbers=dn)
    h = jax.nn.silu(h + p["b1"] + p["temb"][t][:, None, None, :])
    return jax.lax.conv_general_dilated(h, p["w2"], (1, 1), "SAME", dimension_numbers=dn) + p["b2"]


class TinyEps(torch.nn.Module):
    """TinyEps in torch, params in the same (HWIO) layout and names."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(np.array(v))))

    def forward(self, x, t):   # x NHWC
        conv = lambda v, w: torch.nn.functional.conv2d(v, w.permute(3, 2, 0, 1), padding=1)  # noqa: E731
        h = conv(x.permute(0, 3, 1, 2), self.w1) + self.b1[:, None, None]
        h = torch.nn.functional.silu(h + self.temb[t][:, :, None, None])
        return (conv(h, self.w2) + self.b2[:, None, None]).permute(0, 2, 3, 1)


def tiny_apply(model, x, t, cond=None):
    return model(x, t)
