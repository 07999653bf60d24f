"""The port's UNet2D (siss_tpu_torch.models) against the flax UNet2D.

Weights cross through the port's params_from_flax, which must agree key
for key and bit for bit with the JAX package's diffusers exporter. The ε
output is compared at fp32 with atol 1e-4: both frameworks compute the
same graph in fp32, but convolution, GroupNorm and attention sums run in
other orders through ~25 layers, and outputs are O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CELEB_LIKE, MNIST_LIKE, flax_unet, torch_unet
from siss_tpu.utils.export import export_diffusers_state_dict
from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from siss_tpu_torch.utils.convert import params_from_flax

CONFIGS = {"mnist_like": MNIST_LIKE, "celeb_like": CELEB_LIKE}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_carry_matches_exporter(name):
    kwargs = CONFIGS[name]
    _, params, np_params = flax_unet(kwargs)
    ours = params_from_flax(np_params)
    theirs = export_diffusers_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = UNet2D(UNet2DConfig(**kwargs))
    model.load_state_dict(ours, strict=True)  # raises on a missing or extra key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eps_parity(name):
    kwargs = CONFIGS[name]
    fmodel, params, np_params = flax_unet(kwargs, seed=1)
    tmodel = torch_unet(kwargs, np_params)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8, kwargs["in_channels"])).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


def test_celebahq_256_layout_matches_flax():
    """The full-width config builds the same parameter set as the flax model
    (names and shapes), so a carried checkpoint would load strictly."""
    import jax

    from siss_tpu.models.unet2d import UNet2D as FlaxUNet2D
    from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig

    fmodel = FlaxUNet2D(FlaxConfig.celebahq_256())
    shapes = jax.eval_shape(lambda: fmodel.init_params(jax.random.PRNGKey(0), batch_size=1))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ours = UNet2D(UNet2DConfig.celebahq_256())
    carried = params_from_flax(zeros)
    assert {k: tuple(v.shape) for k, v in carried.items()} == \
        {k: tuple(v.shape) for k, v in ours.state_dict().items()}


def test_bf16_autocast_output_is_fp32():
    _, _, np_params = flax_unet(CELEB_LIKE)
    model = UNet2D(UNet2DConfig(**CELEB_LIKE), dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(np_params), strict=True)
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x, torch.tensor([5, 999]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
