"""The port's diffusers exporter (siss_tpu_torch.utils.export) against the
JAX package's (siss_tpu/utils/export.py).

Random values for every leaf of a flax param tree (its shapes from
``jax.eval_shape``) are carried into the port's module with
``load_flax_params``; exporting the port's module must then give the JAX
exporter's state dict of the same tree key for key and bit for bit, for a
tiny attention UNet2D, a tiny UNet2DCondition and a tiny VAE, in float32
and from bfloat16 (both promote to float32). The config.json dicts must
equal JAX's key for key for those configs and the full presets. A port
bundle exported to diffusers directories, through the function and the
``python3 -m siss_tpu_torch.utils.export`` command line, must import back
bit for bit.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from siss_tpu.models.unet2d import UNet2D as FlaxUNet2D
from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig
from siss_tpu.models.unet2d_cond import UNet2DCondition as FlaxUNet2DCondition
from siss_tpu.models.unet2d_cond import UNet2DConditionConfig as FlaxCondConfig
from siss_tpu.models.vae import AutoencoderKL as FlaxVAE
from siss_tpu.models.vae import AutoencoderKLConfig as FlaxVAEConfig
from siss_tpu.utils import export as jax_export
from siss_tpu_torch.models import (AutoencoderKL, AutoencoderKLConfig, UNet2D,
                                   UNet2DCondition, UNet2DConditionConfig, UNet2DConfig)
from siss_tpu_torch.utils import CheckpointManager, load_flax_params
from siss_tpu_torch.utils import export
from siss_tpu_torch.utils.hf_convert import import_hf_unet

# tests/test_export_diffusers.py's attention UNet2D
ATTN_UNET = dict(sample_size=16, block_out_channels=(16, 32),
                 down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                 up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=8,
                 attention_head_dim=8)
FAMILIES = {
    "unet2d": (lambda: FlaxUNet2D(FlaxConfig(**ATTN_UNET)).init_params(jax.random.PRNGKey(0)),
               lambda: UNet2D(UNet2DConfig(**ATTN_UNET))),
    "unet_cond": (lambda: FlaxUNet2DCondition(FlaxCondConfig.tiny()).init_params(
        jax.random.PRNGKey(1), context_len=7),
        lambda: UNet2DCondition(UNet2DConditionConfig.tiny())),
    "vae": (lambda: FlaxVAE(FlaxVAEConfig.tiny()).init_params(jax.random.PRNGKey(2), image_size=16),
            lambda: AutoencoderKL(AutoencoderKLConfig.tiny())),
}


def random_tree(init, seed=0):
    """A numpy tree of the flax params' shapes, values drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        jax.eval_shape(init))


def assert_same_state_dict(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        t = ours[k]
        assert t.dtype == torch.float32 and t.is_contiguous(), k
        assert t.untyped_storage().nbytes() == t.numel() * 4, k   # owns its storage
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_equals_jax(family):
    init, make = FAMILIES[family]
    tree = random_tree(init)
    model = load_flax_params(make(), tree)
    assert_same_state_dict(export.export_diffusers_state_dict(model),
                           jax_export.export_diffusers_state_dict(tree))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_export_equals_jax(family):
    """bfloat16 tensors and leaves are promoted to float32 alike."""
    init, make = FAMILIES[family]
    tree = random_tree(init, seed=1)
    sd = {k: v.to(torch.bfloat16) for k, v in load_flax_params(make(), tree).state_dict().items()}
    bf16_tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    assert_same_state_dict(export.export_diffusers_state_dict(sd),
                           jax_export.export_diffusers_state_dict(bf16_tree))


def test_legacy_names_are_renamed_and_collisions_raise():
    sd = UNet2D(UNet2DConfig(**ATTN_UNET)).state_dict()
    legacy = {k.replace(".to_q.", ".query.").replace(".to_out.0.", ".proj_attn."): v
              for k, v in sd.items()}
    key = "mid_block.attentions.0.query.weight"
    legacy[key] = legacy[key][:, :, None]       # a 1×1 attention conv [O, I, 1]
    out = export.export_diffusers_state_dict(legacy)
    assert sorted(out) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], v), k
    with pytest.raises(ValueError, match="collision"):
        export.export_diffusers_state_dict({**sd, "mid_block.attentions.0.proj_attn.bias":
                                            sd["mid_block.attentions.0.to_out.0.bias"]})


CONFIGS = {
    "attn_unet": (lambda: FlaxConfig(**ATTN_UNET), lambda: UNet2DConfig(**ATTN_UNET)),
    "celebahq_256": (FlaxConfig.celebahq_256, UNet2DConfig.celebahq_256),
    "mnist_tshirt": (FlaxConfig.mnist_tshirt, UNet2DConfig.mnist_tshirt),
    "cond_tiny": (FlaxCondConfig.tiny, UNet2DConditionConfig.tiny),
    "sd_v1": (FlaxCondConfig.sd_v1, UNet2DConditionConfig.sd_v1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_equals_jax(name):
    jax_cfg, port_cfg = (make() for make in CONFIGS[name])
    want = jax_export.diffusers_config_for(jax_cfg)
    got = export.diffusers_config_for(port_cfg)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    emit = export.unet2d_config_json if isinstance(port_cfg, UNet2DConfig) else \
        export.sd_unet_config_json
    assert emit(port_cfg) == got
    with pytest.raises(TypeError):
        export.diffusers_config_for(AutoencoderKLConfig.tiny())


@pytest.fixture()
def bundle(tmp_path):
    """A port bundle of the tiny attention UNet: ``unet`` and an EMA that
    differs from it."""
    model = UNet2D(UNet2DConfig(**ATTN_UNET))
    sd = model.state_dict()
    ema = {k: v + 0.5 for k, v in sd.items()}
    path = CheckpointManager(str(tmp_path / "run")).save_bundle(7, {"unet": sd, "unet_ema": ema,
                                                                   "state": {"step": 7}})
    return path, {"unet": sd, "unet_ema": ema}


def assert_round_trip(written, items, out_dir):
    assert sorted(written) == sorted(items)
    for item, sd in items.items():
        with open(f"{out_dir}/{item}/config.json") as f:
            assert json.load(f) == export.unet2d_config_json(UNet2DConfig(**ATTN_UNET))
        model = import_hf_unet(written[item], UNet2D(UNet2DConfig(**ATTN_UNET)))
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (item, k)


def test_bundle_round_trip(bundle, tmp_path):
    path, items = bundle
    out = tmp_path / "exported"
    written = export.export_bundle_to_diffusers(path, UNet2DConfig(**ATTN_UNET), str(out))
    assert_round_trip(written, items, out)
    only = export.export_bundle_to_diffusers(path, UNet2DConfig(**ATTN_UNET), str(tmp_path / "o"),
                                             items=("unet_ema",))
    assert list(only) == ["unet_ema"]
    with pytest.raises(FileNotFoundError):
        export.export_bundle_to_diffusers(path, UNet2DConfig(**ATTN_UNET), str(tmp_path / "x"),
                                          items=("vae",))


def test_bundle_round_trip_through_the_cli(bundle, tmp_path, capsys):
    path, items = bundle
    run_config = tmp_path / "config.json"
    run_config.write_text(json.dumps({"unet": {"_target_": "siss_tpu.models.unet2d.UNet2DConfig",
                                               **{k: list(v) if isinstance(v, tuple) else v
                                                  for k, v in ATTN_UNET.items()}}}))
    out = tmp_path / "cli"
    written = export.main(["--checkpoint", path, "--run-config", str(run_config),
                           "--out", str(out)])
    assert_round_trip(written, items, out)
    assert "[export] unet_ema -> " in capsys.readouterr().out
    with pytest.raises(SystemExit):
        export.main(["--checkpoint", path, "--out", str(out)])
    assert isinstance(export.architecture("sd_v1"), UNet2DConditionConfig)
    assert export.architecture("celebahq_256") == UNet2DConfig.celebahq_256()
