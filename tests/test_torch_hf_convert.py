"""The port's diffusers importer (siss_tpu_torch.utils.hf_convert) against
the JAX package's, on a state dict with the pre-0.18 attention names that
google/ddpm-celebahq-256 ships (``query``/``key``/``value``/``proj_attn``,
the mid-block's q, k and v as 1×1 convolutions [O, I, 1]).

The state dict is a diffusers-free torch reference of the celeb block
structure at 16² over three levels, narrow channels, built as
tests/test_celeb_converter_golden.py builds it. Both importers must give
the same parameters bit for bit and the same ε in fp32 (rtol 1e-5 on
outputs of order one, plus atol 1e-5 for the elements near zero); the
three faults a strict bijection refuses raise the same exception types in
both; and the celeb task starts from a diffusers directory, a snapshot
holding one as ``unet/`` and a state-dict file with those names.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (torch threads, no TF32)
from test_celeb_converter_golden import TorchUNet2DRef
from test_torch_celeb import celeb_args, write_folder
from siss_tpu.models.unet2d import UNet2D as FlaxUNet2D
from siss_tpu.models.unet2d import UNet2DConfig as FlaxConfig
from siss_tpu.utils.hf_convert import convert_unet2d as jax_convert_unet2d
from siss_tpu_torch.config import load_config
from siss_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from siss_tpu_torch.tasks import DeleteCeleb
from siss_tpu_torch.utils.convert import params_from_flax
from siss_tpu_torch.utils.hf_convert import (convert_unet2d, import_hf_unet,
                                             load_torch_state_dict)

# The celeb block structure (single-head attention at one level and in the
# mid-block, pad-0 downsampling, freq_shift 1, no flip) at three levels.
CELEB_SMALL = dict(
    sample_size=16, in_channels=3, out_channels=3, block_out_channels=(16, 32, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
    attention_head_dim=None, norm_num_groups=8, flip_sin_to_cos=False, freq_shift=1,
    downsample_padding=0,
)
QKV = (".query.weight", ".key.weight", ".value.weight")


def legacy_names(sd):
    """A diffusers ≥ 0.18 state dict renamed to the pre-0.18 attention
    names, the mid-block's q, k and v weights as [O, I, 1]."""
    out = {}
    for k, v in sd.items():
        k = (k.replace(".to_q.", ".query.").replace(".to_k.", ".key.")
             .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn."))
        if k.startswith("mid_block.attentions.") and k.endswith(QKV):
            v = v[:, :, None]
        out[k] = v
    return out


@pytest.fixture(scope="module")
def legacy():
    """(numpy legacy state dict, JAX params converted from it)."""
    torch.manual_seed(0)
    sd = TorchUNet2DRef(FlaxConfig(**CELEB_SMALL)).diffusers_state_dict()
    for k in [k for k in sd if k.startswith("mid_block.attentions.") and k.endswith(QKV)]:
        sd[k] = sd[k][:, :, None]
    assert any(".proj_attn.weight" in k for k in sd) and not any(".to_q." in k for k in sd)
    model = FlaxUNet2D(FlaxConfig(**CELEB_SMALL))
    template = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    return sd, jax_convert_unet2d(sd, template)


def as_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_legacy_import_equals_jax(legacy):
    sd, params = legacy
    model = UNet2D(UNet2DConfig(**CELEB_SMALL))
    ours = convert_unet2d(as_torch(sd), model)
    want = params_from_flax(jax.tree.map(np.asarray, params))
    assert sorted(ours) == sorted(want) == sorted(model.state_dict())
    for k, v in want.items():
        assert torch.equal(ours[k], v), k
    model.load_state_dict(ours, strict=True)

    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([999, 250], np.int32)
    fmodel = FlaxUNet2D(FlaxConfig(**CELEB_SMALL))
    eps_jax = np.asarray(jax.jit(fmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        eps = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    np.testing.assert_allclose(eps.permute(0, 2, 3, 1).numpy(), eps_jax, rtol=1e-5, atol=1e-5)


def _missing(sd):
    sd.pop("mid_block.attentions.0.proj_attn.bias")


def _wrong_shape(sd):
    sd["conv_in.weight"] = sd["conv_in.weight"][:, :, :2]


def _extra(sd):
    sd["mid_block.attentions.0.rel_pos.weight"] = sd["conv_in.bias"]


@pytest.mark.parametrize("fault,error", [(_missing, KeyError), (_wrong_shape, ValueError),
                                         (_extra, ValueError)],
                         ids=["missing", "wrong_shape", "extra"])
def test_strict_bijection_raises_as_jax(legacy, fault, error):
    sd, params = legacy
    bad = dict(sd)
    fault(bad)
    with pytest.raises(error):
        jax_convert_unet2d(bad, params)
    with pytest.raises(error):
        convert_unet2d(as_torch(bad), UNet2D(UNet2DConfig(**CELEB_SMALL)))


def test_allow_unused_and_the_allowlist_pass_as_in_jax(legacy):
    sd, params = legacy
    extra = dict(sd, **{"mid_block.attentions.0.rel_pos.weight": sd["conv_in.bias"],
                        "time_embedding.num_batches_tracked": np.zeros((), np.int64)})
    jax_convert_unet2d(extra, params, allow_unused=(r".*rel_pos\..*",))
    out = convert_unet2d(as_torch(extra), UNet2D(UNet2DConfig(**CELEB_SMALL)),
                         allow_unused=(r".*rel_pos\..*",))
    assert "mid_block.attentions.0.rel_pos.weight" not in out


def test_model_directory_search_and_wrapper(legacy, tmp_path):
    """A directory is searched in the JAX order (a safetensors name first,
    then ``diffusion_pytorch_model.bin``, then ``pytorch_model.bin``); a
    ``state_dict`` wrapper is unwrapped; an empty directory raises."""
    sd = as_torch(legacy[0])
    torch.save({"state_dict": sd}, tmp_path / "pytorch_model.bin")
    got = load_torch_state_dict(str(tmp_path))
    assert sorted(got) == sorted(sd)
    torch.save({"conv_in.bias": sd["conv_in.bias"]}, tmp_path / "diffusion_pytorch_model.bin")
    assert list(load_torch_state_dict(str(tmp_path))) == ["conv_in.bias"]
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path / "nothing_here"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path / "empty"))
    full = tmp_path / "full"
    full.mkdir()
    torch.save(sd, full / "diffusion_pytorch_model.bin")
    model = import_hf_unet(str(full), UNet2D(UNet2DConfig(**CELEB_SMALL)))
    want = convert_unet2d(sd, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("package", ["installed", "missing"])
def test_a_bin_beside_safetensors_is_read_without_the_package(legacy, tmp_path, monkeypatch,
                                                                package):
    """A directory holding both ``diffusion_pytorch_model.safetensors`` and
    ``.bin``: the safetensors file first where the package imports, else
    the ``.bin`` (a card may lack the package); a lone ``.safetensors``
    without the package raises the ImportError that names it."""
    from safetensors.torch import save_file

    sd = as_torch(legacy[0])
    save_file({"conv_in.bias": sd["conv_in.bias"].contiguous()},
              str(tmp_path / "diffusion_pytorch_model.safetensors"))
    torch.save(sd, tmp_path / "diffusion_pytorch_model.bin")
    if package == "missing":
        monkeypatch.setitem(sys.modules, "safetensors", None)
        monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    got = load_torch_state_dict(str(tmp_path))
    assert sorted(got) == (["conv_in.bias"] if package == "installed" else sorted(sd))
    if package == "missing":
        (tmp_path / "diffusion_pytorch_model.bin").unlink()
        with pytest.raises(ImportError, match="safetensors"):
            load_torch_state_dict(str(tmp_path))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("celeba"))


@pytest.mark.parametrize("form", ["model_dir", "snapshot", "file"])
def test_celeb_task_starts_from_a_legacy_diffusers_checkpoint(folder, tmp_path, form):
    """``checkpoint_path`` at a diffusers model directory, a snapshot with a
    ``unet/`` subfolder, or a ``.bin`` file, all with legacy names: the
    task's UNet gets the donor's weights bit for bit."""
    cfg = load_config("delete_celeb", celeb_args(folder, tmp_path)[3:])
    task = DeleteCeleb(cfg, device="cpu")
    donor, ucfg = task.build_unet()
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.25)
    want = donor.state_dict()
    unet_dir = tmp_path / "snap" / "unet"
    unet_dir.mkdir(parents=True)
    torch.save(legacy_names(want), unet_dir / "diffusion_pytorch_model.bin")
    (unet_dir / "config.json").write_text(json.dumps({"_class_name": "UNet2DModel"}))
    task.cfg.checkpoint_path = str({"model_dir": unet_dir, "snapshot": tmp_path / "snap",
                                    "file": unet_dir / "diffusion_pytorch_model.bin"}[form])
    model, _ = task.build_unet()
    task._load_pretrained(model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
