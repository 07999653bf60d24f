"""The port's config reader (siss_tpu_torch.config) against the JAX package's:
for every file in configs/ and a set of overrides the two give equal trees,
exactly (the same YAML loader and the same merge, interpolation and override
rules); and ``get_object`` reads ``siss_tpu.`` targets as the port's."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from siss_tpu.config import load_config as jax_load_config
from siss_tpu.config import to_dict as jax_to_dict
from siss_tpu_torch.config import Config, get_object, instantiate, load_config, to_dict

ROOT = Path(__file__).resolve().parents[1]
CONFIG_NAMES = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))
OVERRIDES = [
    [],
    ["+unet.norm_num_groups=8", "+unet.block_out_channels=[16,32]", "+random_seed=7"],
    ["output_dir=/tmp/x/${project_name}", "+extra.list=[a,1,2.5e-3]", "+extra.flag=null"],
]


def test_every_config_is_covered():
    assert {"train_tshirt_mnist", "delete_tshirt", "delete_celeb", "delete_sd",
            "train_classifier"} <= set(CONFIG_NAMES)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["plain", "unet", "interp"])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_load_config_matches_jax(name, overrides):
    ours = to_dict(load_config(name, overrides))
    theirs = jax_to_dict(jax_load_config(name, overrides))
    assert ours == theirs
    assert repr(ours) == repr(theirs)  # the same types too (1e-4 is a float in both)


def test_delete_tshirt_tree_values():
    cfg = load_config("delete_tshirt", ["metrics.likelihood=null", "deletion.scaling_norm=7"])
    assert cfg.optimizer.lr == 5e-5 and isinstance(cfg.optimizer.lr, float)
    assert cfg.dataset_all.class_to_remove == 10      # ${deletion.class_label}
    assert cfg.metrics.likelihood is None and cfg.deletion.scaling_norm == 7
    assert cfg.unet.sample_size == 28                 # ${resolution} from the parent
    assert cfg.task._target_ == "siss_tpu.tasks.delete_tshirt.DeleteTShirt"


@pytest.mark.parametrize("bad", [["no_such_key=1"], ["unet.sample_size.x=1"], ["novalue"]])
def test_bad_overrides_raise_like_jax(bad):
    for loader in (load_config, jax_load_config):
        with pytest.raises((KeyError, ValueError)):
            loader("train_tshirt_mnist", bad)


def test_get_object_maps_to_the_port():
    from siss_tpu_torch.data.datasets import LabeledImageDataset
    from siss_tpu_torch.models.unet2d import UNet2DConfig
    from siss_tpu_torch.tasks.delete_tshirt import DeleteTShirt
    from siss_tpu_torch.tasks.train_unconditional import TrainUnconditional

    assert get_object("siss_tpu.tasks.delete_tshirt.DeleteTShirt") is DeleteTShirt
    assert get_object("siss_tpu.tasks.train_unconditional.TrainUnconditional") is TrainUnconditional
    assert get_object("siss_tpu.models.unet2d.UNet2DConfig") is UNet2DConfig
    # a nested attribute (a classmethod) resolves too
    assert (get_object("siss_tpu.data.datasets.LabeledImageDataset.from_npz").__func__
            is LabeledImageDataset.from_npz.__func__)
    assert get_object("siss_tpu_torch.tasks.delete_tshirt.DeleteTShirt") is DeleteTShirt
    assert get_object("os.path.join") is os.path.join
    with pytest.raises(ImportError):
        get_object("siss_tpu.tasks.no_such_task.Task")


def test_get_object_imports_no_jax_package():
    code = ("import sys\n"
            "from siss_tpu_torch.config import get_object\n"
            "get_object('siss_tpu.tasks.delete_tshirt.DeleteTShirt')\n"
            "get_object('siss_tpu.data.datasets.LabeledImageDataset.from_npz')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('siss_tpu', 'jax', 'flax', 'optax'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_instantiate_dataset_node(tmp_path):
    import numpy as np

    from siss_tpu_torch.data import LabeledImageDataset

    images = np.arange(6 * 4, dtype=np.uint8).reshape(6, 2, 2, 1)
    np.savez(tmp_path / "d.npz", images=images, labels=np.array([0, 10, 1, 10, 2, 3]))
    node = Config({"_target_": "siss_tpu.data.datasets.LabeledImageDataset.from_npz",
                   "filter": "deletion", "path": str(tmp_path / "d.npz"), "class_to_remove": 10})
    ds = instantiate(node)
    assert isinstance(ds, LabeledImageDataset) and len(ds) == 2
    partial = instantiate({"_target_": "builtins.dict", "_partial_": True, "a": 1})
    assert partial(b=2) == {"a": 1, "b": 2}
