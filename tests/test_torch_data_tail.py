"""The port's data surface left from the JAX package's: ``BatchLoader``'s
``collate`` and ``drop_last`` (siss_tpu/data/loader.py),
``LabeledImageDataset.from_hf`` (siss_tpu/data/datasets.py) and
``ShapesDataset`` (siss_tpu/data/shapes.py), each held to the JAX one on the
same inputs: the same batches, arrays, files and configurations, exactly.
``from_hf`` runs against a stub ``datasets`` module put in ``sys.modules``,
so nothing is downloaded.
"""

import sys
import types

import numpy as np
import pytest
from PIL import Image

from siss_tpu.data import BatchLoader as JaxBatchLoader
from siss_tpu.data import LabeledImageDataset as JaxLabeled
from siss_tpu.data.shapes import ShapesDataset as JaxShapes
from siss_tpu_torch.data import BatchLoader, LabeledImageDataset
from siss_tpu_torch.data.shapes import ShapesDataset


class Pairs:
    """Items ``(image [4, 4, 1] float32, label)``, like SDData's."""

    def __init__(self, n=10):
        rng = np.random.default_rng(0)
        self.images = rng.normal(size=(n, 4, 4, 1)).astype(np.float32)
        self.labels = np.arange(n) % 3

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


def as_dict(items):
    return {"x": np.stack([x for x, _ in items]), "y": np.asarray([y for _, y in items])}


def flat(batch):
    if isinstance(batch, dict):
        return [batch[k] for k in sorted(batch)]
    return list(batch) if isinstance(batch, tuple) else [batch]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("collate", [None, as_dict], ids=["default", "custom"])
def test_batches_equal_jax(prefetch, drop_last, collate):
    ds, order = Pairs(), [7, 1, 4, 0, 9, 3, 8, 2, 6, 5]   # a finite sampler: 2 batches + 2
    kw = dict(prefetch=prefetch, collate=collate, drop_last=drop_last)
    got = list(BatchLoader(ds, order, 4, **kw))
    want = list(JaxBatchLoader(ds, order, 4, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        for a, b in zip(flat(g), flat(w), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if not drop_last:
        assert len(flat(got[-1])[0]) == 2


def test_default_collate_of_arrays_and_skip():
    ds = Pairs()
    images = [x for x, _ in (ds[i] for i in range(len(ds)))]
    got = list(BatchLoader(images, list(range(10)), 3, drop_last=False, skip_batches=1))
    want = list(JaxBatchLoader(images, list(range(10)), 3, drop_last=False, skip_batches=1))
    assert [g.shape for g in got] == [w.shape for w in want] == [(3, 4, 4, 1)] * 2 + [(1, 4, 4, 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture()
def hf_stub(monkeypatch):
    """A ``datasets`` module whose ``load_dataset`` returns grey 5×5 images
    (PIL, as the hub's MNIST rows are) and labels, and records its calls."""
    rng = np.random.default_rng(1)
    rows = {"image": [Image.fromarray(rng.integers(0, 256, (5, 5), dtype=np.uint8))
                      for _ in range(9)],
            "label": [int(v) for v in rng.integers(0, 3, 9)]}
    calls = []

    def load_dataset(name, split="train"):
        calls.append((name, split))
        return rows

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))
    return calls


@pytest.mark.parametrize("filter", ["all", "deletion", "nondeletion"])
@pytest.mark.parametrize("normalize", [True, False])
def test_from_hf_equals_jax(hf_stub, filter, normalize):
    kw = dict(split="test", image_key="image", class_to_remove=2, normalize=normalize)
    got = LabeledImageDataset.from_hf(filter, "stub/mnist", **kw)
    want = JaxLabeled.from_hf(filter, "stub/mnist", **kw)
    assert hf_stub == [("stub/mnist", "test")] * 2
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a.dtype == b.dtype and a.shape == (5, 5, 1)
        np.testing.assert_array_equal(a, b)


def test_from_hf_imports_datasets_only_when_called(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)   # import fails
    with pytest.raises(ImportError):
        LabeledImageDataset.from_hf("all", "stub/mnist")


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    """Three configuration directories of RGB PNGs, one with a grey PNG of
    upper-case suffix and one with a JPEG, each with a text file; and a
    stray image at the top level."""
    root = tmp_path_factory.mktemp("shapes")
    rng = np.random.default_rng(2)
    for config, n in (("red_cube_large", 2), ("blue_sphere_small", 3), ("green_cyl_small", 1)):
        (root / config).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)).save(
                root / config / f"{i:03d}.png")
        (root / config / "notes.txt").write_text("not an image")
    Image.fromarray(rng.integers(0, 256, (6, 6), dtype=np.uint8)).save(
        root / "green_cyl_small" / "grey.PNG")
    Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)).save(
        root / "blue_sphere_small" / "photo.jpg")
    Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)).save(root / "stray.png")
    return str(root)


@pytest.mark.parametrize("include,exclude", [
    (None, None), (["red_cube_large", "green_cyl_small", "absent"], None),
    (None, ["blue_sphere_small"]), (["red_cube_large", "blue_sphere_small"], ["red_cube_large"])])
@pytest.mark.parametrize("normalize", [True, False])
def test_shapes_equal_jax(shapes_root, include, exclude, normalize):
    got = ShapesDataset(shapes_root, include, exclude, normalize)
    want = JaxShapes(shapes_root, include, exclude, normalize)
    assert got.configs == want.configs and got.files == want.files and len(got) == len(want) > 0
    for i in range(len(got)):
        assert got.config_of(i) == want.config_of(i)
        a, b = got[i], want[i]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
