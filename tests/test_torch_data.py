"""The port's data pipeline (siss_tpu_torch.data) against the JAX package's:
synthetic images, dataset filtering and normalisation, sampler indices
(with the resume fast-forward) and the dual keep/forget stream are equal,
bit for bit (both are numpy on the host, with the same draws)."""

import itertools

import numpy as np
import pytest

from siss_tpu import data as jax_data
from siss_tpu.data import loader as jax_loader
from siss_tpu_torch import data as port_data


@pytest.mark.parametrize("n_per_class,seed", [(4, 0), (9, 3)])
def test_synthetic_images_equal(n_per_class, seed):
    ours = port_data.make_synthetic_mnist_tshirt(n_per_class=n_per_class, seed=seed)
    theirs = jax_data.make_synthetic_mnist_tshirt(n_per_class=n_per_class, seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_repository_dataset_shape():
    """The tracked data file the tasks read: 5,632 images, 11 classes."""
    ds = port_data.LabeledImageDataset.from_npz("all", "data/datasets/mnist_with_tshirt.npz")
    assert len(ds) == 5632 and ds.images.shape[1:] == (28, 28, 1)
    assert np.bincount(ds.labels).tolist() == [512] * 11


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("filt", ["all", "deletion", "nondeletion"])
def test_labeled_dataset_matches_jax(tmp_path, filt, normalize):
    images, labels = jax_data.make_synthetic_mnist_tshirt(n_per_class=3, seed=1)
    path = str(tmp_path / "d.npz")
    np.savez(path, images=images, labels=labels)
    ours = port_data.LabeledImageDataset.from_npz(filt, path, class_to_remove=10,
                                                  normalize=normalize)
    theirs = jax_data.LabeledImageDataset.from_npz(filt, path, class_to_remove=10,
                                                   normalize=normalize)
    assert len(ours) == len(theirs) > 0
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if normalize:
        assert ours[0].min() >= -1.0 and ours[0].max() <= 1.0


def test_filter_errors_and_normalisation():
    images = np.zeros((2, 2, 2), np.uint8)
    with pytest.raises(ValueError):
        port_data.LabeledImageDataset("deletion", images, np.array([0, 1]))
    with pytest.raises(ValueError):
        port_data.LabeledImageDataset("bogus", images, np.array([0, 1]), class_to_remove=1)
    # uint8 is scaled by type, floats pass as [0, 1]; 2-D images gain a channel
    for arr in (np.array([[0, 255]], np.uint8), np.array([[0.0, 1.0]], np.float32)):
        np.testing.assert_array_equal(port_data.normalize_to_unit_range(arr),
                                      jax_data.normalize_to_unit_range(arr))
    ds = port_data.ArrayDataset(images)
    assert ds[0].shape == (2, 2, 1)


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, window_size=0.1),
                                dict(seed=2, rank=1, num_replicas=3), dict(shuffle=False),
                                dict(seed=1, window_size=0.0)])
def test_infinite_sampler_indices_equal(kw):
    ours = list(itertools.islice(port_data.InfiniteSampler(37, **kw), 300))
    theirs = list(itertools.islice(jax_data.InfiniteSampler(37, **kw), 300))
    assert ours == theirs


def _loader_batches(pkg, ds, seed, skip, n):
    loader = pkg.BatchLoader(ds, pkg.InfiniteSampler(len(ds), seed=seed), 5, skip_batches=skip)
    return list(itertools.islice(iter(loader), n))


@pytest.mark.parametrize("skip", [0, 3])
def test_loader_batches_and_skip_equal(skip):
    images, labels = jax_data.make_synthetic_mnist_tshirt(n_per_class=2, seed=4)
    ours_ds = port_data.LabeledImageDataset("all", images, labels)
    theirs_ds = jax_data.LabeledImageDataset("all", images, labels)
    ours = _loader_batches(port_data, ours_ds, 9, skip, 4)
    theirs = _loader_batches(jax_data, theirs_ds, 9, skip, 4)
    for a, b in zip(ours, theirs):
        assert a.shape == (5, 28, 28, 1) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # skipping k batches starts where the unskipped stream's batch k is
    full = _loader_batches(port_data, ours_ds, 9, 0, 4 + skip)
    np.testing.assert_array_equal(ours[0], full[skip])


def test_dual_stream_equal():
    images, labels = jax_data.make_synthetic_mnist_tshirt(n_per_class=3, seed=2)

    def stream(pkg, loader_mod):
        keep = pkg.LabeledImageDataset("nondeletion", images, labels, class_to_remove=10)
        forget = pkg.LabeledImageDataset("deletion", images, labels, class_to_remove=10)
        k = pkg.BatchLoader(keep, pkg.InfiniteSampler(len(keep), seed=46), 4)
        f = pkg.BatchLoader(forget, pkg.InfiniteSampler(len(forget), seed=47), 4)
        return loader_mod.dual_stream(iter(k), iter(f), 2)

    ours = stream(port_data, port_data)
    theirs = stream(jax_data, jax_loader)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == ["all", "deletion"] and a["all"].shape == (2, 4, 28, 28, 1)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_loader_surfaces_dataset_errors():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise IndexError("broken item")

    it = iter(port_data.BatchLoader(Broken(), port_data.InfiniteSampler(3), 2))
    with pytest.raises(RuntimeError, match="worker failed"):
        next(it)
