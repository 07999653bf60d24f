"""The port's t-shirt metrics against the JAX package's: membership loss,
Inception Score (with ``remove_class``), the ``Classifier`` wrapper, the
classifier ResNet (forward, BatchNorm running statistics after training
steps, and ``load_torch_resnet`` of a torchvision-naming state dict).

Weights go from the port's module to flax through the JAX package's own
``load_torch_resnet``, so the parity also holds the port's names to the
torchvision names the reference's checkpoint uses. Draws are injected: the
membership noise and the IS permutation are JAX's, made from JAX keys.
Tolerances: logits rtol 1e-4 / atol 1e-5 (fp32 convolutions summed in
other orders); BatchNorm statistics after two SGD steps rtol 1e-4 / atol
1e-6 (a wrong running-variance rule is off by the factor n/(n − 1) = 1.5),
the params rtol 1e-3 / atol 2e-5 (at n = 3 the last stage's BatchNorm
backward is a difference of nearly equal terms, so its convolutions'
gradients agree to ~1e-3 absolute); IS and membership rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from test_resnet_import import TorchResNet18
from torch_parity import TinyEps, jax_tiny_apply, tiny_apply, tiny_params
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.metrics import Classifier as JaxClassifier
from siss_tpu.metrics import InceptionScore as JaxInceptionScore
from siss_tpu.metrics import MembershipLoss as JaxMembership
from siss_tpu.metrics.inception_score import inception_score_from_logits as jax_is
from siss_tpu.models import resnet as jax_resnet
from siss_tpu_torch.data import ArrayDataset
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.metrics import (Classifier, InceptionScore, MembershipLoss,
                                    inception_score_from_logits)
from siss_tpu_torch.models.resnet import BatchNorm2d, ResNet, load_torch_resnet, resnet18


def randomize_running_stats(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)


def to_flax(model, fmodel):
    """The port module's weights as flax variables, by the JAX importer."""
    return jax_resnet.load_torch_resnet(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, fmodel)


def images(n, hw=28, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, hw, hw, 1)).astype(np.float32)


def test_resnet18_forward_matches_flax():
    torch.manual_seed(0)
    model = resnet18(num_classes=11, grayscale=True).eval()
    randomize_running_stats(model)
    fmodel = jax_resnet.resnet18(num_classes=11, grayscale=True)
    x = images(3)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    want = jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(to_flax(model, fmodel),
                                                                   jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_load_torch_resnet_matches_jax_import():
    """The reference's layout (7×7 stem + max-pool, torchvision names, as in
    tests/test_resnet_import.py) loads straight into the port's module and
    gives the torch model's and the JAX import's logits."""
    torch.manual_seed(0)
    tmodel = TorchResNet18().eval()
    randomize_running_stats(tmodel, seed=1)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    model = load_torch_resnet(sd, ResNet((2, 2, 2, 2), num_classes=10, grayscale=True,
                                         small_input=False)).eval()
    fmodel = jax_resnet.ResNet(stage_sizes=(2, 2, 2, 2), num_classes=10, grayscale=True,
                               small_input=False)
    x = images(2, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, ref = model(xt).numpy(), tmodel(xt).numpy()
    want = jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(
        jax_resnet.load_torch_resnet(sd, fmodel), jnp.asarray(x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError):   # a 10-class state dict does not fit 11 classes
        load_torch_resnet(sd, ResNet((2, 2, 2, 2), num_classes=11, grayscale=True,
                                     small_input=False))


def test_batchnorm_running_stats_match_flax_after_two_steps():
    """Two SGD steps in train mode at batch 3 on 8×8 images: the last stage
    is 1×1, so each of its BatchNorms sees n = 3 values per channel, where
    the unbiased variance torch's BatchNorm2d keeps is 1.5 times the biased
    one flax keeps. The port keeps flax's statistics (and params)."""
    kw = dict(stage_sizes=(1, 1, 1, 1), num_classes=5, num_filters=8, grayscale=True)
    torch.manual_seed(0)
    model = ResNet(**kw).train()
    fmodel = jax_resnet.ResNet(**kw)
    variables = to_flax(model, fmodel)
    tx = optax.sgd(0.01)
    opt_state = tx.init(variables["params"])
    opt = torch.optim.SGD(model.parameters(), lr=0.01)

    @jax.jit
    def grad_fn(params, bstats, x, y):
        def loss_fn(params):
            logits, mutated = fmodel.apply({"params": params, "batch_stats": bstats}, x,
                                           train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), mutated

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    for step in range(2):
        x = images(3, hw=8, seed=10 + step)
        y = (np.arange(3) + step) % 5
        (_, mutated), grads = grad_fn(variables["params"], variables["batch_stats"],
                                      jnp.asarray(x), jnp.asarray(y))
        updates, opt_state = tx.update(grads, opt_state)
        variables = {"params": optax.apply_updates(variables["params"], updates),
                     "batch_stats": mutated["batch_stats"]}
        loss = F.cross_entropy(model(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               torch.from_numpy(y))
        opt.zero_grad()
        loss.backward()
        opt.step()
    got = to_flax(model, fmodel)
    for col, rtol, atol in (("batch_stats", 1e-4, 1e-6), ("params", 1e-3, 2e-5)):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got[col])[0],
                                jax.tree.leaves(variables[col])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))
    # torch's own BatchNorm2d would keep the unbiased variance, 1.5 times larger
    bn = model.layer4[0].bn2
    assert isinstance(bn, BatchNorm2d)
    plain = torch.nn.BatchNorm2d(bn.num_features, momentum=0.01).train()
    h = torch.randn(3, bn.num_features, 1, 1)
    plain(h)
    bn.running_var.fill_(1.0)
    bn(h)
    torch.testing.assert_close(plain.running_var - 0.99, 1.5 * (bn.running_var - 0.99))


def test_classifier_matches_jax():
    torch.manual_seed(1)
    model = resnet18(num_classes=11, grayscale=True).eval()
    randomize_running_stats(model, seed=2)
    fmodel = jax_resnet.resnet18(num_classes=11, grayscale=True)
    x = images(5, seed=4)
    ours = Classifier(model, batch_size=2)
    theirs = JaxClassifier(lambda p, v: fmodel.apply(p, v, train=False), to_flax(model, fmodel),
                           batch_size=2)
    np.testing.assert_allclose(ours.compute_logits(x), theirs.compute_logits(x), rtol=1e-4,
                               atol=1e-5)
    top = int(theirs.compute_logits(x).argmax(-1)[0])
    assert ours.compute_class_frequency(x, top) == theirs.compute_class_frequency(x, top)


@pytest.mark.parametrize("n,splits", [(20, 10), (23, 9), (7, 3)])
def test_inception_score_from_logits_matches_jax(n, splits):
    logits = np.random.default_rng(n).normal(0, 2, (n, 11)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    mean, std = inception_score_from_logits(
        torch.from_numpy(logits), splits, perm=torch.from_numpy(np.array(jax.random.permutation(key, n))))
    jmean, jstd = jax_is(jnp.asarray(logits), splits, key)
    np.testing.assert_allclose(float(mean), float(jmean), rtol=1e-5)
    np.testing.assert_allclose(float(std), float(jstd), rtol=1e-5)


class FixedLogits:
    """A classifier whose logits are given per image index (image = its index)."""

    def __init__(self, logits):
        self.logits = logits

    def compute_logits(self, imgs):
        return self.logits[np.asarray(imgs, np.int64).reshape(-1)]


@pytest.mark.parametrize("remove_class", [10, None])
def test_inception_score_remove_class_matches_jax(remove_class):
    """remove_class drops the rows predicted as it and its column, and uses
    one split fewer."""
    logits = np.random.default_rng(5).normal(0, 2, (40, 11)).astype(np.float32)
    logits[::4, 10] += 10.0   # a quarter of the images (and some others) look like t-shirts
    ours = InceptionScore(FixedLogits(logits), splits=10, remove_class=remove_class)
    theirs = JaxInceptionScore(FixedLogits(logits), splits=10, remove_class=remove_class)
    for part in (np.arange(0, 25), np.arange(25, 40)):
        ours.update(part)
        theirs.update(part)
    n_kept = sum(len(v) for v in theirs.logits)
    assert n_kept == (int((logits.argmax(-1) != 10).sum()) if remove_class == 10 else 40)
    assert ours.splits == theirs.splits == (9 if remove_class == 10 else 10)
    key = jax.random.PRNGKey(9)
    mean, std = ours.compute(perm=torch.from_numpy(np.array(jax.random.permutation(key, n_kept))))
    jmean, jstd = theirs.compute(key)
    np.testing.assert_allclose([mean, std], [jmean, jstd], rtol=1e-5)
    assert ours.logits == []


def test_membership_loss_matches_jax():
    """N = 5 images × M = 3 noises in chunks of 4 (the last one short), at
    two timesteps, on keep and forget sets, one of which holds a single
    image (every row is that image, as in the JAX package)."""
    rng = np.random.default_rng(0)
    keep = ArrayDataset(rng.uniform(-1, 1, (9, 6, 6, 1)).astype(np.float32))
    forget = ArrayDataset(rng.uniform(-1, 1, (1, 6, 6, 1)).astype(np.float32))
    params = tiny_params(2, channels=1)
    jm = JaxMembership(lambda p, x, t, c: jax_tiny_apply(p, x, t), JaxSchedule.create(1000),
                       keep, forget, 5, 3, eval_batch_size=4, seed=7)
    jm.sample_images()
    jm.sample_noises(jax.random.PRNGKey(7))
    ours = MembershipLoss(tiny_apply, NoiseSchedule.create(1000, device="cpu"), keep, forget,
                          5, 3, eval_batch_size=4, seed=7)
    ours.sample_images()
    ours.sample_noises(noise=np.array(jm.noise))
    np.testing.assert_array_equal(ours.all_images, jm.all_images)
    np.testing.assert_array_equal(ours.del_images, jm.del_images)
    got = ours.compute_membership_losses(TinyEps(params), [10, 500])
    want = jm.compute_membership_losses(jax.tree.map(jnp.asarray, params), [10, 500])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    # without injected noise the draw is seeded: the same seed, the same noise
    again = MembershipLoss(tiny_apply, NoiseSchedule.create(1000, device="cpu"), keep, forget,
                           5, 3, seed=7)
    again.sample_images()
    again.sample_noises()
    ours.sample_noises()
    assert torch.equal(again.noise, ours.noise) and again.noise.shape == (3, 6, 6, 1)
