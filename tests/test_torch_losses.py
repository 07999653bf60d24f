"""The port's six unlearning objectives (siss_tpu_torch.losses.deletion)
against siss_tpu.losses.deletion on the same inputs and the same draws.

Each JAX method draws from its key; the port takes that draw as a tensor
(u [B] for the two mixtures, the uniform forget target for EraseDiff),
made here from the same key as the JAX method makes it. The ε model is a
small two-convolution net with a timestep table (torch_parity.TinyEps),
the same function in both packages. All seven output fields are compared: None in
the same places, values at rtol 1e-5 / atol 1e-6, the importance weights at
rtol 1e-4 / atol 1e-6 (exp of a difference of two float32 sums, summed in
another order).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TinyEps, jax_tiny_apply, tiny_params
from siss_tpu.diffusion import NoiseSchedule as JaxSchedule
from siss_tpu.losses.deletion import DeletionLoss as JaxLoss
from siss_tpu.losses.deletion import LOSS_FUNCTIONS as JAX_LOSS_FUNCTIONS
from siss_tpu.losses.deletion import SCALAR_PATH_LOSSES as JAX_SCALAR
from siss_tpu.losses.deletion import SHARED_FORWARD_LOSSES as JAX_SHARED
from siss_tpu_torch.diffusion import NoiseSchedule
from siss_tpu_torch.losses import (
    LOSS_FUNCTIONS,
    SCALAR_PATH_LOSSES,
    SHARED_FORWARD_LOSSES,
    DeletionLoss,
    DeletionLossOutputs,
)

B, HW, C, T = 4, 6, 2, 1000
PARAMS = {"lambd": 0.5, "superfactor": 0.7}


def loss_draw(name, key, shape):
    """The JAX method's own draw from its key, as a tensor (or None)."""
    if name in ("importance_sampling_with_mixture", "subscore_bernoulli"):
        return torch.from_numpy(np.array(jax.random.uniform(key, shape[:1])))
    if name == "erasediff":
        return torch.from_numpy(np.array(jax.random.uniform(key, shape, dtype=jnp.float32)))
    return None


def test_loss_tables_match_jax():
    assert LOSS_FUNCTIONS == JAX_LOSS_FUNCTIONS
    assert SCALAR_PATH_LOSSES == JAX_SCALAR and SHARED_FORWARD_LOSSES == JAX_SHARED
    assert DeletionLossOutputs._fields == (
        "loss", "loss_x", "loss_a", "importance_weight_x", "importance_weight_a",
        "weighted_loss_x", "weighted_loss_a")


# Every method with float parameters; those with a parameter also with it
# as a 0-d tensor (a per-microbatch value of the step's [A] scalars).
CASES = [(name, "float") for name in LOSS_FUNCTIONS] + [
    (name, "tensor") for name in ("importance_sampling_with_mixture", "subscore_bernoulli",
                                  "simple_neg_del")]


@pytest.mark.parametrize("name,lambd_kind", CASES)
def test_loss_method_matches_jax(name, lambd_kind):
    rng = np.random.default_rng(7)
    shape = (B, HW, HW, C)
    keep, forget, noise = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    t = rng.integers(0, T, (B,))
    params = tiny_params()
    jsched = JaxSchedule.create(T, "linear")
    sched = NoiseSchedule.create(T, "linear", device="cpu")

    def samples(q, og):
        return {"og_latents": og, "noisy_latents": q(og)}

    jq = lambda x0: jsched.gamma[t][:, None, None, None] * x0 + jsched.sigma[t][:, None, None, None] * noise  # noqa: E731
    tt = torch.from_numpy(t)
    tq = lambda x0: sched.gamma[tt][:, None, None, None] * x0 + sched.sigma[tt][:, None, None, None] * torch.from_numpy(noise)  # noqa: E731
    accepted = inspect.signature(getattr(DeletionLoss, name)).parameters
    kw = {k: v for k, v in PARAMS.items() if k in accepted}
    key = jax.random.PRNGKey(3)
    jout = getattr(JaxLoss(jsched.gamma, jsched.sigma), name)(
        lambda x, ts, c: jax_tiny_apply(params, x, ts), key, jnp.asarray(t), jnp.asarray(noise),
        None, samples(jq, jnp.asarray(keep)), samples(jq, jnp.asarray(forget)), **kw)
    if lambd_kind == "tensor":
        kw = {k: torch.tensor(v) for k, v in kw.items()}
    model = TinyEps(params)
    out = getattr(DeletionLoss(sched.gamma, sched.sigma), name)(
        lambda x, ts, c: model(x, ts), loss_draw(name, key, shape), tt, torch.from_numpy(noise),
        None, samples(tq, torch.from_numpy(keep)), samples(tq, torch.from_numpy(forget)), **kw)
    assert isinstance(out, DeletionLossOutputs)
    for field, got, want in zip(out._fields, out, jout):
        assert (got is None) == (want is None), field
        if got is not None:
            iw = field.startswith("importance")
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-4 if iw else 1e-5, atol=1e-6, err_msg=field)
