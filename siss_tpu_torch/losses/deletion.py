"""The six data-unlearning objectives: port of ``siss_tpu/losses/deletion.py``.

SISS (the importance-sampled defensive mixture), SISS without importance
sampling (two forwards), EraseDiff, NegGrad (``simple_neg_del``), naive
deletion and the subscore Bernoulli mixture. Every method returns the same
7-field ``DeletionLossOutputs``; ``loss is None`` marks the two-gradient
surgery path.

Each method takes its random draw as a tensor, in the place of the JAX
method's PRNG key: ``u`` [B] ~ U[0, 1) for the two mixtures (a row keeps
its keep-set latent when u > λ), the uniform forget target [B, ...] for
EraseDiff, and ``None`` for the others. ``subscore_bernoulli`` masks with
``where``, so masked rows contribute exact zeros and the ``sum()/B``
normalisation is the JAX package's. The importance weights are formed in
float32 as exp(−logaddexp(…)), which cannot overflow.

The model enters through ``eps_fn(noisy_latents, timesteps, cond) -> eps``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


class DeletionLossOutputs(NamedTuple):
    loss: Optional[torch.Tensor]                 # scalar-path per-pixel loss, or None
    loss_x: Optional[torch.Tensor]               # keep-term per-pixel loss
    loss_a: Optional[torch.Tensor]               # forget-term per-pixel loss
    importance_weight_x: Optional[torch.Tensor]  # [B]
    importance_weight_a: Optional[torch.Tensor]  # [B]
    weighted_loss_x: Optional[torch.Tensor]      # per-pixel, feeds the surgery
    weighted_loss_a: Optional[torch.Tensor]      # per-pixel, feeds the surgery


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def _log_lambda(lambd, like: torch.Tensor):
    """(log λ, log(1 − λ)) in float32, shaped and placed like ``like``; λ is
    a float or a 0-d tensor (a per-microbatch value)."""
    if not isinstance(lambd, torch.Tensor):
        return (torch.full_like(like, math.log(lambd)), torch.full_like(like, math.log1p(-lambd)))
    lam = lambd.to(like.device, torch.float32)
    return torch.log(lam).expand_as(like), torch.log1p(-lam).expand_as(like)


def _mixture(u: torch.Tensor, lambd, all_samples, deletion_samples):
    """(keep mask [B], mixed latents): a row keeps its keep-set latent with
    probability 1 − λ."""
    batch = all_samples["noisy_latents"]
    all_mask = u > lambd
    return all_mask, torch.where(_bcast(all_mask, batch), batch,
                                 deletion_samples["noisy_latents"])


@dataclasses.dataclass(frozen=True)
class DeletionLoss:
    """Holds the γ = √ᾱ and σ = √(1 − ᾱ) tables [T]."""

    gamma: torch.Tensor
    sigma: torch.Tensor

    def importance_sampling_with_mixture(self, eps_fn: EpsFn, u: torch.Tensor,
                                         timesteps: torch.Tensor, noise: torch.Tensor,
                                         conditioning: Any, all_samples: Dict[str, torch.Tensor],
                                         deletion_samples: Dict[str, torch.Tensor], *,
                                         lambd) -> DeletionLossOutputs:
        """SISS: one forward on the Bernoulli(λ) mixture, importance-weighted
        keep and forget ε-MSE terms."""
        gamma = self.gamma[timesteps]
        sigma = self.sigma[timesteps]
        _, mix = _mixture(u, lambd, all_samples, deletion_samples)
        preds = eps_fn(mix, timesteps, conditioning)

        g, s = _bcast(gamma, mix), _bcast(sigma, mix)
        resid_x = mix - g * all_samples["og_latents"]
        resid_a = mix - g * deletion_samples["og_latents"]
        loss_x = (preds - resid_x / s) ** 2
        loss_a = (preds - resid_a / s) ** 2

        # Squared distances in float32 over the non-batch dims.
        dims = tuple(range(1, mix.ndim))
        two_var = 2.0 * sigma.float() ** 2
        dist_x = (resid_x.float() ** 2).sum(dims) / two_var
        dist_a = (resid_a.float() ** 2).sum(dims) / two_var
        # iw_x = 1/((1−λ) + λe^{dx−da}), iw_a = 1/((1−λ)e^{da−dx} + λ)
        d = dist_x - dist_a
        log_l, log_1ml = _log_lambda(lambd, d)
        iw_x = torch.exp(-torch.logaddexp(log_1ml, log_l + d))
        iw_a = torch.exp(-torch.logaddexp(log_1ml - d, log_l))

        weighted_loss_x = _bcast(iw_x, loss_x).to(loss_x.dtype) * loss_x
        weighted_loss_a = _bcast(iw_a, loss_a).to(loss_a.dtype) * loss_a
        return DeletionLossOutputs(None, loss_x, loss_a, iw_x, iw_a, weighted_loss_x,
                                   weighted_loss_a)

    def double_forward_with_neg_del(self, eps_fn, draw, timesteps, noise, conditioning,
                                    all_samples, deletion_samples) -> DeletionLossOutputs:
        """Two forwards, plain ε-MSE against the shared noise."""
        loss_x = (eps_fn(all_samples["noisy_latents"], timesteps, conditioning) - noise) ** 2
        loss_a = (eps_fn(deletion_samples["noisy_latents"], timesteps, conditioning) - noise) ** 2
        return DeletionLossOutputs(None, loss_x, loss_a, None, None, loss_x, loss_a)

    def erasediff(self, eps_fn, uniform, timesteps, noise, conditioning, all_samples,
                  deletion_samples) -> DeletionLossOutputs:
        """Keep-term ε-MSE; the forget term's target is ``uniform``, a U[0, 1)
        draw of the noise's shape."""
        loss_x = (eps_fn(all_samples["noisy_latents"], timesteps, conditioning) - noise) ** 2
        preds_a = eps_fn(deletion_samples["noisy_latents"], timesteps, conditioning)
        loss_a = (preds_a - uniform) ** 2
        return DeletionLossOutputs(None, loss_x, loss_a, None, None, loss_x, loss_a)

    def simple_neg_del(self, eps_fn, draw, timesteps, noise, conditioning, all_samples,
                       deletion_samples, *, superfactor) -> DeletionLossOutputs:
        """Scalar path: loss = −superfactor · ε-MSE on the forget batch."""
        loss_a = (eps_fn(deletion_samples["noisy_latents"], timesteps, conditioning) - noise) ** 2
        return DeletionLossOutputs(-superfactor * loss_a, None, loss_a, None, None, None, None)

    def naive_del(self, eps_fn, draw, timesteps, noise, conditioning, all_samples,
                  deletion_samples) -> DeletionLossOutputs:
        """Scalar path: plain fine-tuning on the keep set."""
        loss_x = (eps_fn(all_samples["noisy_latents"], timesteps, conditioning) - noise) ** 2
        return DeletionLossOutputs(loss_x, loss_x, None, None, None, None, None)

    def subscore_bernoulli(self, eps_fn, u, timesteps, noise, conditioning, all_samples,
                           deletion_samples, *, lambd) -> DeletionLossOutputs:
        """The Bernoulli mixture without importance weights; the keep term is
        scaled by 1/(1 − λ)."""
        all_mask, mix = _mixture(u, lambd, all_samples, deletion_samples)
        loss = (eps_fn(mix, timesteps, conditioning) - noise) ** 2
        mask_x = _bcast(all_mask, loss).to(loss.dtype)
        loss_x = (1.0 / (1.0 - lambd)) * loss * mask_x
        loss_a = loss * (1.0 - mask_x)
        return DeletionLossOutputs(None, loss_x, loss_a, None, None, loss_x, loss_a)


#: loss_fn → one shared forward for both terms (one graph, two pulls).
SHARED_FORWARD_LOSSES = frozenset({"importance_sampling_with_mixture", "subscore_bernoulli"})

#: loss_fn → the scalar path (one gradient, no surgery).
SCALAR_PATH_LOSSES = frozenset({"simple_neg_del", "naive_del"})

#: loss_fn → the name of its draw in ``draw_microbatch_randomness``'s dict.
LOSS_DRAWS = {"importance_sampling_with_mixture": "u", "subscore_bernoulli": "u",
              "erasediff": "uniform"}

LOSS_FUNCTIONS = (
    "importance_sampling_with_mixture",
    "double_forward_with_neg_del",
    "erasediff",
    "simple_neg_del",
    "naive_del",
    "subscore_bernoulli",
)

