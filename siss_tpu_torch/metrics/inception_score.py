"""Inception Score over a classifier's logits, with ``remove_class``: port
of ``siss_tpu/metrics/inception_score.py``.

Images whose argmax is the removed class are dropped and that column is
removed, so MNIST sample quality is scored while the t-shirt (class 10) is
being unlearned; one split fewer is used then. Splits follow
``torch.chunk``'s sizes and the std is the sample std (ddof 1).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def inception_score_from_logits(logits: torch.Tensor, splits: int = 10,
                                generator: Optional[torch.Generator] = None,
                                perm: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp(E KL(p(y|x) ‖ p(y))) per split → (mean, std). The rows are first
    permuted by ``perm``, or by a permutation drawn from ``generator``; with
    neither they keep their order."""
    n = logits.shape[0]
    if perm is None and generator is not None:
        perm = torch.randperm(n, generator=generator, device=generator.device)
    if perm is not None:
        logits = logits[torch.as_tensor(perm, device=logits.device)]
    prob = torch.softmax(logits, dim=1)
    log_prob = torch.log_softmax(logits, dim=1)
    scores = []
    for p, lp in zip(prob.chunk(splits), log_prob.chunk(splits)):
        mean_p = p.mean(dim=0, keepdim=True)
        scores.append(torch.exp((p * (lp - torch.log(mean_p))).sum(dim=1).mean()))
    kl = torch.stack(scores)
    std = kl.std(correction=1) if len(scores) > 1 else torch.zeros(())
    return kl.mean(), std


class InceptionScore:
    """Stateful accumulator (update/compute), as the reference's class."""

    def __init__(self, classifier, splits: int = 10, remove_class: Optional[int] = None):
        self.splits = splits if remove_class is None else splits - 1
        self.remove_class = remove_class
        self.classifier = classifier
        self.logits: List[np.ndarray] = []

    def update(self, imgs) -> None:
        """imgs: [N, H, W, C] float in [0, 1]."""
        logits = np.asarray(self.classifier.compute_logits(imgs))
        if self.remove_class is not None:
            logits = logits[logits.argmax(-1) != self.remove_class]
            logits = logits[:, np.arange(logits.shape[-1]) != self.remove_class]
        self.logits.append(logits)

    def compute(self, generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> Tuple[float, float]:
        """(mean, std) over the images since the last compute. Without a
        generator or a permutation the rows are shuffled by an unseeded
        draw, as the JAX package's are."""
        logits = torch.from_numpy(np.concatenate(self.logits, axis=0))
        if generator is None and perm is None:
            generator = torch.Generator().manual_seed(int(np.random.randint(2 ** 31)))
        mean, std = inception_score_from_logits(logits, self.splits, generator, perm)
        self.logits = []
        return float(mean), float(std)
