"""Losses (counterpart of the JAX package's ``train/losses.py``): the
reference's ``KLDivWithLogitsLoss`` and the manual L2 term of its notebook
loops.

All losses take **soft vote-probability targets** (B, n_classes): the HMS
labels are normalised expert-vote distributions.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def kldiv_with_log_probs(log_probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    """KL(targets ‖ exp(log_probs)), 'batchmean': torch ``KLDivLoss(
    reduction='batchmean')`` with 0·log 0 := 0."""
    t = targets
    per = torch.where(t > 0, t * (torch.log(t.clamp_min(eps)) - log_probs),
                      0.0)
    return per.sum() / log_probs.shape[0]


def kldiv_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    """KL(targets ‖ softmax(logits)), 'batchmean'.  ``log_softmax`` is
    idempotent on log-probabilities, so the models that end in one take
    this loss too."""
    return kldiv_with_log_probs(F.log_softmax(logits, dim=-1), targets, eps)


def cross_entropy_with_logits(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """Soft-target cross-entropy (torch ``CrossEntropyLoss`` with
    probability targets)."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def l2_weights(model: nn.Module) -> list:
    """The tensors the L2 term covers: the ``weight`` of every ``nn.Conv2d``
    and ``nn.Linear`` (the flax ``kernel`` leaves; the attention's query,
    key and value and the fusion head's ``fc1``/``fc2`` included).  The
    BatchNorm affine, every bias and the buffers are left out; selected by
    module type, since BatchNorm's scale is a ``weight`` too.  A module
    with other kernels names them in ``l2_extra()`` (the packed attention
    kernel, the LSTM's kernels, the ViT's positional embedding: flax's
    ``kernel`` and ``embedding`` leaves)."""
    out = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            out.append(m.weight)
        if hasattr(m, "l2_extra"):
            out.extend(m.l2_extra())
    return out


def l2_regularization(model: nn.Module, lam: float) -> torch.Tensor:
    """Manual L2 penalty ``λ·Σ‖w‖²`` over :func:`l2_weights` (float32)."""
    weights = l2_weights(model)
    if lam == 0.0 or not weights:
        return torch.zeros(())
    total = torch.stack([w.float().pow(2).sum() for w in weights])
    return lam * total.sum()
