"""Normalization primitives (counterpart of the JAX package's
``ops/normalize.py``)."""

from __future__ import annotations

import torch


def zscore(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-lane ``(x - mean) / (std + eps)`` over the last axis with the
    population std (``correction=0``, as ``jnp.std`` and ``np.std``;
    torch's default std is the unbiased one)."""
    mean = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mean) / (std + eps)
