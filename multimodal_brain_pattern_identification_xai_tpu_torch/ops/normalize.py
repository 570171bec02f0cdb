"""Normalization primitives (counterpart of the JAX package's
``ops/normalize.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch


def zscore(x: torch.Tensor, axis: int = -1, eps: float = 1e-6
           ) -> torch.Tensor:
    """Per-lane ``(x - mean) / (std + eps)`` along ``axis`` with the
    population std (``correction=0``, as ``jnp.std`` and ``np.std``;
    torch's default std is the unbiased one)."""
    mean = x.mean(dim=axis, keepdim=True)
    std = x.std(dim=axis, keepdim=True, correction=0)
    return (x - mean) / (std + eps)


def minmax(x: torch.Tensor, axis: Optional[Union[int, Sequence[int]]] = None,
           eps: float = 1e-6) -> torch.Tensor:
    """Scale to [0, 1]: ``(x - min) / (max - min + eps)`` over ``axis``
    (None: the whole tensor).  NaNs must already be repaired."""
    if axis is None:
        mn, mx = x.amin(), x.amax()
    else:
        mn = x.amin(dim=axis, keepdim=True)
        mx = x.amax(dim=axis, keepdim=True)
    return (x - mn) / (mx - mn + eps)


def clip_scale(x: torch.Tensor, clip: float = 1024.0,
               scale: float = 32.0) -> torch.Tensor:
    """``clip(x, ±clip)``, NaN → 0, then ``x / scale``."""
    return torch.nan_to_num(x.clamp(-clip, clip), nan=0.0) / scale


def mu_law_encode(x: torch.Tensor, mu: float = 1.0) -> torch.Tensor:
    """Mu-law companding: ``sign(x) · log1p(mu |x|) / log1p(mu)``."""
    return torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)


def baseline_correction(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Subtract the mean along ``axis`` (the column mean of a plane)."""
    return x - x.mean(dim=axis, keepdim=True)
