"""Gaussian smoothing (counterpart of the JAX package's ``ops/smooth.py``):
``scipy.ndimage.gaussian_filter(sigma)`` over the last two axes, with
scipy's taps (truncation at 4σ, normalised) and its 'reflect' boundary,
which repeats the edge sample (numpy's 'symmetric'; torch's
``F.pad(mode="reflect")`` does not repeat it, so the padding here is built
from flipped edge slices).  Also the float64 axis-0 convolution that builds
the spectrogram chain's dense operators."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()


def _np_conv1d_symmetric(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Axis-0 1-D convolution with 'symmetric' padding (scipy 'reflect'
    semantics), float64."""
    r = len(kernel) // 2
    xp = np.pad(x, ((r, r), (0, 0)), mode="symmetric")
    return sum(kernel[i] * xp[i:i + x.shape[0]] for i in range(len(kernel)))


def _conv1d_reflect(x: torch.Tensor, kernel: np.ndarray,
                    axis: int) -> torch.Tensor:
    """1-D convolution of ``x`` along ``axis`` with scipy 'reflect'
    padding, as a sum of shifted slices in ``x``'s dtype."""
    r = len(kernel) // 2
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    xp = torch.cat([x[..., :r].flip(-1), x, x[..., n - r:].flip(-1)], dim=-1)
    y = sum(float(w) * xp[..., i:i + n] for i, w in enumerate(kernel))
    return y.movedim(-1, axis)


def gaussian_smooth2d(x: torch.Tensor, sigma: float = 1.0,
                      truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur over the last two axes. ``x``: (..., H, W)."""
    kernel = _gaussian_kernel1d(float(sigma), truncate)
    return _conv1d_reflect(_conv1d_reflect(x, kernel, -2), kernel, -1)
