"""Gaussian smoothing helpers (counterpart of the JAX package's
``ops/smooth.py``): scipy ``gaussian_filter`` taps (truncation at 4σ,
normalised), and the float64 axis-0 convolution with 'reflect' boundary
that builds the spectrogram chain's dense operators."""

from __future__ import annotations

import functools

import numpy as np


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
