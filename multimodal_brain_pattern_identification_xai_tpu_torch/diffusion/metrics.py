"""Generation-quality metrics (counterpart of the JAX package's
``diffusion/metrics.py``): Gaussian-kernel MMD, the Fréchet distance
between Gaussian fits and the mean per-sample Pearson correlation, as
tensor programs on the inputs' device (0-d results).

The Fréchet distance takes the square root of the symmetrised product,
``tr√(Σ₁Σ₂) = tr√(√Σ₁ Σ₂ √Σ₁)``, so every decomposition is of a
symmetric PSD matrix (``eigh``); for wide features it takes the nuclear
norm identity instead (:func:`compute_frechet_distance`).  On the card the
products follow ``torch.backends.cuda.matmul.allow_tf32`` (off by
default); the JAX package runs them in full float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def compute_mmd(real: torch.Tensor, generated: torch.Tensor,
                kernel_bandwidth: float = 1.0) -> torch.Tensor:
    """Gaussian-kernel MMD."""
    x = _flatten(real)
    y = _flatten(generated)

    def k(a, b):
        an = (a * a).sum(-1, keepdim=True)
        bn = (b * b).sum(-1, keepdim=True)
        d = an + bn.T - 2.0 * (a @ b.T)
        return torch.exp(-d / (2.0 * kernel_bandwidth ** 2))

    return k(x, x).mean() + k(y, y).mean() - 2.0 * k(x, y).mean()


def _sqrtm_psd(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    w, v = torch.linalg.eigh(m)
    return (v * torch.sqrt(w.clamp_min(eps))) @ v.T


def compute_frechet_distance(real: torch.Tensor, generated: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """Fréchet distance between Gaussian fits of the flattened samples.

    When d > 512 and d > 4(n+m) (e.g. flattened (19, 2000) EEG, d =
    38,000) the covariances have rank ≤ n and the d×d matrices are out of
    reach; then, with centred A (n, d) and B (m, d) scaled by 1/√(n−1),
    the nonzero eigenvalues of ``cx·cy`` equal those of ``(ABᵀ)(ABᵀ)ᵀ``,
    so ``tr√(cx·cy)`` is the nuclear norm of ``ABᵀ`` (no ``eps`` ridge,
    which only steadies the dense path).  Otherwise the dense path with
    ``eps·I`` added to each covariance."""
    x = _flatten(real)
    y = _flatten(generated)
    n, d = x.shape
    m = y.shape[0]
    mu_x, mu_y = x.mean(0), y.mean(0)
    mean_diff = ((mu_x - mu_y) ** 2).sum()
    if d > 512 and d > 4 * (n + m):
        a = (x - mu_x) / np.sqrt(max(n - 1, 1))
        b = (y - mu_y) / np.sqrt(max(m - 1, 1))
        nuc = torch.linalg.svdvals(a @ b.T).sum()
        return mean_diff + (a * a).sum() + (b * b).sum() - 2.0 * nuc
    eye = eps * torch.eye(d, dtype=x.dtype, device=x.device)
    cx = torch.cov(x.T) + eye
    cy = torch.cov(y.T) + eye
    sx = _sqrtm_psd(cx)
    cov_sqrt = _sqrtm_psd(sx @ cy @ sx)
    return mean_diff + torch.trace(cx + cy) - 2.0 * torch.trace(cov_sqrt)


def pearson_correlation(real: torch.Tensor, generated: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """Mean per-sample Pearson correlation."""
    x = _flatten(real)
    y = _flatten(generated)
    xc = x - x.mean(1, keepdim=True)
    yc = y - y.mean(1, keepdim=True)
    num = (xc * yc).sum(1)
    den = torch.sqrt((xc * xc).sum(1) * (yc * yc).sum(1))
    return (num / (den + eps)).mean()
