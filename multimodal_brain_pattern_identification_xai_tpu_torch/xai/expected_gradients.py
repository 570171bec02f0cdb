"""Expected gradients, the SHAP ``GradientExplainer`` estimator
(counterpart of the JAX package's ``xai/expected_gradients.py``)::

    φ(x) ≈ E_{b ~ background, α ~ U(0,1)} [ (x − b) · ∂f_c(b + α(x − b))/∂x ]

The Monte-Carlo draws come from an explicit ``torch.Generator``;
:func:`expected_gradients_from_draws` takes them ready-made, so a caller
can feed both packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .integrated_gradients import _chunk_size, _input_grad


def sample_draws(nsamples: int, batch: int, n_background: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bg_idx, alphas)``, both (nsamples, batch): background indices
    uniform in [0, n_background) and interpolation weights uniform in
    [0, 1), on the generator's device."""
    dev = generator.device if generator is not None else None
    bg_idx = torch.randint(0, n_background, (nsamples, batch),
                           generator=generator, device=dev)
    alphas = torch.rand((nsamples, batch), generator=generator, device=dev)
    return bg_idx, alphas


def expected_gradients_from_draws(forward: Callable[[torch.Tensor],
                                                    torch.Tensor],
                                  x: torch.Tensor, background: torch.Tensor,
                                  target: torch.Tensor,
                                  bg_idx: torch.Tensor, alphas: torch.Tensor,
                                  chunk: Optional[int] = None
                                  ) -> torch.Tensor:
    """Expected gradients of class ``target`` (B,) over the given draws
    ``bg_idx`` / ``alphas`` (nsamples, B).  ``chunk`` draws run at a time
    as one batch of ``chunk × B``; it must divide nsamples."""
    nsamples, B = bg_idx.shape
    c = _chunk_size(nsamples, chunk, "nsamples")
    bg_idx = bg_idx.to(x.device)
    alphas = alphas.to(device=x.device, dtype=x.dtype)
    tail = (1,) * (x.dim() - 1)
    acc = torch.zeros_like(x)
    for idx, al in zip(bg_idx.split(c), alphas.split(c)):
        b = background[idx]                                   # (c, B, ...)
        diff = x - b
        points = b + al.view(*al.shape, *tail) * diff
        g = _input_grad(forward, points.flatten(0, 1), target)
        acc += (diff * g.view_as(diff)).sum(0)
    return acc / nsamples


def expected_gradients(forward: Callable[[torch.Tensor], torch.Tensor],
                       x: torch.Tensor, background: torch.Tensor,
                       generator: Optional[torch.Generator],
                       target: torch.Tensor, nsamples: int = 200,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """Expected-gradients attribution (B, ...) of ``x`` (B, ...) for class
    ``target`` (B,) against ``background`` (N, ...), ``nsamples`` draws per
    sample (shap's default 200) taken from ``generator``."""
    bg_idx, alphas = sample_draws(nsamples, x.shape[0], background.shape[0],
                                  generator)
    return expected_gradients_from_draws(forward, x, background, target,
                                         bg_idx, alphas, chunk)


def gradient_shap_values(forward: Callable[[torch.Tensor], torch.Tensor],
                         x: torch.Tensor, background: torch.Tensor,
                         generator: Optional[torch.Generator],
                         n_classes: int = 6, nsamples: int = 200,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """Per-class SHAP values like ``GradientExplainer.shap_values``:
    (n_classes, B, ...), one attribution map per class, each from its own
    draws (taken from ``generator`` in class order)."""
    return torch.stack([
        expected_gradients(forward, x, background, generator,
                           torch.full((x.shape[0],), c, device=x.device),
                           nsamples, chunk)
        for c in range(n_classes)])
