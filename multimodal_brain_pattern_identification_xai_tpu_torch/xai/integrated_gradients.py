"""Integrated Gradients (counterpart of the JAX package's
``xai/integrated_gradients.py``).  The interpolation points are a batch
axis: ``chunk`` points at a time run as one batch of ``chunk × B``.
Span (:mod:`..profiling`): ``mbx.xai.ig``."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import profiling
from .saliency import _argmax


def _chunk_size(total: int, chunk: Optional[int], what: str) -> int:
    """``chunk`` points per batch: all of them for ``None`` (or a chunk at
    least ``total``); otherwise ``chunk`` must divide ``total``."""
    if chunk is None or chunk >= total:
        return total
    if total % chunk:
        raise ValueError(f"chunk={chunk} must divide {what}={total}")
    return chunk


def _input_grad(forward: Callable, points: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """∂ Σ logit_target / ∂points for a batch of ``c × B`` points (sample
    ``i`` of every group of B takes ``target[i]``)."""
    pts = points.detach().requires_grad_(True)
    tgt = target.repeat(len(pts) // len(target))
    g, = torch.autograd.grad(
        forward(pts).gather(-1, tgt[:, None]).sum(), pts)
    return g


def integrated_gradients(forward: Callable[[torch.Tensor], torch.Tensor],
                         x: torch.Tensor,
                         baseline: Optional[torch.Tensor] = None,
                         target: Optional[torch.Tensor] = None,
                         steps: int = 50,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """IG(x) = (x − x₀) · ∫₀¹ ∂f(x₀ + α(x − x₀))/∂x dα (Riemann midpoint,
    α = (k + ½) / steps).

    Args:
        forward: ``(B, ...) → (B, C)`` logits.
        baseline: same shape as ``x``; zeros by default.
        target: (B,) class indices; default the argmax at ``x``.
        chunk: interpolation points per batch (the network sees ``chunk ×
            B`` samples at once); must divide ``steps``.  ``None`` runs all
            steps in one batch.  The result is the same up to float32
            summation order.
    """
    c = _chunk_size(steps, chunk, "steps")
    with profiling.span("mbx.xai.ig"):
        if baseline is None:
            baseline = torch.zeros_like(x)
        if target is None:
            target = _argmax(forward, x)
        alphas = (torch.arange(steps, dtype=x.dtype, device=x.device)
                  + 0.5) / steps
        delta = x - baseline
        tail = (1,) * x.dim()
        acc = torch.zeros_like(x)
        for a in alphas.split(c):
            points = baseline + a.view(-1, *tail) * delta     # (c, B, ...)
            g = _input_grad(forward, points.flatten(0, 1), target)
            acc += g.view(len(a), *x.shape).sum(0)
        return delta * (acc / steps)
