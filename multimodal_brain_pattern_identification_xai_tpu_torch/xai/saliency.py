"""Vanilla gradient saliency (counterpart of the JAX package's
``xai/saliency.py``): one backward per batch; the multimodal form takes
the gradients of both inputs in one backward.  Spans (:mod:`..profiling`):
``mbx.xai.saliency`` with the child ``mbx.xai.saliency.backward``
(counter ``xai.saliency.requests``)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import profiling


def _select(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample scalar: the ``target`` class's logit."""
    return logits.gather(-1, target[:, None])[:, 0]


def _argmax(forward: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """The default target: the argmax of a forward with no gradient."""
    with torch.no_grad():
        return forward(*xs).argmax(-1)


def saliency_maps(forward: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor,
                  target: Optional[torch.Tensor] = None,
                  absolute: bool = True) -> torch.Tensor:
    """|∂ logit_target / ∂x| for a whole batch.

    Args:
        forward: ``x → logits`` (the model with its weights).
        target: optional (B,) class indices; default the per-sample argmax.
    """
    if target is None:
        target = _argmax(forward, x)
    xx = x.detach().requires_grad_(True)
    g, = torch.autograd.grad(_select(forward(xx), target).sum(), xx)
    return g.abs() if absolute else g


def multimodal_saliency(forward: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                        eeg: torch.Tensor, spec: torch.Tensor,
                        target: Optional[torch.Tensor] = None,
                        absolute: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Saliency of both branches in one backward pass."""
    with profiling.span("mbx.xai.saliency"):
        profiling.count("xai.saliency.requests")
        if target is None:
            target = _argmax(forward, eeg, spec)
        e = eeg.detach().requires_grad_(True)
        s = spec.detach().requires_grad_(True)
        score = _select(forward(e, s), target).sum()
        # the backward's kernels run on this stream, so this thread's span
        # times them on the device (autograd launches them from its own
        # thread)
        with profiling.span("mbx.xai.saliency.backward", device=True):
            ge, gs = torch.autograd.grad(score, (e, s))
        if absolute:
            ge, gs = ge.abs(), gs.abs()
        return ge, gs
