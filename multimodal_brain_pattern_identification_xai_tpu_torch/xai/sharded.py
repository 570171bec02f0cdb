"""Attribution with the explained samples split over the ranks
(counterpart of the JAX package's ``xai/sharded.py``).

Integrated and expected gradients are independent a sample: each rank of
the mesh's ``data`` group explains its contiguous part of the batch (B
must divide over the group), and the parts are all-gathered in rank
order, so every rank returns the whole result.  The Monte-Carlo draws of
expected gradients are the unsharded function's: every rank draws the
whole (nsamples, B) from its generator (seeded alike on every rank) and
keeps its own columns, so the sharded result is the unsharded one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import data_slice, gather_data
from .expected_gradients import expected_gradients_from_draws, sample_draws
from .integrated_gradients import integrated_gradients


def sharded_integrated_gradients(mesh, forward: Callable[[torch.Tensor],
                                                         torch.Tensor],
                                 x: torch.Tensor,
                                 baseline: Optional[torch.Tensor] = None,
                                 target: Optional[torch.Tensor] = None,
                                 steps: int = 50,
                                 chunk: Optional[int] = None
                                 ) -> torch.Tensor:
    """Integrated gradients (B, ...) of ``x`` (B, ...) with the samples
    split over the ``data`` group; ``target`` defaults to the argmax of
    each sample's logits (computed on the rank that explains it)."""
    sl = data_slice(mesh, x.shape[0])
    local = integrated_gradients(
        forward, x[sl], None if baseline is None else baseline[sl],
        None if target is None else target[sl], steps, chunk)
    return gather_data(local, mesh, 0)


def sharded_expected_gradients(mesh, forward: Callable[[torch.Tensor],
                                                       torch.Tensor],
                               x: torch.Tensor, background: torch.Tensor,
                               generator: Optional[torch.Generator],
                               target: torch.Tensor, nsamples: int = 200,
                               chunk: Optional[int] = None) -> torch.Tensor:
    """Expected gradients with the samples split over ``data`` and the
    background whole on every rank (each sample draws against all of
    it, like shap's ``GradientExplainer``)."""
    sl = data_slice(mesh, x.shape[0])
    bg_idx, alphas = sample_draws(nsamples, x.shape[0], background.shape[0],
                                  generator)
    local = expected_gradients_from_draws(forward, x[sl], background,
                                          target[sl], bg_idx[:, sl],
                                          alphas[:, sl], chunk)
    return gather_data(local, mesh, 0)


def sharded_gradient_shap_values(mesh, forward: Callable[[torch.Tensor],
                                                         torch.Tensor],
                                 x: torch.Tensor, background: torch.Tensor,
                                 generator: Optional[torch.Generator],
                                 n_classes: int = 6, nsamples: int = 200,
                                 chunk: Optional[int] = None
                                 ) -> torch.Tensor:
    """Per-class SHAP values (n_classes, B, ...) like
    ``gradient_shap_values``, the samples split over ``data``: each class
    takes its whole draws from ``generator`` in class order, each rank
    its own columns."""
    sl = data_slice(mesh, x.shape[0])
    out = []
    for c in range(n_classes):
        bg_idx, alphas = sample_draws(nsamples, x.shape[0],
                                      background.shape[0], generator)
        tgt = torch.full((sl.stop - sl.start,), c, device=x.device)
        out.append(expected_gradients_from_draws(
            forward, x[sl], background, tgt, bg_idx[:, sl], alphas[:, sl],
            chunk))
    return gather_data(torch.stack(out), mesh, 1)
