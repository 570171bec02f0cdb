"""Grad-CAM on a model's ``features`` / ``head`` split (counterpart of the
JAX package's ``xai/gradcam.py``, which reaches the same feature map
through a flax perturbation): one forward to the feature map A, then the
gradient of the target log-probs through ``head(A)`` w.r.t. A."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _resize_bilinear(cam: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) → (B, *size), as ``jax.image.resize(method="bilinear")``:
    half-pixel centres, and a triangle filter widened on any axis that
    shrinks (``antialias=True``; it changes nothing on an axis that
    grows)."""
    return F.interpolate(cam[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def grad_cam(model: nn.Module, x: torch.Tensor,
             target: Optional[torch.Tensor] = None,
             upsample_to: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Grad-CAM heatmaps (B, H', W') for a batch, nonnegative and
    max-normalised per sample.

    Args:
        model: a module with ``features(x)`` → (B', C, H', W') and
            ``head(A)`` → log-probs (``EEGNetAttentionRegularized``,
            ``SpectrogramCNN``) or logits (``DilatedInceptionWaveNet``,
            whose map has B' = 8·B rows, one a montage channel).
        x: (B, ...) model input (NCHW).
        target: (B,) class indices; default the argmax.
        upsample_to: optional (H, W) bilinear resize of the cam.
    """
    with torch.no_grad():
        feat = model.features(x)
    a = feat.requires_grad_(True)
    logits = model.head(a)
    if target is None:
        target = logits.detach().argmax(-1)
    g, = torch.autograd.grad(logits.gather(-1, target[:, None]).sum(), a)
    weights = g.mean(dim=(2, 3), keepdim=True)               # (B, C, 1, 1)
    cam = torch.relu((weights * feat.detach()).sum(1))       # (B, H', W')
    if upsample_to is not None:
        cam = _resize_bilinear(cam, upsample_to)
    denom = cam.amax(dim=(1, 2), keepdim=True)
    return cam / denom.clamp_min(1e-12)
