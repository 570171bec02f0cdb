"""Attention rollout (counterpart of the JAX package's ``xai/rollout.py``):
rollout = ∏ over layers of normalize(α·A + (1 − α)·I), heads averaged
(Abnar & Zuidema 2020).

:func:`rollout_from_model` records the weights of every attention module
(:class:`..models.layers.Attention` and ``MultiheadSelfAttention``) in one
forward, in the order the layers run.  The JAX package's
``collect_attention_weights`` orders them by their module paths as
strings, which puts ``encoder_layer_10`` and ``_11`` between ``_1`` and
``_2`` in a model of more than ten layers; the port composes the layers in
order."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..models.layers import Attention, MultiheadSelfAttention


def attention_rollout(attn_weights: Sequence[torch.Tensor],
                      residual_alpha: float = 0.5) -> torch.Tensor:
    """Compose per-layer attention maps, first layer first, into
    token-level relevance.

    Args:
        attn_weights: (B, [H,] L, L) a layer (a head axis is averaged).
    Returns the (B, L, L) rollout matrix; row 0 (CLS) is the usual
    relevance.
    """
    rollout = None
    for a in attn_weights:
        if a.dim() == 4:
            a = a.mean(dim=1)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        a = residual_alpha * a + (1 - residual_alpha) * eye
        a = a / a.sum(dim=-1, keepdim=True)
        rollout = a if rollout is None else a @ rollout
    return rollout


def collect_attention_weights(model: nn.Module, *args) -> List[torch.Tensor]:
    """``model(*args)`` once, without gradients, keeping the weights each
    attention module returns, in call order."""
    weights: List[torch.Tensor] = []
    hooks = [m.register_forward_hook(
        lambda _m, _in, out: weights.append(out[1].detach()))
        for m in model.modules()
        if isinstance(m, (Attention, MultiheadSelfAttention))]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return weights


def rollout_from_model(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """One forward of ``model`` on ``x`` → the rollout matrix (B, L, L)."""
    weights = collect_attention_weights(model, x)
    if not weights:
        raise ValueError("model has no attention layer that ran")
    return attention_rollout(weights)
