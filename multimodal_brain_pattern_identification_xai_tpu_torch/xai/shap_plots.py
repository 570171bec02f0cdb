"""SHAP aggregation plots (counterpart of the JAX package's
``xai/shap_plots.py``): mean |SHAP| per channel as bars (one panel a
class) and as scatter series, and a beeswarm-style summary of one class.
matplotlib is optional: without it each returns None after logging that
the plot was skipped."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..utils.plotting import _plt, _save
from .channel_select import mean_abs_attribution_per_channel


def plot_mean_shap_values(shap_values: np.ndarray,
                          channel_names: Sequence[str], save_dir: str,
                          class_names: Optional[Sequence[str]] = None,
                          name: str = "shap_mean_bar") -> Optional[str]:
    """Mean |SHAP| per channel, one bar panel a class.
    ``shap_values``: (n_classes, B, 1, C, T)."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    n_classes = shap_values.shape[0]
    fig, axes = plt.subplots(n_classes, 1, figsize=(10, 2.2 * n_classes),
                             sharex=True)
    for c in range(n_classes):
        scores = mean_abs_attribution_per_channel(shap_values[c])
        ax = axes[c] if n_classes > 1 else axes
        ax.bar(range(len(scores)), scores)
        ax.set_ylabel(class_names[c] if class_names else f"class {c}",
                      fontsize=8)
    ax.set_xticks(range(len(channel_names)))
    ax.set_xticklabels(channel_names, rotation=90, fontsize=6)
    return _save(plt, fig, save_dir, name)


def plot_mean_shap_values_scatter(shap_values: np.ndarray,
                                  channel_names: Sequence[str],
                                  save_dir: str,
                                  class_names: Optional[Sequence[str]] = None,
                                  name: str = "shap_mean_scatter"
                                  ) -> Optional[str]:
    """Mean |SHAP| per channel, every class as one scatter series."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(11, 5))
    for c in range(shap_values.shape[0]):
        scores = mean_abs_attribution_per_channel(shap_values[c])
        ax.scatter(range(len(scores)), scores, s=14,
                   label=class_names[c] if class_names else f"class {c}")
    ax.set_xticks(range(len(channel_names)))
    ax.set_xticklabels(channel_names, rotation=90, fontsize=6)
    ax.set_ylabel("mean |SHAP|")
    ax.legend(fontsize=7)
    return _save(plt, fig, save_dir, name)


def plot_shap_summary(shap_values_class: np.ndarray,
                      inputs: np.ndarray,
                      channel_names: Sequence[str], save_dir: str,
                      max_points: int = 2000,
                      name: str = "shap_summary") -> Optional[str]:
    """Beeswarm-style summary of one class (``shap.summary_plot``): per
    channel, ordered by mean |SHAP|, the SHAP values on x coloured by the
    input value, at most ``max_points`` a channel.
    ``shap_values_class`` and ``inputs``: (B, 1, C, T)."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    sv = np.asarray(shap_values_class).reshape(
        shap_values_class.shape[0], -1, shap_values_class.shape[-1])
    xv = np.asarray(inputs).reshape(sv.shape)
    C = sv.shape[1]
    order = np.argsort(-np.abs(sv).mean(axis=(0, 2)))
    fig, ax = plt.subplots(figsize=(8, 0.28 * C + 1))
    rng = np.random.default_rng(0)
    for row, ch in enumerate(order):
        vals = sv[:, ch, :].ravel()
        cols = xv[:, ch, :].ravel()
        if len(vals) > max_points:
            sel = rng.choice(len(vals), max_points, replace=False)
            vals, cols = vals[sel], cols[sel]
        jitter = rng.normal(0, 0.08, len(vals))
        sc = ax.scatter(vals, np.full_like(vals, row) + jitter, c=cols,
                        cmap="coolwarm", s=3, alpha=0.5)
    ax.set_yticks(range(C))
    ax.set_yticklabels([channel_names[i] for i in order], fontsize=6)
    ax.set_xlabel("SHAP value")
    fig.colorbar(sc, label="input value")
    return _save(plt, fig, save_dir, name)
