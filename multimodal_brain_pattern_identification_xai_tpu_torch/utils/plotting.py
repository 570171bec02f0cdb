"""Plots (counterpart of the JAX package's ``utils/plotting.py``): training
curves, confusion matrix, class distribution, real-vs-generated waveforms,
learning-rate and regularisation curves, raw-vs-processed spectrograms,
STFT comparison, saliency heatmaps, sample grids, and a model summary.

matplotlib (Agg backend) is optional.  Each plot function returns the path
it wrote, or, without matplotlib, ``None`` after logging one line that the
plot was skipped; nothing else changes.  :func:`model_summary` returns its
text either way.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _plt(name: str):
    """``matplotlib.pyplot`` on the Agg backend, or None (and the skip
    logged) when matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("plot skipped: %s.png (matplotlib is not installed)",
                       name)
        return None
    return plt


def _save(plt, fig, save_dir: str, name: str, dpi: int = 120) -> str:
    path = os.path.join(save_dir, f"{name}.png")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_training_curves(history: Dict[str, List[float]], save_dir: str,
                         name: str = "training_curves") -> Optional[str]:
    """Loss and metric curves per epoch."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    for key, values in history.items():
        ax.plot(values, label=key)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, save_dir, name)


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str],
                          save_dir: str, name: str = "confusion_matrix",
                          normalize: bool = True) -> Optional[str]:
    """Confusion-matrix heatmap, rows normalised when ``normalize``."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                    color="white" if cm[i, j] > 0.5 else "black")
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.colorbar(im)
    return _save(plt, fig, save_dir, name)


def plot_class_distribution(labels_before: np.ndarray,
                            labels_after: Optional[np.ndarray],
                            class_names: Sequence[str], save_dir: str,
                            name: str = "class_distribution"
                            ) -> Optional[str]:
    """Class histogram before (and after) augmentation."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 4))
    n = len(class_names)
    before = np.bincount(np.asarray(labels_before), minlength=n)
    ax.bar(np.arange(n) - 0.2, before, width=0.4, label="before")
    if labels_after is not None:
        after = np.bincount(np.asarray(labels_after), minlength=n)
        ax.bar(np.arange(n) + 0.2, after, width=0.4, label="after")
    ax.set_xticks(range(n), class_names)
    ax.legend()
    return _save(plt, fig, save_dir, name)


def plot_real_vs_generated(real: np.ndarray, generated: np.ndarray,
                           save_dir: str, n_channels: int = 4,
                           name: str = "real_vs_generated"
                           ) -> Optional[str]:
    """Waveform panels of the first window, real beside generated."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, axes = plt.subplots(n_channels, 2, figsize=(10, 2 * n_channels),
                             sharex=True)
    for c in range(n_channels):
        axes[c, 0].plot(real[0, c], lw=0.5)
        axes[c, 1].plot(generated[0, c], lw=0.5, color="tab:orange")
        axes[c, 0].set_ylabel(f"ch {c}")
    axes[0, 0].set_title("real")
    axes[0, 1].set_title("generated")
    return _save(plt, fig, save_dir, name)


def plot_lr_and_regularization(lrs: Sequence[float],
                               reg_losses: Sequence[float], save_dir: str,
                               name: str = "lr_and_regularization"
                               ) -> Optional[str]:
    """Learning-rate schedule beside the regularisation loss."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    fig, (a0, a1) = plt.subplots(1, 2, figsize=(10, 4))
    a0.plot(list(lrs))
    a0.set_title("learning rate")
    a0.set_xlabel("epoch")
    a1.plot(list(reg_losses), color="tab:orange")
    a1.set_title("regularization loss")
    a1.set_xlabel("epoch")
    fig.tight_layout()
    return _save(plt, fig, save_dir, name)


def plot_spectrogram_pair(raw: np.ndarray, processed: np.ndarray,
                          save_dir: str,
                          name: str = "spectrogram_pair") -> Optional[str]:
    """Raw beside processed spectrogram; a ``processed`` with a channel
    axis (trailing of at most 4, else leading) shows its channel 0."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    proc = np.asarray(processed)
    if proc.ndim == 3:
        proc = proc[..., 0] if proc.shape[-1] <= 4 else proc[0]
    fig, (a0, a1) = plt.subplots(1, 2, figsize=(12, 5))
    im0 = a0.imshow(np.asarray(raw), aspect="auto", cmap="viridis")
    a0.set_title("raw")
    fig.colorbar(im0, ax=a0)
    im1 = a1.imshow(proc, aspect="auto", cmap="viridis")
    a1.set_title("processed")
    fig.colorbar(im1, ax=a1)
    return _save(plt, fig, save_dir, name)


def plot_stft_comparison(real_eeg: np.ndarray, generated_eeg: np.ndarray,
                         save_dir: str, nperseg: int = 64,
                         noverlap: int = 32,
                         name: str = "stft_comparison") -> Optional[str]:
    """log1p |STFT| of one real and one generated (T,) trace, side by
    side, through the port's ``ops.stft``."""
    from ..ops.stft import stft as _stft
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)

    def log_spec(sig):
        x = torch.as_tensor(np.asarray(sig, np.float32))[None, None, :]
        _, _, z = _stft(x, nperseg=nperseg, noverlap=noverlap)
        return np.log1p(z.abs().cpu().numpy())[0, 0]

    fig, (a0, a1) = plt.subplots(1, 2, figsize=(12, 4))
    a0.imshow(log_spec(real_eeg), aspect="auto", origin="lower",
              cmap="viridis")
    a0.set_title("real spectrogram")
    a1.imshow(log_spec(generated_eeg), aspect="auto", origin="lower",
              cmap="viridis")
    a1.set_title("generated spectrogram")
    fig.tight_layout()
    return _save(plt, fig, save_dir, name)


def plot_saliency_heatmap(saliency: np.ndarray, save_dir: str,
                          name: str = "saliency",
                          channel_names: Optional[Sequence[str]] = None
                          ) -> Optional[str]:
    """Per-channel |gradient| heatmap over time."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    sal = np.asarray(saliency)
    sal = sal.reshape(-1, sal.shape[-1]) if sal.ndim > 2 else sal
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(sal, aspect="auto", cmap="hot")
    if channel_names is not None:
        ax.set_yticks(range(len(channel_names)), channel_names, fontsize=6)
    ax.set_xlabel("time")
    fig.colorbar(im)
    return _save(plt, fig, save_dir, name)


def model_summary(model: torch.nn.Module, *example_inputs,
                  save_dir: Optional[str] = None,
                  name: str = "model_summary") -> str:
    """A table of ``model``'s module tree to depth 2: each module's type,
    output shape on ``example_inputs`` (from forward hooks, under
    ``no_grad``) and parameter count, then the total.  Returns the text;
    with ``save_dir`` also renders it to ``<save_dir>/<name>.png`` (when
    matplotlib is installed)."""
    rows, shapes, hooks = [], {}, []

    def shape_of(out):
        if isinstance(out, torch.Tensor):
            return str(tuple(out.shape))
        if isinstance(out, (tuple, list)):
            return ", ".join(shape_of(o) for o in out)
        return type(out).__name__

    def hook(mod_name):
        def record(_mod, _inp, out):
            shapes.setdefault(mod_name, shape_of(out))
        return record

    mods = [(n, m) for n, m in model.named_modules()
            if n.count(".") < 2]
    for n, m in mods:
        hooks.append(m.register_forward_hook(hook(n)))
    try:
        with torch.no_grad():
            model(*example_inputs)
    finally:
        for h in hooks:
            h.remove()
    for n, m in mods:
        n_params = sum(p.numel() for p in m.parameters())
        rows.append((n or "(model)", type(m).__name__,
                     shapes.get(n, "-"), f"{n_params:,}"))
    heads = ("module", "type", "output", "params")
    widths = [max(len(r[i]) for r in rows + [heads]) for i in range(4)]
    line = lambda r: "  ".join(c.ljust(w) for c, w in zip(r, widths))
    total = sum(p.numel() for p in model.parameters())
    text = "\n".join([line(heads), line(["-" * w for w in widths])]
                     + [line(r) for r in rows]
                     + [f"total params: {total:,}"])
    if save_dir is not None:
        plt = _plt(name)
        if plt is not None:
            os.makedirs(save_dir, exist_ok=True)
            n_lines = text.count("\n") + 1
            fig, ax = plt.subplots(figsize=(14, max(4, 0.18 * n_lines)))
            ax.text(0.01, 0.99, text, fontsize=7, family="monospace",
                    va="top")
            ax.axis("off")
            _save(plt, fig, save_dir, name)
    return text


def plot_sample_grid(images: np.ndarray, save_dir: str,
                     name: str = "samples", ncols: int = 8
                     ) -> Optional[str]:
    """(N, H, W) images on a grid of ``ncols`` columns."""
    plt = _plt(name)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(ncols, nrows))
    axes = np.atleast_2d(axes)
    for i in range(nrows * ncols):
        ax = axes[i // ncols, i % ncols]
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap="gray")
    return _save(plt, fig, save_dir, name, dpi=100)
