"""SHAP-driven channel selection (counterpart of the JAX package's
``xai/channel_select.py``): mean |attribution| per channel → the top-N
channels → the EEG sliced to them, labels binarised against one class →
a fresh binary ``EEGNetAttentionRegularized`` retrained on that set."""

from __future__ import annotations

import tempfile
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config as C


def mean_abs_attribution_per_channel(shap_values: np.ndarray) -> np.ndarray:
    """(..., C_channels, T) attributions → (C_channels,) mean |attr| over
    every other axis."""
    a = np.abs(np.asarray(shap_values))
    ch_axis = a.ndim - 2
    other = tuple(i for i in range(a.ndim) if i != ch_axis)
    return a.mean(axis=other)


def get_top_n_channels(shap_values: np.ndarray, n: int = 10
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-N channel indices and their scores, highest first."""
    scores = mean_abs_attribution_per_channel(shap_values)
    idx = np.argsort(-scores)[:n]
    return idx, scores[idx]


def channel_names_37() -> list:
    """The 37 model-channel names: 19 scalp + 18 bipolar pair labels."""
    return list(C.EEG_FEATURES) + [f"{a}-{b}" for a, b in C.MAP_FEATURES]


def restructure_to_top_channels(x: np.ndarray, y: np.ndarray,
                                top_idx: Sequence[int],
                                positive_class: Optional[int] = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Slice the (B, 1, 37, T) EEG to the ``top_idx`` channels; with
    ``positive_class``, binarise the labels (hard argmax) against it as
    (1 − b, b)."""
    x = np.asarray(x)
    sel = x[..., np.asarray(top_idx, np.int64), :]
    if positive_class is None:
        return sel, np.asarray(y)
    hard = np.asarray(y).argmax(-1) if np.asarray(y).ndim > 1 else np.asarray(y)
    binary = (hard == positive_class).astype(np.float32)
    return sel, np.stack([1.0 - binary, binary], axis=-1)


def retrain_on_top_channels(x: np.ndarray, y: np.ndarray,
                            shap_values: np.ndarray,
                            n_channels: int = 5,
                            positive_class: int = 0,
                            epochs: int = 3, batch_size: int = 8,
                            lr: float = 1e-3, seed: int = 0,
                            model_kwargs: Optional[dict] = None,
                            ckpt_dir: Optional[str] = None,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> dict:
    """Rank the channels by mean |attribution| of ``positive_class``,
    slice the EEG to the top ``n_channels``, binarise the labels against
    that class, and train a fresh binary ``EEGNetAttentionRegularized(
    chans=n_channels)`` with the port's ``Trainer`` on ``device`` (cuda
    unless given): a quarter of the rows (at least one) drawn by
    ``default_rng(seed)`` validate, the rest train in batches of
    ``batch_size`` shuffled with ``seed + epoch``; checkpoints go to
    ``ckpt_dir`` (a temporary directory when None), and the best one is
    evaluated at the end.

    Args:
        x: (B, 1, C, T) preprocessed EEG.
        y: (B, n_classes) soft or one-hot labels.
        shap_values: (n_classes, B', 1, C, T) per-class attributions, or
            any (..., C, T) array already of one class.

    Returns ``{"top_channels", "positive_class", "fresh", "retrained",
    "best_kldiv"}``: the validation kldiv and accuracy of the fresh model
    and of the retrained one."""
    from .. import resolve_device
    from ..data import batch_iterator
    from ..models import EEGNetAttentionRegularized
    from ..train import (Trainer, TrainerConfig, create_train_state,
                         initialize_kaiming_weights, make_optimizer)

    dev = resolve_device(device)
    sv = np.asarray(shap_values)
    if sv.ndim == np.asarray(x).ndim + 1:       # leading class axis
        sv = sv[positive_class]
    top_idx, _ = get_top_n_channels(sv, n=n_channels)
    xs, ys = restructure_to_top_channels(x, y, top_idx, positive_class)
    xs = np.asarray(xs, np.float32)

    perm = np.random.default_rng(seed).permutation(len(xs))
    n_val = max(1, len(xs) // 4)
    va, tr = perm[:n_val], perm[n_val:]

    kw = dict(nb_classes=2, chans=len(top_idx), samples=xs.shape[-1])
    kw.update(model_kwargs or {})
    model = EEGNetAttentionRegularized(**kw)
    initialize_kaiming_weights(model, torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(dev), make_optimizer(lr), seed=seed)
    cfg = TrainerConfig(epochs=epochs, seed=seed,
                        eval_metrics=("kldiv", "accuracy"))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(state, cfg, ckpt_dir=ckpt_dir or tmp)

        def train_loader(epoch: int = 0):
            return batch_iterator({"x": xs[tr], "y": ys[tr]}, batch_size,
                                  shuffle=True, seed=seed + epoch,
                                  drop_last=False)

        def val_loader():
            return batch_iterator({"x": xs[va], "y": ys[va]}, batch_size,
                                  drop_last=False)

        _, fresh, _ = trainer.eval_epoch(val_loader())
        _, best, _ = trainer.train_eval(train_loader, val_loader)
        _, retrained, _ = trainer.eval_epoch(val_loader())
    return {"top_channels": np.asarray(top_idx).tolist(),
            "positive_class": positive_class,
            "fresh": {k: float(v) for k, v in fresh.items()},
            "retrained": {k: float(v) for k, v in retrained.items()},
            "best_kldiv": float(best)}
