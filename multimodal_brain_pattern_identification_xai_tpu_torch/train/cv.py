"""Cross-validation splitters and the out-of-fold loop (counterpart of
the JAX package's ``train/cv.py``; numpy, sklearn-equivalent semantics)."""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def stratified_kfold(labels: np.ndarray, n_splits: int = 5, seed: int = 42
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """StratifiedKFold(shuffle=True) over class labels."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    folds: List[List[int]] = [[] for _ in range(n_splits)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        for i, chunk in enumerate(np.array_split(idx, n_splits)):
            folds[i].extend(chunk.tolist())
    out = []
    all_idx = np.arange(len(labels))
    for i in range(n_splits):
        val = np.sort(np.asarray(folds[i], dtype=np.int64))
        out.append((np.setdiff1d(all_idx, val), val))
    return out


def group_kfold(groups: np.ndarray, n_splits: int = 5
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """GroupKFold by patient: groups go to the currently smallest fold,
    largest groups first (sklearn's algorithm)."""
    groups = np.asarray(groups)
    uniq, counts = np.unique(groups, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    fold_sizes = np.zeros(n_splits, dtype=np.int64)
    group_fold = {}
    for gi in order:
        f = int(np.argmin(fold_sizes))
        group_fold[uniq[gi]] = f
        fold_sizes[f] += counts[gi]
    assign = np.asarray([group_fold[g] for g in groups])
    all_idx = np.arange(len(groups))
    out = []
    for i in range(n_splits):
        val = np.flatnonzero(assign == i)
        out.append((np.setdiff1d(all_idx, val), val))
    return out


def aggregate_vote_labels(votes: np.ndarray) -> np.ndarray:
    """Per-row vote counts → normalised probability targets."""
    votes = np.asarray(votes, np.float64)
    total = votes.sum(axis=1, keepdims=True)
    return (votes / np.maximum(total, 1e-12)).astype(np.float32)


def run_cv(make_trainer: Callable[[int], "object"],
           make_loaders: Callable[[np.ndarray, np.ndarray], Tuple],
           splits: List[Tuple[np.ndarray, np.ndarray]],
           n_samples: int, n_classes: int = 6,
           one_fold_only: bool = False) -> Tuple[np.ndarray, List[float]]:
    """Out-of-fold cross-validation: per fold build loaders and a trainer,
    train, scatter the validation predictions into the OOF matrix.
    Returns (oof, per-fold best metric)."""
    oof = np.zeros((n_samples, n_classes), np.float32)
    scores: List[float] = []
    for fold, (tr_idx, va_idx) in enumerate(splits):
        train_loader, val_loader = make_loaders(tr_idx, va_idx)
        trainer = make_trainer(fold)
        _, best, preds = trainer.train_eval(train_loader, val_loader, fold)
        if preds is not None:
            oof[va_idx] = preds[:len(va_idx)]
        scores.append(best)
        if one_fold_only:
            break
    return oof, scores


def detect_class_imbalance(labels: np.ndarray) -> dict:
    """Per-class sample counts from soft / one-hot (N, C) labels or integer
    class indices: ``{class_index: count}``."""
    arr = np.asarray(labels)
    if arr.ndim == 1:
        idx, n_classes = arr.astype(np.int64), int(arr.max()) + 1
    else:
        idx, n_classes = np.argmax(arr, axis=-1).ravel(), arr.shape[-1]
    counts = np.bincount(idx, minlength=n_classes)
    return {int(c): int(n) for c, n in enumerate(counts)}
