"""Evaluation metrics (counterpart of the JAX package's
``train/metrics.py``): the reference's ``Evaluator`` registry, hard and
soft accuracy, the confusion matrix and macro precision / recall / F1, on
tensors."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .losses import cross_entropy_with_logits, kldiv_with_logits


class Evaluator:
    """Metric registry and runner.  ``evaluate(y_true, y_pred)`` takes soft
    targets and prediction logits (or log-probs) and returns floats."""

    def __init__(self, metric_names: List[str]) -> None:
        self.metric_names = list(metric_names)
        self.eval_metrics: Dict[str, Callable] = {}
        for name in self.metric_names:
            if name == "kldiv":
                self.eval_metrics[name] = kldiv_with_logits
            elif name == "ce":
                self.eval_metrics[name] = cross_entropy_with_logits
            elif name == "accuracy":
                self.eval_metrics[name] = hard_accuracy
            elif name == "f1":
                self.eval_metrics[name] = (
                    lambda yp, yt: macro_precision_recall_f1(
                        yp.argmax(-1), yt.argmax(-1), yp.shape[-1])[2])
            else:
                raise ValueError(f"unknown metric {name!r}")

    def evaluate(self, y_true: torch.Tensor, y_pred: torch.Tensor
                 ) -> Dict[str, float]:
        return {name: float(fn(y_pred, y_true))
                for name, fn in self.eval_metrics.items()}


def hard_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """argmax-vs-argmax accuracy."""
    return (logits.argmax(-1) == targets.argmax(-1)).float().mean()


def soft_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Probability mass the target distribution puts on the predicted
    class."""
    pred = logits.argmax(-1)
    return targets.gather(1, pred[:, None]).mean()


def confusion_matrix(y_pred: torch.Tensor, y_true: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) count matrix, rows = true class."""
    idx = (y_true * n_classes + y_pred).long()
    return torch.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes)


def macro_precision_recall_f1(y_pred: torch.Tensor, y_true: torch.Tensor,
                              n_classes: int, eps: float = 1e-12):
    """Macro-averaged precision, recall and F1 over argmax predictions
    (sklearn's ``average='macro', zero_division=0``)."""
    cm = confusion_matrix(y_pred, y_true, n_classes).float()
    tp = cm.diagonal()
    pred_tot, true_tot = cm.sum(0), cm.sum(1)
    precision = torch.where(pred_tot > 0, tp / (pred_tot + eps), 0.0)
    recall = torch.where(true_tot > 0, tp / (true_tot + eps), 0.0)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / (precision + recall + eps), 0.0)
    return precision.mean(), recall.mean(), f1.mean()
