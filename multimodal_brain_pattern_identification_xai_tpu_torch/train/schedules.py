"""Learning-rate schedules (counterpart of the JAX package's
``train/schedules.py``), plain Python math:

* :func:`warmup_cosine_schedule` — per epoch, linear warm-up then cosine;
* :func:`linear_warmup_cosine_annealing` — per step, 0 → peak then cosine;
* :func:`cosine_schedule_with_warmup` — HF ``get_cosine_schedule_with_
  warmup`` semantics, per step;
* :func:`step_decay` — torch ``StepLR``;
* :class:`ReduceLROnPlateau` — the host-side plateau controller.

The pure ones return ``step -> lr`` callables (float in, float out).
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_schedule(warmup_epochs: int, total_epochs: int,
                           initial_lr: float, peak_lr: float,
                           min_lr: float) -> Callable[[float], float]:
    """Per epoch: linear initial → peak over the warm-up, cosine peak →
    min after."""
    def fn(epoch):
        e = float(epoch)
        if e < warmup_epochs:
            return initial_lr + (peak_lr - initial_lr) * (e + 1) / max(
                warmup_epochs, 1)
        progress = (e - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
        return min_lr + (peak_lr - min_lr) * 0.5 * (
            1 + math.cos(math.pi * progress))
    return fn


def linear_warmup_cosine_annealing(warmup_steps: int, total_steps: int,
                                   peak_lr: float, min_lr: float = 0.0
                                   ) -> Callable[[float], float]:
    """Linear 0 → peak warm-up, then cosine annealing to ``min_lr``."""
    def fn(step):
        s = float(step)
        if s < warmup_steps:
            return peak_lr * (s + 1) / max(warmup_steps, 1)
        progress = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return min_lr + (peak_lr - min_lr) * 0.5 * (
            1 + math.cos(math.pi * progress))
    return fn


def cosine_schedule_with_warmup(num_warmup_steps: int,
                                num_training_steps: int, peak_lr: float,
                                num_cycles: float = 0.5
                                ) -> Callable[[float], float]:
    """HF ``get_cosine_schedule_with_warmup`` semantics."""
    def fn(step):
        s = float(step)
        if s < num_warmup_steps:
            return peak_lr * s / max(1, num_warmup_steps)
        progress = (s - num_warmup_steps) / max(
            1, num_training_steps - num_warmup_steps)
        return peak_lr * max(0.0, 0.5 * (
            1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
    return fn


def step_decay(initial_lr: float, step_size: int,
               gamma: float) -> Callable[[int], float]:
    """torch ``StepLR``: lr·γ^⌊step/step_size⌋."""
    def fn(step):
        return initial_lr * gamma ** (int(step) // step_size)
    return fn


class ReduceLROnPlateau:
    """Host-side plateau controller with torch's semantics (``mode='min'``
    by default).  Call ``step(metric)`` each epoch; read ``.lr``."""

    def __init__(self, initial_lr: float, factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 threshold: float = 1e-4, mode: str = "min") -> None:
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        improved = (metric < self.best * (1 - self.threshold)
                    if self.mode == "min"
                    else metric > self.best * (1 + self.threshold))
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
