"""DeepConvNet (counterpart of the JAX package's ``models/deepconvnet.py``):
four VALID (1, 10) conv → (1, 4) max-pool stages, 25/50/100/200 wide, then
``fc1`` → log-softmax.  Input (B, 1, chans, samples)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Dropout

WIDTHS = (25, 50, 100, 200)


def _time_left(samples: int) -> int:
    """The time axis after the four VALID conv-pool stages: t → (t − 9)//4
    four times (< 1 below 1,021 samples)."""
    t = samples
    for _ in WIDTHS:
        t = (t - 9) // 4
    return t


def _check_samples(samples: int) -> None:
    if _time_left(samples) < 1:
        raise ValueError(
            f"DeepConvNet needs ≥1021 time samples (got {samples}): the "
            "four VALID conv-pool stages collapse shorter inputs to zero "
            "features")


class DeepConvNet(nn.Module):
    """``conv1`` (1, 10) → ``conv2`` (chans, 1) → BatchNorm → ELU → max-pool
    (1, 4) → dropout, then ``conv3``-``conv5`` (1, 10) each → BatchNorm →
    ELU → max-pool → dropout; every conv VALID and without bias.  A window
    shorter than 1,021 samples raises ``ValueError`` (at construction for
    ``samples``, before any work for an input)."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5):
        super().__init__()
        _check_samples(samples)
        self.conv1 = nn.Conv2d(1, WIDTHS[0], (1, 10), bias=False)
        self.conv2 = nn.Conv2d(WIDTHS[0], WIDTHS[0], (chans, 1), bias=False)
        self.batchnorm1 = BatchNorm(WIDTHS[0])
        for i, (cin, cout) in enumerate(zip(WIDTHS, WIDTHS[1:])):
            self.add_module(f"conv{i + 3}",
                            nn.Conv2d(cin, cout, (1, 10), bias=False))
            self.add_module(f"batchnorm{i + 2}", BatchNorm(cout))
        self.dropout = Dropout(dropout_rate)
        self.fc1 = nn.Linear(WIDTHS[-1] * _time_left(samples), nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, 200, 1, T')."""
        _check_samples(x.shape[-1])
        x = self.conv2(self.conv1(x))
        for i in range(len(WIDTHS)):
            if i:
                x = getattr(self, f"conv{i + 2}")(x)
            x = F.elu(getattr(self, f"batchnorm{i + 1}")(x))
            x = self.dropout(F.max_pool2d(x, (1, 4)))
        return x

    def head(self, a: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.fc1(a.flatten(1)), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))
