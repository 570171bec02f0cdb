"""EEGNet with single-head attention (counterpart of the JAX package's
``models/eegnet.py``: ``_EEGNetStem`` in canonical order and
``EEGNetAttentionRegularized``).  Input (B, 1, 37, samples), output
log-probabilities (B, 6)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Attention, BatchNorm

CHANS, N_CLASSES, F1, D, F2, DROPOUT = 37, 6, 8, 2, 16, 0.5


class EEGNetAttentionRegularized(nn.Module):
    """EEGNet stem — temporal conv (1, kern_length) → BN → depthwise
    (37, 1) conv → BN → ELU → avgpool (1, 4) → dropout → conv (1, 16) → BN
    — then ELU → avgpool (1, 8) → dropout, single-head attention over the
    time tokens, dense1 (128) → dropout → dense2 → log-softmax.

    Module names follow the reference torch model, so its state dict
    loads as is."""

    def __init__(self, samples: int = 3000, kern_length: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(1, F1, (1, kern_length), padding="same",
                               bias=False)
        self.batchnorm1 = BatchNorm(F1)
        self.depthwiseConv = nn.Conv2d(F1, F1 * D, (CHANS, 1), groups=F1,
                                       bias=False)
        self.batchnorm2 = BatchNorm(F1 * D)
        self.separableConv = nn.Conv2d(F1 * D, F2, (1, 16), padding="same",
                                       bias=False)
        self.batchnorm3 = BatchNorm(F2)
        self.dropout = nn.Dropout(DROPOUT)
        self.attention_layer = Attention(F2, F2)
        self.dense1 = nn.Linear(F2 * (samples // 32), 128)
        self.dense2 = nn.Linear(128, N_CLASSES)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The stem through ELU → avgpool (1, 8) → dropout: the feature map
        (B, F2, 1, T') that Grad-CAM reads (the JAX model's
        ``sow("feature_map")``)."""
        x = self.batchnorm1(self.conv1(x))
        x = self.batchnorm2(self.depthwiseConv(x))
        x = self.dropout(F.avg_pool2d(F.elu(x), (1, 4)))
        x = self.batchnorm3(self.separableConv(x))
        return self.dropout(F.avg_pool2d(F.elu(x), (1, 8)))

    def head(self, a: torch.Tensor) -> torch.Tensor:
        """Feature map (B, F2, 1, T') → log-probs (B, 6)."""
        tokens, _ = self.attention_layer(a.flatten(2).transpose(1, 2))
        x = tokens.transpose(1, 2).flatten(1)                # channel-major
        x = self.dense2(self.dropout(self.dense1(x)))
        return F.log_softmax(x, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))
