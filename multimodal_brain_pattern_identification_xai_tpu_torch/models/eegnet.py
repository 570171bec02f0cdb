"""The EEGNet family (counterpart of the JAX package's ``models/eegnet.py``):
the shared stem (canonical order, and the reassociated inference path),
``EEGNet``, ``EEGNetAttentionRegularized``, ``EEGNetAttentionDeep``,
``EEGNetResidual``, ``EEGNetResidualLSTM``, ``EEGNetTransformer`` and
``EEGSeizureDetectionModel``.  Input (B, 1, chans, samples), output
log-probabilities (B, nb_classes).  Every model has ``features`` (to the
JAX model's ``sow("feature_map")`` point, NCHW) and ``head``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Attention, BatchNorm, BiLSTM, Dropout, LSTM,
                     TransformerEncoderLayer)


class _EEGNetStem(nn.Module):
    """Base of the EEGNet variants: the stem's modules, flat, with the
    reference torch model's names — temporal conv ``conv1`` (1,
    kern_length) → ``batchnorm1`` → depthwise (chans, 1) ``depthwiseConv``
    → ``batchnorm2`` → ELU → avgpool (1, 4) → ``dropout`` → conv (1, 16)
    ``separableConv`` → ``batchnorm3``.

    ``fused_inference=True`` (the JAX stem's default) runs the stem's first
    half reassociated in eval mode (:meth:`_stem_reassociated`); training
    mode keeps the canonical order."""

    def __init__(self, chans: int, kern_length: int, f1: int, d: int,
                 f2: int, dropout_rate: float, fused_inference: bool):
        super().__init__()
        self.f1, self.d = f1, d
        self.fused_inference = fused_inference
        self.conv1 = nn.Conv2d(1, f1, (1, kern_length), padding="same",
                               bias=False)
        self.batchnorm1 = BatchNorm(f1)
        self.depthwiseConv = nn.Conv2d(f1, f1 * d, (chans, 1), groups=f1,
                                       bias=False)
        self.batchnorm2 = BatchNorm(f1 * d)
        self.separableConv = nn.Conv2d(f1 * d, f2, (1, 16), padding="same",
                                       bias=False)
        self.batchnorm3 = BatchNorm(f2)
        self.dropout = Dropout(dropout_rate)

    def stem(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 1, chans, T) → (``batchnorm3``'s output (B, F2, 1, T/4),
        the residual tap: the output of the dropout after the (1, 4) pool,
        (B, F1·D, 1, T/4))."""
        if self.fused_inference and not self.training:
            x = self._stem_reassociated(x)
        else:
            x = self.depthwiseConv(self.batchnorm1(self.conv1(x)))
        x = self.batchnorm2(x)
        tap = self.dropout(F.avg_pool2d(F.elu(x), (1, 4)))
        return self.batchnorm3(self.separableConv(tap)), tap

    def _stem_features(self, x: torch.Tensor) -> torch.Tensor:
        """The stem, then ELU → avgpool (1, 8) → dropout: (B, F2, 1, T/32)."""
        x, _ = self.stem(x)
        return self.dropout(F.avg_pool2d(F.elu(x), (1, 8)))

    def _stem_reassociated(self, x: torch.Tensor) -> torch.Tensor:
        """temporal conv → BN1 → depthwise (chans, 1) conv, reassociated as
        in the JAX stem's inference path (exact in real arithmetic): the
        per-group temporal conv commutes with the depthwise stage, which
        only contracts the channels, and BN1 with running statistics is a
        per-group affine that folds through the contraction.  So the
        channels are contracted first, z[b, o, t] = Σ_h K[h, o] x[b, h, t]
        with K = ``depthwiseConv.weight`` as (chans, F1·D), o = g·D + d;
        then the temporal conv of group g runs on its D channels (grouped
        conv1d, SAME: (k−1)//2 left, k//2 right, as flax pads an even
        kernel); then v = s_g·z + o_g·Σ_h K[h, o].  The (B, F1, chans, T)
        intermediate is never made.  (B, 1, chans, T) → (B, F1·D, 1, T)."""
        bn, d = self.batchnorm1, self.d
        s_g = bn.weight * torch.rsqrt(bn.running_var + 1e-5)      # (F1,)
        o_g = bn.bias - bn.running_mean * s_g
        k = self.depthwiseConv.weight[:, 0, :, 0]                 # (F1·D, chans)
        z = torch.matmul(k, x[:, 0])                              # (B, F1·D, T)
        taps = self.conv1.weight[:, 0].repeat_interleave(d, dim=0)  # (F1·D, 1, kern)
        kern = taps.shape[-1]
        z = F.conv1d(F.pad(z, ((kern - 1) // 2, kern // 2)), taps,
                     groups=self.f1 * d)
        scale = s_g.repeat_interleave(d)
        bias = o_g.repeat_interleave(d) * k.sum(dim=1)
        return (scale[:, None] * z + bias[:, None])[:, :, None, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


class EEGNet(_EEGNetStem):
    """Vanilla EEGNet: the stem → ELU → avgpool (1, 8) → dropout →
    ``dense`` → log-softmax."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 8, d: int = 2,
                 f2: int = 16, fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        self.dense = nn.Linear(f2 * (samples // 32), nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, F2, 1, T/32)."""
        return self._stem_features(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.dense(x.flatten(1)), dim=-1)


class EEGNetAttentionRegularized(_EEGNetStem):
    """EEGNet stem → ELU → avgpool (1, 8) → dropout, single-head attention
    over the time tokens, dense1 (128) → dropout → dense2 → log-softmax.

    Module names follow the reference torch model, so its state dict
    loads as is."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 8, d: int = 2,
                 f2: int = 16, fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        self.attention_layer = Attention(f2, f2)
        self.dense1 = nn.Linear(f2 * (samples // 32), 128)
        self.dense2 = nn.Linear(128, nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The stem through ELU → avgpool (1, 8) → dropout: the feature map
        (B, F2, 1, T') that Grad-CAM reads (the JAX model's
        ``sow("feature_map")``)."""
        return self._stem_features(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Feature map (B, F2, 1, T') → log-probs (B, nb_classes)."""
        tokens, _ = self.attention_layer(x.flatten(2).transpose(1, 2))
        x = tokens.transpose(1, 2).flatten(1)                # channel-major
        x = self.dense2(self.dropout(self.dense1(x)))
        return F.log_softmax(x, dim=-1)


class EEGNetAttentionDeep(_EEGNetStem):
    """EEGNet with a third conv block and attention: the stem → ELU →
    avgpool (1, 8) → dropout → ``conv2`` (1, 16), F2 → F3 → ``batchnorm4``
    → ELU → avgpool (1, 8) → dropout; attention over the time tokens →
    dense1 (128) → dense2 → log-softmax."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 8, d: int = 2,
                 f2: int = 16, f3: int = 32, fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        self.conv2 = nn.Conv2d(f2, f3, (1, 16), padding="same", bias=False)
        self.batchnorm4 = BatchNorm(f3)
        self.attention_layer = Attention(f3, f3)
        self.dense1 = nn.Linear(f3 * (samples // 256), 128)
        self.dense2 = nn.Linear(128, nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, F3, 1, T/256)."""
        x = self.batchnorm4(self.conv2(self._stem_features(x)))
        return self.dropout(F.avg_pool2d(F.elu(x), (1, 8)))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.attention_layer(x.flatten(2).transpose(1, 2))
        x = self.dense2(self.dense1(tokens.transpose(1, 2).flatten(1)))
        return F.log_softmax(x, dim=-1)


class _ResidualTail(nn.Module):
    """The residual path around block 2 of ``EEGNetResidual(LSTM)``: 1×1
    conv stride (1, 2), no bias → BatchNorm → avgpool (1, 4)."""

    def __init__(self, cin: int, f2: int):
        super().__init__()
        self.residual_conv = nn.Conv2d(cin, f2, 1, stride=(1, 2), bias=False)
        self.bn = BatchNorm(f2)

    def forward(self, tap: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.bn(self.residual_conv(tap)), (1, 4))


class EEGNetResidual(_EEGNetStem):
    """EEGNet with a strided-1×1-conv residual around block 2: the stem →
    ELU → avgpool (1, 8) → dropout, plus :class:`_ResidualTail` of the
    stem's tap; ``dense`` → log-softmax."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 8, d: int = 2,
                 f2: int = 16, fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        self.residual = _ResidualTail(f1 * d, f2)
        self.dense = nn.Linear(f2 * (samples // 32), nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, F2, 1, T/32), the residual added."""
        x, tap = self.stem(x)
        x = self.dropout(F.avg_pool2d(F.elu(x), (1, 8)))
        return x + self.residual(tap)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.dense(x.flatten(1)), dim=-1)


class EEGNetResidualLSTM(_EEGNetStem):
    """:class:`EEGNetResidual`'s features, then an LSTM of ``lstm_units``
    over the time tokens; its whole sequence (time-major) → ``dense`` →
    log-softmax."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 8, d: int = 2,
                 f2: int = 16, lstm_units: int = 64,
                 fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        self.residual = _ResidualTail(f1 * d, f2)
        self.lstm = LSTM(f2, lstm_units)
        self.dense = nn.Linear(lstm_units * (samples // 32), nb_classes)

    features = EEGNetResidual.features

    def head(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.lstm(x.flatten(2).transpose(1, 2))       # (B, T', units)
        return F.log_softmax(self.dense(seq.flatten(1)), dim=-1)


class EEGNetTransformer(_EEGNetStem):
    """Three conv blocks → one flattened token a sample → ``num_layers``
    post-LN transformer encoder layers (batch-first, as the JAX model) →
    dense1 (256) → ReLU → dense2 (128) → ReLU → ``fc_output`` →
    log-softmax.  The token's width is f2·2·(samples // 128), the conv
    trunk's flattened size (1,472 at 3,000 samples)."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5,
                 kern_length: int = 64, f1: int = 16, d: int = 4,
                 f2: int = 32, num_heads: int = 8, num_layers: int = 4,
                 fused_inference: bool = True):
        super().__init__(chans, kern_length, f1, d, f2, dropout_rate,
                         fused_inference)
        d_model = f2 * 2 * (samples // 128)
        self.separableConv2 = nn.Conv2d(f2, f2 * 2, (1, 8), padding="same",
                                        bias=False)
        self.batchnorm4 = BatchNorm(f2 * 2)
        self.encoder = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dropout=dropout_rate)
            for _ in range(num_layers))
        self.dense1 = nn.Linear(d_model, 256)
        self.dense2 = nn.Linear(256, 128)
        self.fc_output = nn.Linear(128, nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, 2·F2, 1, T/128)."""
        x = self.batchnorm4(self.separableConv2(self._stem_features(x)))
        return self.dropout(F.avg_pool2d(F.elu(x), (1, 4)))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        tok = x.flatten(1)[:, None]                          # (B, 1, d_model)
        for layer in self.encoder:
            tok = layer(tok)
        x = F.relu(self.dense1(tok[:, 0]))
        x = F.relu(self.dense2(x))
        return F.log_softmax(self.fc_output(x), dim=-1)


class EEGSeizureDetectionModel(nn.Module):
    """Two conv blocks → two BiLSTM(128) layers over one timestep → fc1
    (64) → dropout → fc2 → log-softmax.  The convs pad (0, 32) and
    (0, 16) explicitly and carry a bias, as the reference's."""

    def __init__(self, nb_classes: int = 6, chans: int = 37,
                 samples: int = 3000, dropout_rate: float = 0.5):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 16, (1, 64), padding=(0, 32))
        self.batchnorm1 = BatchNorm(16)
        self.conv2 = nn.Conv2d(16, 32, (1, 32), padding=(0, 16))
        self.batchnorm2 = BatchNorm(32)
        t = ((samples + 1) // 4 + 1) // 4
        self.lstm1 = BiLSTM(32 * chans * t, 128)
        self.lstm2 = BiLSTM(256, 128)
        self.fc1 = nn.Linear(256, 64)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(64, nb_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, 32, chans, T')."""
        x = F.avg_pool2d(F.elu(self.batchnorm1(self.conv1(x))), (1, 4))
        return F.avg_pool2d(F.elu(self.batchnorm2(self.conv2(x))), (1, 4))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        h = self.lstm2(self.lstm1(x.flatten(1)[:, None]))
        x = self.fc2(self.dropout(self.fc1(h[:, -1])))
        return F.log_softmax(x, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))
