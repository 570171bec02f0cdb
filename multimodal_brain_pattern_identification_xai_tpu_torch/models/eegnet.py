"""EEGNet with single-head attention (counterpart of the JAX package's
``models/eegnet.py``: ``_EEGNetStem``, canonical order and inference
reassociation, and ``EEGNetAttentionRegularized``).  Input
(B, 1, 37, samples), output log-probabilities (B, 6)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Attention, BatchNorm, Dropout

CHANS, N_CLASSES, F1, D, F2, DROPOUT = 37, 6, 8, 2, 16, 0.5


class EEGNetAttentionRegularized(nn.Module):
    """EEGNet stem — temporal conv (1, kern_length) → BN → depthwise
    (37, 1) conv → BN → ELU → avgpool (1, 4) → dropout → conv (1, 16) → BN
    — then ELU → avgpool (1, 8) → dropout, single-head attention over the
    time tokens, dense1 (128) → dropout → dense2 → log-softmax.

    Module names follow the reference torch model, so its state dict
    loads as is.

    ``fused_inference=True`` (the JAX stem's default) runs the stem's first
    half reassociated in eval mode (:meth:`_stem_reassociated`); training
    mode keeps the canonical order."""

    def __init__(self, samples: int = 3000, kern_length: int = 64,
                 fused_inference: bool = True):
        super().__init__()
        self.fused_inference = fused_inference
        self.conv1 = nn.Conv2d(1, F1, (1, kern_length), padding="same",
                               bias=False)
        self.batchnorm1 = BatchNorm(F1)
        self.depthwiseConv = nn.Conv2d(F1, F1 * D, (CHANS, 1), groups=F1,
                                       bias=False)
        self.batchnorm2 = BatchNorm(F1 * D)
        self.separableConv = nn.Conv2d(F1 * D, F2, (1, 16), padding="same",
                                       bias=False)
        self.batchnorm3 = BatchNorm(F2)
        self.dropout = Dropout(DROPOUT)
        self.attention_layer = Attention(F2, F2)
        self.dense1 = nn.Linear(F2 * (samples // 32), 128)
        self.dense2 = nn.Linear(128, N_CLASSES)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The stem through ELU → avgpool (1, 8) → dropout: the feature map
        (B, F2, 1, T') that Grad-CAM reads (the JAX model's
        ``sow("feature_map")``)."""
        if self.fused_inference and not self.training:
            x = self._stem_reassociated(x)
        else:
            x = self.depthwiseConv(self.batchnorm1(self.conv1(x)))
        x = self.batchnorm2(x)
        x = self.dropout(F.avg_pool2d(F.elu(x), (1, 4)))
        x = self.batchnorm3(self.separableConv(x))
        return self.dropout(F.avg_pool2d(F.elu(x), (1, 8)))

    def _stem_reassociated(self, x: torch.Tensor) -> torch.Tensor:
        """temporal conv → BN1 → depthwise (37, 1) conv, reassociated as in
        the JAX stem's inference path (exact in real arithmetic): the
        per-group temporal conv commutes with the depthwise stage, which
        only contracts the 37 channels, and BN1 with running statistics is
        a per-group affine that folds through the contraction.  So the 37
        channels are contracted first, z[b, o, t] = Σ_h K[h, o] x[b, h, t]
        with K = ``depthwiseConv.weight`` as (37, F1·D), o = g·D + d; then
        the 64-tap conv of group g runs on its D channels (grouped conv1d,
        SAME: 31 left, 32 right, as flax pads an even kernel); then
        v = s_g·z + o_g·Σ_h K[h, o].  The (B, F1, 37, T) intermediate is
        never made.  (B, 1, 37, T) → (B, F1·D, 1, T)."""
        bn = self.batchnorm1
        s_g = bn.weight * torch.rsqrt(bn.running_var + 1e-5)      # (F1,)
        o_g = bn.bias - bn.running_mean * s_g
        k = self.depthwiseConv.weight[:, 0, :, 0]                 # (F1·D, 37)
        z = torch.matmul(k, x[:, 0])                              # (B, F1·D, T)
        taps = self.conv1.weight[:, 0].repeat_interleave(D, dim=0)  # (F1·D, 1, kern)
        kern = taps.shape[-1]
        z = F.conv1d(F.pad(z, ((kern - 1) // 2, kern // 2)), taps,
                     groups=F1 * D)
        scale = s_g.repeat_interleave(D)
        bias = o_g.repeat_interleave(D) * k.sum(dim=1)
        return (scale[:, None] * z + bias[:, None])[:, :, None, :]

    def head(self, a: torch.Tensor) -> torch.Tensor:
        """Feature map (B, F2, 1, T') → log-probs (B, 6)."""
        tokens, _ = self.attention_layer(a.flatten(2).transpose(1, 2))
        x = tokens.transpose(1, 2).flatten(1)                # channel-major
        x = self.dense2(self.dropout(self.dense1(x)))
        return F.log_softmax(x, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))
