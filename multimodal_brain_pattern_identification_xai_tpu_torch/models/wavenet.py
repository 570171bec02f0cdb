"""Dilated-Inception WaveNet (counterpart of the JAX package's
``models/wavenet.py``).

The eight montage channels are folded into the batch and one shared stack
of wave blocks runs on the (8·B, 1, L) signals; the channels' pooled
features are averaged over pairs (four brain regions) before the dense
head.  The output is raw logits (trained with ``kldiv_with_logits``).

Convolutions run over time as ``Conv1d`` with the JAX package's ``SAME``
padding: d·(k−1) zeros in all, ⌊d·(k−1)/2⌋ before the signal and the rest
after it, so the even kernels (2 and 6) put one more zero at the end.
:meth:`DilatedInceptionWaveNet.features` ends at the last block's map as
(8·B, C, 1, L) and :meth:`~DilatedInceptionWaveNet.head` goes from there
to the logits: the split Grad-CAM takes (``xai.grad_cam``), the map the
JAX model sows as ``feature_map``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class DilatedInception(nn.Module):
    """Parallel dilated convolutions with kernels (2, 3, 6, 7), each
    ``out_channels / 4`` wide, concatenated over channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (2, 3, 6, 7),
                 dilation: int = 1):
        super().__init__()
        h = out_channels // len(kernel_sizes)
        self.kernel_sizes = tuple(kernel_sizes)
        self.dilation = dilation
        self.filters = nn.ModuleList(
            nn.Conv1d(in_channels, h, k, dilation=dilation)
            for k in self.kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for conv, k in zip(self.filters, self.kernel_sizes):
            total = self.dilation * (k - 1)
            outs.append(conv(F.pad(x, (total // 2, total - total // 2))))
        return torch.cat(outs, dim=1)


class GatedTCN(nn.Module):
    """tanh(filter) ⊙ sigmoid(gate), both dilated inceptions."""

    def __init__(self, h_dim: int, dilation: int):
        super().__init__()
        self.filt = DilatedInception(h_dim, h_dim, dilation=dilation)
        self.gate = DilatedInception(h_dim, h_dim, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.filt(x)) * torch.sigmoid(self.gate(x))


class WaveBlock(nn.Module):
    """1×1 in-conv, then ``n_layers`` of (gated TCN at dilation 2^l → 1×1
    skip conv), the skip outputs summed onto the in-conv's."""

    def __init__(self, in_channels: int, n_layers: int, h_dim: int):
        super().__init__()
        self.in_conv = nn.Conv1d(in_channels, h_dim, 1)
        self.gated_tcns = nn.ModuleList(GatedTCN(h_dim, 2 ** layer)
                                        for layer in range(n_layers))
        self.skip_convs = nn.ModuleList(nn.Conv1d(h_dim, h_dim, 1)
                                        for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        x_skip = x
        for tcn, skip in zip(self.gated_tcns, self.skip_convs):
            x = skip(tcn(x))
            x_skip = x_skip + x
        return x_skip


class DilatedInceptionWaveNet(nn.Module):
    """The full model: input (B, L, 8), the Chris-magic-8 bipolar channels
    in the order (LL₁, LL₂, RL₁, RL₂, LP₁, LP₂, RP₁, RP₂), or
    ``{"x": ...}``; output raw logits (B, n_classes)."""

    def __init__(self, n_classes: int = 6,
                 block_layers: Sequence[int] = (12, 8, 4, 1),
                 block_dims: Sequence[int] = (16, 32, 64, 64),
                 n_channels: int = 8):
        super().__init__()
        self.n_channels = n_channels
        ins = (1,) + tuple(block_dims[:-1])
        self.wave_module = nn.Sequential(*(
            WaveBlock(cin, n, h)
            for cin, n, h in zip(ins, block_layers, block_dims)))
        self.output = nn.Sequential(
            nn.Linear(n_channels // 2 * block_dims[-1], 64), nn.ReLU(),
            nn.Linear(64, n_classes))

    def features(self, inputs) -> torch.Tensor:
        """(B, L, n_channels) → the last block's map (B·n_channels, C, 1,
        L), channel c of window b at row b·n_channels + c."""
        x = inputs["x"] if isinstance(inputs, dict) else inputs
        b, length, n_ch = x.shape
        if n_ch != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channels, got {n_ch}")
        x = x.transpose(1, 2).reshape(b * n_ch, 1, length)
        return self.wave_module(x)[:, :, None, :]

    def head(self, feat: torch.Tensor) -> torch.Tensor:
        """The feature map → logits: global average pool, the mean of each
        channel pair (the brain regions), the dense head."""
        pooled = feat.mean(dim=(2, 3))                     # (B·n_ch, C)
        regions = pooled.reshape(-1, self.n_channels // 2, 2,
                                 pooled.shape[-1]).mean(dim=2)
        return self.output(regions.flatten(1))

    def forward(self, inputs) -> torch.Tensor:
        return self.head(self.features(inputs))
