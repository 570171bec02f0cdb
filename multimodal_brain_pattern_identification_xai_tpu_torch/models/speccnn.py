"""Spectrogram 2D-CNN (counterpart of the JAX package's
``models/speccnn.py``): five conv blocks with pooled skip connections →
global average pool → FC → log-softmax."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import SpectrogramBlock

WIDTHS = (16, 32, 64, 128, 256)
POOLS = ("max", "avg", "max", "avg", "max")
N_CLASSES = 6


class SpectrogramCNN(nn.Module):
    """Input (B, 3, H, W) NCHW → (B, num_classes) log-probs, through one
    block a width of ``widths`` (pooling by ``pools``).

    ``fused_blocks=N`` serves the first N blocks through the fused
    conv×3+pool kernel in eval mode; the parameters are those of the
    unfused model.

    ``dtype=torch.bfloat16`` is the JAX model's bf16 serving mode: the
    input is cast to bf16 and every block runs in bf16 (fused blocks on the
    bf16 kernel); the global average pool is cast to float32, and the FC
    and log-softmax run in float32.  The parameters and the state dict are
    those of the float32 model."""

    def __init__(self, fused_blocks: int = 0,
                 dtype: Optional[torch.dtype] = None,
                 num_classes: int = N_CLASSES,
                 widths: Sequence[int] = WIDTHS,
                 pools: Sequence[str] = POOLS):
        super().__init__()
        self.dtype = dtype
        self.widths, self.pools = tuple(widths), tuple(pools)
        cin = 3
        for i, (w, p) in enumerate(zip(self.widths, self.pools)):
            self.add_module(f"block{i+1}", SpectrogramBlock(
                cin, w, pool_type=p, fused=i < fused_blocks, dtype=dtype))
            cin = w
        self.fc = nn.Linear(cin, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Every block: the feature map (B, widths[-1], H', W') that
        Grad-CAM reads (the JAX model's ``sow("feature_map")``), in
        ``dtype``."""
        for i in range(len(self.widths)):
            x = getattr(self, f"block{i+1}")(x)
        return x

    def head(self, a: torch.Tensor) -> torch.Tensor:
        """Feature map → global average pool (float32 accumulation, cast
        to float32; a float64 model stays float64) → FC → log-probs."""
        pooled = a.mean(dim=(2, 3))
        return F.log_softmax(self.fc(pooled.to(
            torch.promote_types(pooled.dtype, torch.float32))), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))
