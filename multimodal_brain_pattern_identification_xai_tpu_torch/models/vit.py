"""SpectrogramViT (counterpart of the JAX package's ``models/vit.py``):
ViT-B/16 over (400, 300) spectrograms — a VALID 16×16 patch conv (W floors
to 18: 25×18 = 450 patches), a class token, learned positional
embeddings, pre-LN encoder layers (LayerNorm eps 1e-6, tanh-GELU MLP, as
flax's ``nn.gelu``), a final LayerNorm and the class token's 6-way head.

Key layout: torchvision's ``vit_b_16`` (``conv_proj``, ``class_token``,
``encoder.pos_embedding``, ``encoder.layers.encoder_layer_{i}.{ln_1,
self_attention, ln_2, mlp.0, mlp.3}``, ``encoder.ln``), the layout the JAX
package's ``load_torch_vit_state_dict`` reads; the 6-class classifier
keeps the JAX name ``head``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout, MultiheadSelfAttention


class ViTEncoderLayer(nn.Module):
    """Pre-LN block: x + MHSA(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, dim: int, n_heads: int, mlp_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-6)
        self.self_attention = MultiheadSelfAttention(dim, n_heads, dropout)
        self.dropout = Dropout(dropout)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-6)
        # flax's nn.gelu is the tanh approximation
        self.mlp = nn.Sequential(nn.Linear(dim, mlp_dim),
                                 nn.GELU(approximate="tanh"),
                                 Dropout(dropout), nn.Linear(mlp_dim, dim),
                                 Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.self_attention(self.ln_1(x))
        x = x + self.dropout(h)
        return x + self.mlp(self.ln_2(x))


class _Encoder(nn.Module):
    def __init__(self, n_tokens: int, dim: int, depth: int, n_heads: int,
                 mlp_dim: int, dropout: float):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.randn(1, n_tokens, dim) * 0.02)
        self.dropout = Dropout(dropout)
        self.layers = nn.Sequential()
        for i in range(depth):
            self.layers.add_module(f"encoder_layer_{i}", ViTEncoderLayer(
                dim, n_heads, mlp_dim, dropout))
        self.ln = nn.LayerNorm(dim, eps=1e-6)

    def l2_extra(self) -> list:
        """The positional embedding (an ``embedding`` leaf in flax)."""
        return [self.pos_embedding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.layers(self.dropout(x + self.pos_embedding)))


class SpectrogramViT(nn.Module):
    """Input (B, 3, H, W) NCHW → (B, num_classes) log-probs; ``image_size``
    sets the patch grid and so the positional embedding's length."""

    def __init__(self, num_classes: int = 6,
                 image_size: Tuple[int, int] = (400, 300),
                 patch_size: int = 16, dim: int = 768, depth: int = 12,
                 n_heads: int = 12, mlp_dim: int = 3072,
                 dropout: float = 0.0):
        super().__init__()
        n_tokens = (image_size[0] // patch_size) * (image_size[1]
                                                    // patch_size) + 1
        self.conv_proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.encoder = _Encoder(n_tokens, dim, depth, n_heads, mlp_dim,
                                dropout)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_proj(x).flatten(2).transpose(1, 2)     # (B, N, D)
        x = torch.cat([self.class_token.expand(len(x), -1, -1), x], dim=1)
        x = self.encoder(x)
        return F.log_softmax(self.head(x[:, 0]), dim=-1)
