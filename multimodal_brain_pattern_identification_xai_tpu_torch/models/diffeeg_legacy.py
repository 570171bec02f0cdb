"""The reference's older DiffEEG denoiser (counterpart of the JAX
package's ``models/diffeeg_legacy.py``), kept with its quirks:

* sinusoidal step embedding + a 3-layer ReLU MLP, class embedding over the
  argmax of one-hot labels;
* spectrogram conditioning: two ``ConvTranspose2d(k=3, s=2, p=1)``
  upsamplers with ReLU and a 1×1 Conv2d, flattened to (B, H, F'·T') and
  added on the time axis, so F'·T' must equal T (F' = 4F−3, T' = 4Ts−3);
  any other shape raises ``ValueError``, as in JAX;
* four chained blocks conv1×1 → tanh → dilated conv3 → sigmoid → conv1×1
  → dropout (dilations 1/2/4/8; no residual add, tanh and sigmoid in
  series), then a 1×1 skip sum of the four and a 1×1 output projection;
* the step embedding broadcasts on the EEG time axis, like the JAX
  package's (the literal original only runs when Ts == T).

Parameter names are the reference's (``spectrogram_upconv{1,2}``,
``spectrogram_embed``, ``res_block{i}.{0,2,4}``, ``output_conv``, …).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .diffeeg import sinusoidal_embedding
from .layers import Dropout


def _legacy_block(channels: int, dilation: int,
                  dropout: float) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv1d(channels, channels, 1), nn.Tanh(),
        nn.Conv1d(channels, channels, 3, padding=dilation, dilation=dilation),
        nn.Sigmoid(), nn.Conv1d(channels, channels, 1), Dropout(dropout))


class DiffEEGLegacy(nn.Module):
    """Legacy noise predictor ε̂(x_t, class, t, spectrogram): x (B, C, T),
    y (B, n_classes) one-hot, t (B,), spec (B, C, F, Ts) with
    (4F−3)(4Ts−3) = T → (B, C, T)."""

    def __init__(self, n_classes: int = 6, n_channels: int = 19,
                 hidden: int = 32, dropout: float = 0.1):
        super().__init__()
        H = hidden
        self.hidden = hidden
        self.step_embedding_mlp = nn.Sequential(
            nn.Linear(H, H), nn.ReLU(), nn.Linear(H, H), nn.ReLU(),
            nn.Linear(H, H))
        self.class_embedding = nn.Embedding(n_classes, H)
        self.spectrogram_upconv1 = nn.ConvTranspose2d(
            n_channels, H // 2, 3, stride=2, padding=1)
        self.spectrogram_upconv2 = nn.ConvTranspose2d(
            H // 2, H, 3, stride=2, padding=1)
        self.spectrogram_embed = nn.Conv2d(H, H, 1)
        self.input_conv = nn.Conv1d(n_channels, H, 1)
        for i, dil in enumerate((1, 2, 4, 8), start=1):
            self.add_module(f"res_block{i}", _legacy_block(H, dil, dropout))
        self.skip_sum = nn.Conv1d(H, H, 1)
        self.output_conv = nn.Conv1d(H, n_channels, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                spec: torch.Tensor) -> torch.Tensor:
        B, _, T = x.shape
        se = self.step_embedding_mlp(sinusoidal_embedding(
            t.to(torch.promote_types(t.dtype, torch.float32)), self.hidden))
        ce = self.class_embedding(y.argmax(-1))
        s = torch.relu(self.spectrogram_upconv1(spec))
        s = torch.relu(self.spectrogram_upconv2(s))
        s = self.spectrogram_embed(s)                      # (B, H, F', T')
        L = s.shape[2] * s.shape[3]
        if L != T:
            raise ValueError(
                f"legacy DiffEEG shape contract: flattened upsampled "
                f"spectrogram length {s.shape[2]}x{s.shape[3]}={L} must "
                f"equal the EEG time dim {T} (pick Ts=(T+3)/4 with F=1)")
        h = (self.input_conv(x) + se[:, :, None] + ce[:, :, None]
             + s.reshape(B, self.hidden, L))
        x1 = self.res_block1(h)
        x2 = self.res_block2(x1)
        x3 = self.res_block3(x2)
        x4 = self.res_block4(x3)
        return self.output_conv(self.skip_sum(x1 + x2 + x3 + x4))
