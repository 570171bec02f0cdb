"""Late-fusion multimodal model (counterpart of the JAX package's
``models/fusion.py``): concatenate the EEG branch's and the spectrogram
branch's log-probs → FC128 → ReLU → FC → log-softmax.  ``forward_eeg`` and
``forward_spectrogram`` run one branch alone (the targets of per-branch
attribution)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class MultimodalModel(nn.Module):
    def __init__(self, eeg_model: nn.Module, spectrogram_model: nn.Module,
                 num_classes: int = 6):
        super().__init__()
        self.eeg_model = eeg_model
        self.spectrogram_model = spectrogram_model
        self.fc1 = nn.Linear(2 * 6, 128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, eeg_data: torch.Tensor,
                spectrogram_data: torch.Tensor) -> torch.Tensor:
        combined = torch.cat([self.eeg_model(eeg_data),
                              self.spectrogram_model(spectrogram_data)], -1)
        return F.log_softmax(self.fc2(F.relu(self.fc1(combined))), dim=-1)

    def forward_eeg(self, eeg_data: torch.Tensor) -> torch.Tensor:
        """The EEG branch alone: (B, 1, 37, T) → log-probs (B, 6)."""
        return self.eeg_model(eeg_data)

    def forward_spectrogram(self, spectrogram_data: torch.Tensor
                            ) -> torch.Tensor:
        """The spectrogram branch alone: (B, 3, H, W) → log-probs (B, 6)."""
        return self.spectrogram_model(spectrogram_data)
