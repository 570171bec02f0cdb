"""Late-fusion multimodal model (counterpart of the JAX package's
``models/fusion.py``): concatenate the EEG branch's and the spectrogram
branch's log-probs → FC128 → ReLU → FC → log-softmax.  ``forward_eeg`` and
``forward_spectrogram`` run one branch alone (the targets of per-branch
attribution).  Spans (:mod:`..profiling`): ``mbx.model.eeg_branch``,
``mbx.model.spec_branch`` and ``mbx.model.head``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..profiling import span


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
        return self.fuse(self.forward_eeg(eeg_data),
                         self.forward_spectrogram(spectrogram_data))

    def fuse(self, eeg_logp: torch.Tensor,
             spec_logp: torch.Tensor) -> torch.Tensor:
        """The head: both branches' log-probs → fused log-probs (B, 6)."""
        with span("mbx.model.head"):
            combined = torch.cat([eeg_logp, spec_logp], -1)
            return F.log_softmax(self.fc2(F.relu(self.fc1(combined))), dim=-1)

    def forward_eeg(self, eeg_data: torch.Tensor) -> torch.Tensor:
        """The EEG branch alone: (B, 1, 37, T) → log-probs (B, 6)."""
        with span("mbx.model.eeg_branch"):
            return self.eeg_model(eeg_data)

    def forward_spectrogram(self, spectrogram_data: torch.Tensor
                            ) -> torch.Tensor:
        """The spectrogram branch alone: (B, 3, H, W) → log-probs (B, 6)."""
        with span("mbx.model.spec_branch"):
            return self.spectrogram_model(spectrogram_data)
