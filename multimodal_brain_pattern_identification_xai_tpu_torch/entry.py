"""Serving entry point: raw EEG + raw spectrogram → log-probs.

Counterpart of ``__graft_entry__.entry()``: preprocessing of both branches
then the late-fusion ``MultimodalModel(EEGNetAttentionRegularized,
SpectrogramCNN)``, with the first two spectrogram blocks served through the
fused conv×3+pool kernel.  :func:`explain_entry` gives the same model and
preprocessed inputs ready for attribution (``xai``).  Runs on CUDA unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import config as C
from . import resolve_device
from .models import (EEGNetAttentionRegularized, MultimodalModel,
                     SpectrogramCNN, seeded_state_dict)
from .ops import preprocess_multimodal

#: spectrogram blocks served by the fused kernel on the serving path
FUSED_BLOCKS = 2


def build_model(samples: int = 3000, kern_length: int = 64
                ) -> MultimodalModel:
    """The serving model in eval mode, on the CPU, default-initialised
    (load weights with ``load_state_dict``)."""
    model = MultimodalModel(
        EEGNetAttentionRegularized(samples=samples, kern_length=kern_length),
        SpectrogramCNN(fused_blocks=FUSED_BLOCKS))
    return model.eval()


def make_forward(model: MultimodalModel,
                 signal: C.SignalConfig = C.SignalConfig(),
                 assume_finite: bool = False
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``forward(raw_eeg (B, 20, T), raw_spec (B, H, W)) → (B, 6)``
    log-probs, on the device of the model and inputs."""
    def forward(raw_eeg: torch.Tensor, raw_spec: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            eeg_in, spec_in = preprocess_multimodal(
                raw_eeg, raw_spec, signal=signal, assume_finite=assume_finite)
            return model(eeg_in, spec_in)
    return forward


def _seeded(device, batch: int, seed: int):
    """The serving model with weights drawn from ``seed`` on ``device``,
    and seeded raw inputs: EEG (batch, 20, 10000) µV and spectrograms
    (batch, 400, 300)."""
    dev = resolve_device(device)
    model = build_model()
    model.load_state_dict(seeded_state_dict(model, seed))
    model.to(dev)
    rng = np.random.default_rng(seed)
    raw_eeg = torch.as_tensor(rng.standard_normal((batch, 20, 10_000)) * 40,
                              dtype=torch.float32, device=dev)
    raw_spec = torch.as_tensor(rng.standard_normal((batch, 400, 300)) * 5,
                               dtype=torch.float32, device=dev)
    return model, raw_eeg, raw_spec


def entry(device: Optional[Union[str, torch.device]] = None, batch: int = 4,
          assume_finite: bool = False, seed: int = 0
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """Return ``(forward, (raw_eeg, raw_spec))``: the full-size serving
    forward with weights drawn from ``seed``, and seeded raw inputs —
    EEG (batch, 20, 10000) µV and spectrograms (batch, 400, 300).
    ``assume_finite=False`` (the default, as the JAX entry) runs the
    NaN-bearing EEG route."""
    model, raw_eeg, raw_spec = _seeded(device, batch, seed)
    return make_forward(model, assume_finite=assume_finite), (raw_eeg, raw_spec)


def explain_entry(device: Optional[Union[str, torch.device]] = None,
                  batch: int = 4, seed: int = 0
                  ) -> Tuple[MultimodalModel, Tuple[torch.Tensor, torch.Tensor]]:
    """Return ``(model, (eeg_in, spec_in))`` for attribution: the serving
    model of :func:`entry` (eval mode, fused blocks 1-2, weights from
    ``seed``) with its parameters frozen — attribution needs only input
    gradients — and the seeded raw inputs preprocessed (under
    ``no_grad``, NaN-safe EEG route): EEG (batch, 1, 37, 3000) and
    spectrograms (batch, 3, 400, 300).  ``make_forward``'s inference mode
    makes tensors that autograd cannot use, so this entry has its own."""
    model, raw_eeg, raw_spec = _seeded(device, batch, seed)
    model.requires_grad_(False)
    with torch.no_grad():
        eeg_in, spec_in = preprocess_multimodal(raw_eeg, raw_spec)
    return model, (eeg_in, spec_in)
