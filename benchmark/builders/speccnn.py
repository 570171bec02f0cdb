"""``MultimodalModel(EEGNetAttentionRegularized, SpectrogramCNN)`` as the
port serves it: ``entry.build_model`` with the EEG stem reassociated for
inference and blocks 1 to ``prog["fused_blocks"]`` fused."""

from __future__ import annotations

from typing import Optional

import torch


def build(cfg: dict, prog: dict, dtype: Optional[torch.dtype]):
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry

    e, spec = cfg["eeg"], cfg["spectrogram"]
    model = entry.build_model(e["samples"], e["kern_length"], dtype=dtype,
                              fused_blocks=prog["fused_blocks"])
    branch = model.spectrogram_model
    for key in ("widths", "pools"):
        if list(getattr(branch, key)) != list(spec[key]):
            raise ValueError(f"the port's SpectrogramCNN has {key} "
                             f"{list(getattr(branch, key))}, the "
                             f"configuration states {spec[key]}")
    return model
