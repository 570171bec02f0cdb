"""``MultimodalModel(EEGNetAttentionRegularized, EfficientNetV2B2)``
composed from the port's modules: ``entry.build_model`` builds only the
spectrogram CNN.  ``EfficientNetV2B2`` has one precision, float32."""

from __future__ import annotations

from typing import Optional

import torch


def build(cfg: dict, prog: dict, dtype: Optional[torch.dtype]):
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        EEGNetAttentionRegularized, EfficientNetV2B2, MultimodalModel)

    if dtype is not None or prog.get("fused_blocks", 0):
        raise ValueError("the port's EfficientNetV2B2 runs in float32 with "
                         "no fused block")
    e, n = cfg["eeg"], cfg["num_classes"]
    return MultimodalModel(
        EEGNetAttentionRegularized(nb_classes=n, samples=e["samples"],
                                   kern_length=e["kern_length"]),
        EfficientNetV2B2(num_classes=n), num_classes=n).eval()
