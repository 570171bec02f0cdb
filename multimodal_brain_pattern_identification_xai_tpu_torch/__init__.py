"""PyTorch/CUDA port of the multimodal brain-pattern identification system.

The serving forward (raw EEG + raw spectrogram → log-probs, ``entry``),
input-gradient XAI on the served model (``xai``, ``entry.
explain_entry``), the multimodal training path (``train``, ``data``,
``entry.train_entry`` and ``entry.train_multimodal``) and the DiffEEG
diffusion path (``diffusion``, ``entry.train_diffeeg`` and
``entry.generate``) and the real-data paths (``data.hms``, the C++ host
loader in ``runtime``, ``models.DilatedInceptionWaveNet``,
``entry.train_wavenet`` and ``entry.grid_search``) run on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/``); every kernel has
a plain PyTorch version beside it that CPU tensors take.  The parallel
programs (``parallel``: data-parallel training, tensor and sequence
parallelism, the multichip dry run ``entry.dryrun_multichip``, sharded
attribution in ``xai.sharded``) run one process a rank over
``torch.distributed``: NCCL on the cards, gloo on the CPU.
Imports ``torch``, numpy and scipy only; pandas only in the parquet
readers and the fixtures that write parquet or frames (``data.loader``,
``data.dummy``), when they are called.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import config

__all__ = ["config", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no card is present — an entry point never moves to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
