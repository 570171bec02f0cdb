"""Models of the ported slices (PyTorch, reference torch key layout)."""

from .diffeeg import (DiffEEG, DiffEEGSanityCheck, make_cached_denoiser,
                      recombine_spectrograms)
from .diffeeg_legacy import DiffEEGLegacy
from .eegnet import EEGNetAttentionRegularized
from .fusion import MultimodalModel
from .layers import (Attention, BatchNorm, Dropout, SpectrogramBlock,
                     dropout_generator)
from .speccnn import SpectrogramCNN
from .wavenet import (DilatedInception, DilatedInceptionWaveNet,
                      GatedTCN, WaveBlock)
from .weights import jax_variables_to_state_dict, seeded_state_dict

__all__ = ["Attention", "BatchNorm", "DiffEEG", "DiffEEGLegacy",
           "DiffEEGSanityCheck", "DilatedInception",
           "DilatedInceptionWaveNet", "Dropout",
           "EEGNetAttentionRegularized", "GatedTCN", "MultimodalModel",
           "SpectrogramBlock", "SpectrogramCNN", "WaveBlock",
           "dropout_generator", "jax_variables_to_state_dict",
           "make_cached_denoiser", "recombine_spectrograms",
           "seeded_state_dict"]
