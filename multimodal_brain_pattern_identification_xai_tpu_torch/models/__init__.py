"""Models of the serving slice (PyTorch, reference torch key layout)."""

from .eegnet import EEGNetAttentionRegularized
from .fusion import MultimodalModel
from .layers import (Attention, BatchNorm, Dropout, SpectrogramBlock,
                     dropout_generator)
from .speccnn import SpectrogramCNN
from .weights import jax_variables_to_state_dict, seeded_state_dict

__all__ = ["Attention", "BatchNorm", "Dropout", "EEGNetAttentionRegularized",
           "MultimodalModel", "SpectrogramBlock", "SpectrogramCNN",
           "dropout_generator", "jax_variables_to_state_dict",
           "seeded_state_dict"]
