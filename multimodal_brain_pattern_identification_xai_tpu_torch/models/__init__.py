"""Models of the serving slice (PyTorch, reference torch key layout)."""

from .eegnet import EEGNetAttentionRegularized
from .fusion import MultimodalModel
from .layers import Attention, BatchNorm, SpectrogramBlock
from .speccnn import SpectrogramCNN
from .weights import jax_variables_to_state_dict, seeded_state_dict

__all__ = ["Attention", "BatchNorm", "EEGNetAttentionRegularized",
           "MultimodalModel", "SpectrogramBlock", "SpectrogramCNN",
           "jax_variables_to_state_dict", "seeded_state_dict"]
