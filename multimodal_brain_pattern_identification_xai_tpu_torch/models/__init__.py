"""The model zoo (PyTorch, reference torch key layouts), with a name
registry: the JAX package's ``models.REGISTRY`` and ``build``."""

from typing import Any, Callable, Dict

from .deepconvnet import DeepConvNet
from .diffeeg import (DiffEEG, DiffEEGSanityCheck, GTU, make_cached_denoiser,
                      recombine_spectrograms, sinusoidal_embedding)
from .diffeeg_legacy import DiffEEGLegacy
from .eegnet import (EEGNet, EEGNetAttentionDeep, EEGNetAttentionRegularized,
                     EEGNetResidual, EEGNetResidualLSTM, EEGNetTransformer,
                     EEGSeizureDetectionModel)
from .efficientnet import EfficientNetB0, EfficientNetV2B2
from .fusion import MultimodalModel
from .layers import (Attention, BatchNorm, BiLSTM, Dropout, LSTM,
                     MultiheadSelfAttention, SpectrogramBlock,
                     TransformerEncoderLayer, dropout_generator)
from .speccnn import SpectrogramCNN
from .torch_import import (load_torch_diffeeg_legacy_state_dict,
                           load_torch_diffeeg_state_dict,
                           load_torch_eegnet_attention_state_dict,
                           load_torch_eegnet_state_dict,
                           load_torch_efficientnet_state_dict,
                           load_torch_multimodal_state_dict,
                           load_torch_speccnn_state_dict,
                           load_torch_vit_state_dict)
from .vit import SpectrogramViT
from .wavenet import (DilatedInception, DilatedInceptionWaveNet,
                      GatedTCN, WaveBlock)
from .weights import jax_variables_to_state_dict, seeded_state_dict

#: name → constructor, for config-driven model selection
REGISTRY: Dict[str, Callable[..., Any]] = {
    "eegnet": EEGNet,
    "eegnet_attention_deep": EEGNetAttentionDeep,
    "eegnet_attention_regularized": EEGNetAttentionRegularized,
    "eegnet_residual": EEGNetResidual,
    "eegnet_residual_lstm": EEGNetResidualLSTM,
    "eegnet_transformer": EEGNetTransformer,
    "eeg_seizure_detection": EEGSeizureDetectionModel,
    "deepconvnet": DeepConvNet,
    "wavenet": DilatedInceptionWaveNet,
    "spectrogram_cnn": SpectrogramCNN,
    "spectrogram_vit": SpectrogramViT,
    "efficientnet_b0": EfficientNetB0,
    "efficientnetv2_b2": EfficientNetV2B2,
    "diffeeg": DiffEEG,
    "diffeeg_legacy": DiffEEGLegacy,
}


def build(name: str, **kwargs: Any) -> Any:
    """Instantiate a model by registry name."""
    try:
        return REGISTRY[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")


__all__ = ["Attention", "BatchNorm", "BiLSTM", "DeepConvNet", "DiffEEG",
           "DiffEEGLegacy", "DiffEEGSanityCheck", "DilatedInception",
           "DilatedInceptionWaveNet", "Dropout", "EEGNet",
           "EEGNetAttentionDeep", "EEGNetAttentionRegularized",
           "EEGNetResidual", "EEGNetResidualLSTM", "EEGNetTransformer",
           "EEGSeizureDetectionModel", "EfficientNetB0", "EfficientNetV2B2",
           "GTU", "GatedTCN", "LSTM", "MultiheadSelfAttention",
           "MultimodalModel",
           "REGISTRY", "SpectrogramBlock", "SpectrogramCNN", "SpectrogramViT",
           "TransformerEncoderLayer", "WaveBlock", "build",
           "dropout_generator", "jax_variables_to_state_dict",
           "load_torch_diffeeg_legacy_state_dict",
           "load_torch_diffeeg_state_dict",
           "load_torch_eegnet_attention_state_dict",
           "load_torch_eegnet_state_dict",
           "load_torch_efficientnet_state_dict",
           "load_torch_multimodal_state_dict", "load_torch_speccnn_state_dict",
           "load_torch_vit_state_dict", "make_cached_denoiser",
           "recombine_spectrograms", "seeded_state_dict",
           "sinusoidal_embedding"]
