"""Reference and torchvision state dicts into the port's modules
(counterpart of the JAX package's ``models/torch_import.py``).

The port's modules keep the reference's torch key layout (torchvision's
for ``SpectrogramViT`` and ``EfficientNetB0``), so an importer copies each
tensor by its own key.  What each one imports, and what it leaves as the
module has it, is what the JAX package's importer does:

* ViT: everything but the positional embedding (the reference draws it
  anew for its 400x300 grid) and the classification head (torchvision's
  ``heads.head``; the port's 6-way ``head``);
* EfficientNet-B0: the classifier only where its width is the module's
  (the reference replaces ImageNet's 1000-way head);
* SpectrogramCNN: blocks 1..``n_blocks`` and ``fc``;
* the rest: every tensor of the module.

BatchNorm's ``num_batches_tracked`` counters and any key the module does
not have are ignored.  Each importer loads in place and returns the
module.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def _tensor(v: Any) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().cpu()
    return torch.from_numpy(np.asarray(v))


def _load(state_dict: Mapping[str, Any], model: nn.Module,
          keep: Callable[[str], bool] = lambda k: False) -> nn.Module:
    """Copy ``state_dict[k]`` into every tensor ``k`` of ``model`` except
    those ``keep(k)`` leaves as they are; a missing key or another shape
    raises."""
    own = model.state_dict()
    for k, t in own.items():
        if keep(k):
            continue
        if k not in state_dict:
            raise KeyError(f"{type(model).__name__}: {k} missing from the "
                           f"state dict")
        src = _tensor(state_dict[k])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{type(model).__name__}: {k} has shape "
                             f"{tuple(src.shape)}, the module "
                             f"{tuple(t.shape)}")
        own[k] = src.to(t.dtype)
    model.load_state_dict(own)
    return model


def load_torch_vit_state_dict(state_dict: Mapping[str, Any],
                              model: nn.Module,
                              depth: Optional[int] = None) -> nn.Module:
    """A torchvision ``vit_b_16`` state dict into ``SpectrogramViT``: the
    patch projection, class token, every encoder layer and the final
    LayerNorm; not ``encoder.pos_embedding`` nor the head.  ``depth``, if
    given, must be the module's."""
    n = len(model.encoder.layers)
    if depth is not None and depth != n:
        raise ValueError(f"depth {depth}, the module has {n} layers")
    return _load(state_dict, model, lambda k: k == "encoder.pos_embedding"
                 or k.startswith("head."))


def _check_eegnet(state_dict: Mapping[str, Any], prefix: str, f1: int,
                  d: int) -> None:
    w = _tensor(state_dict[f"{prefix}depthwiseConv.weight"])
    if w.shape[0] != f1 * d:
        raise ValueError(f"depthwiseConv has {w.shape[0]} filters, "
                         f"f1·d = {f1 * d}")


def load_torch_eegnet_state_dict(state_dict: Mapping[str, Any],
                                 model: nn.Module, f1: int = 8,
                                 d: int = 2) -> nn.Module:
    """A reference ``EEGNet`` state dict (conv1, batchnorm1,
    depthwiseConv, batchnorm2, separableConv, batchnorm3, dense) into
    ``EEGNet``; ``f1`` and ``d`` are checked against depthwiseConv."""
    _check_eegnet(state_dict, "", f1, d)
    return _load(state_dict, model)


def load_torch_eegnet_attention_state_dict(state_dict: Mapping[str, Any],
                                           model: nn.Module, f1: int = 8,
                                           d: int = 2) -> nn.Module:
    """A reference ``EEGNetAttentionRegularized`` state dict (the EEGNet
    stem, ``attention_layer.{query,key,value}``, dense1, dense2)."""
    _check_eegnet(state_dict, "", f1, d)
    return _load(state_dict, model)


def load_torch_speccnn_state_dict(state_dict: Mapping[str, Any],
                                  model: nn.Module,
                                  n_blocks: int = 5) -> nn.Module:
    """A reference ``Spectrogram_Model`` state dict (blockN.conv1-3,
    blockN.bn, blockN.conv1x1, fc) into ``SpectrogramCNN``, fused blocks
    or not: blocks 1..``n_blocks`` and ``fc``."""
    imported = tuple(f"block{i + 1}." for i in range(n_blocks)) + ("fc.",)
    return _load(state_dict, model, lambda k: not k.startswith(imported))


def load_torch_multimodal_state_dict(state_dict: Mapping[str, Any],
                                     model: nn.Module, f1: int = 8,
                                     d: int = 2) -> nn.Module:
    """A reference combined ``MultimodalModel`` state dict
    (``eeg_model.*``, ``spectrogram_model.*``, fc1, fc2)."""
    _check_eegnet(state_dict, "eeg_model.", f1, d)
    return _load(state_dict, model)


def load_torch_efficientnet_state_dict(state_dict: Mapping[str, Any],
                                       model: nn.Module) -> nn.Module:
    """A torchvision ``efficientnet_b0`` state dict into
    ``EfficientNetB0``; ``classifier.1`` only where its output width is
    the module's."""
    head = model.classifier[1].weight.shape
    match = tuple(_tensor(state_dict["classifier.1.weight"]).shape) \
        == tuple(head)
    return _load(state_dict, model,
                 lambda k: k.startswith("classifier.") and not match)


def load_torch_diffeeg_state_dict(state_dict: Mapping[str, Any],
                                  model: nn.Module) -> nn.Module:
    """A reference ``DiffEEG`` denoiser state dict (a checkpoint's
    ``model`` or ``ema`` entry) into ``DiffEEG``."""
    return _load(state_dict, model)


def load_torch_diffeeg_legacy_state_dict(state_dict: Mapping[str, Any],
                                         model: nn.Module) -> nn.Module:
    """A state dict of the reference's legacy DiffEEG variant into
    ``DiffEEGLegacy``."""
    return _load(state_dict, model)
