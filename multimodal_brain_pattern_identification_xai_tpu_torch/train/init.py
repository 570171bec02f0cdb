"""Weight initialisation (counterpart of the JAX package's
``train/init.py``): the reference's ``initialize_kaiming_weights``."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.layers import BatchNorm


@torch.no_grad()
def initialize_kaiming_weights(model: nn.Module,
                               generator: torch.Generator) -> nn.Module:
    """Re-initialise ``model`` in place: He-normal fan-out weights (std
    √(2/fan_out), fan_out = output channels × receptive field) on every
    ``nn.Conv2d`` and ``nn.Linear``, zero biases, BatchNorm scale 1 and
    bias 0 (running statistics untouched).  Draws come from ``generator``
    (a CPU generator; values are copied to the model's device) in module
    order.  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_out = w.shape[0] * (w[0, 0].numel() if w.dim() > 2 else 1)
            std = (2.0 / max(fan_out, 1)) ** 0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model
