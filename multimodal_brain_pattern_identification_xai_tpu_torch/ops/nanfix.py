"""NaN repair as masked means (counterpart of the JAX package's
``ops/nanfix.py``): NaNs become the channel's mean over its valid values;
a channel with no valid value becomes all zeros."""

from __future__ import annotations

import torch


def nan_to_channel_mean(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Replace NaNs with the per-channel ``nanmean`` along ``axis``
    (all-NaN channels → 0, like the reference's
    ``mean_values[np.isnan(mean_values)] = 0``)."""
    valid = ~torch.isnan(x)
    cnt = valid.sum(dim=axis, keepdim=True)
    total = torch.where(valid, x, 0.0).sum(dim=axis, keepdim=True)
    mean = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
    return torch.where(valid, x, mean)
