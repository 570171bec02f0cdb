"""Decimation and padding primitives (counterpart of the JAX package's
``ops/resample.py``): the reference's ``denoise_filter`` tail (4-tap
rolling mean with *flattened* ``np.roll`` semantics, then ``[:, 0:-1:4]``)
and ``pad_or_truncate``."""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F


def decimate(x: torch.Tensor, stride: int,
             drop_last: bool = False) -> torch.Tensor:
    """Strided decimation of the last axis. ``drop_last=True`` reproduces
    the reference's ``y[:, 0:-1:4]`` (drops the final sample first)."""
    if drop_last:
        x = x[..., :-1]
    return x[..., ::stride]


def rolling_mean4_flat(x: torch.Tensor) -> torch.Tensor:
    """``(y + roll(y,-1) + roll(y,-2) + roll(y,-3)) / 4`` where the roll is
    over each flattened trailing (C, T) plane, as the reference's axis-less
    ``np.roll``: the tail of each channel wraps into the head of the next."""
    xf = x.reshape(x.shape[:-2] + (-1,))
    y = (xf + torch.roll(xf, -1, -1) + torch.roll(xf, -2, -1)
         + torch.roll(xf, -3, -1)) / 4.0
    return y.reshape(x.shape)


def rolling_mean4_decimate_flat(x: torch.Tensor,
                                stride: int = 4) -> torch.Tensor:
    """``rolling_mean4_flat`` then ``decimate(stride, drop_last=True)``.

    With T % stride == 0 the kept samples are the flat indices ≡ 0 (mod
    stride) and their windows never leave the channel, so the result is a
    window-4, stride-``stride`` mean over each flat plane (with the
    3-sample wrap appended).  Otherwise the flat-roll post-pass runs."""
    C, T = x.shape[-2], x.shape[-1]
    if T % stride != 0:
        return decimate(rolling_mean4_flat(x), stride, drop_last=True)
    lead = x.shape[:-2]
    xf = x.reshape(-1, 1, C * T)
    xf = torch.cat([xf, xf[..., :3]], dim=-1)             # flat wrap
    win = torch.full((1, 1, 4), 0.25, dtype=x.dtype, device=x.device)
    y = F.conv1d(xf, win, stride=stride)
    return y.reshape(lead + (C, T // stride))


def pad_or_truncate(x: torch.Tensor,
                    target: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Zero-pad or truncate to a fixed length (``int``: last axis) or 2-D
    shape (tuple: last two axes)."""
    if isinstance(target, int):
        T = x.shape[-1]
        if T < target:
            return F.pad(x, (0, target - T))
        return x[..., :target]
    rows, cols = target
    R, Ccur = x.shape[-2], x.shape[-1]
    x = F.pad(x, (0, 0, 0, rows - R)) if R < rows else x[..., :rows, :]
    x = F.pad(x, (0, cols - Ccur)) if Ccur < cols else x[..., :, :cols]
    return x
