"""Bipolar-montage differencing as one (C_out, C_in) matrix product over the
channel axis (counterpart of the JAX package's ``ops/montage.py``).

The montage matrices and the channel index are made on a device once per
(device, dtype) and kept: a forward copies nothing from the host, which a
captured CUDA graph requires (a pageable copy cannot be captured)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as C


def montage_matrix(pairs: Sequence[Tuple[str, str]],
                   columns: Sequence[str] = C.EEG_COLUMNS,
                   keep_originals: bool = True,
                   keep_channels: Optional[Sequence[str]] = None) -> np.ndarray:
    """The (C_out, C_in) montage matrix over ``columns``: the kept original
    channels (all of ``columns`` unless ``keep_channels``; none unless
    ``keep_originals``), then one row per bipolar pair with +1 at the first
    channel and −1 at the second."""
    f2i = C.feature_to_index(columns)
    rows = []
    if keep_originals:
        for ch in (keep_channels if keep_channels is not None else columns):
            row = np.zeros(len(columns), np.float32)
            row[f2i[ch]] = 1.0
            rows.append(row)
    for a, b in pairs:
        row = np.zeros(len(columns), np.float32)
        row[f2i[a]] += 1.0
        row[f2i[b]] -= 1.0
        rows.append(row)
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def _matrix_on(keep_channels: Optional[Tuple[str, ...]], device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(
        montage_matrix(C.MAP_FEATURES, keep_channels=keep_channels),
        dtype=dtype, device=device)


def apply_montage(x: torch.Tensor,
                  keep_channels: Optional[Tuple[str, ...]] = None
                  ) -> torch.Tensor:
    """``x``: (..., 20, T) → (..., C_out, T), the double-banana
    :func:`montage_matrix` keeping ``keep_channels`` (all 20 if None)."""
    return torch.matmul(_matrix_on(keep_channels, x.device, x.dtype), x)


def bipolar_differential(x: torch.Tensor) -> torch.Tensor:
    """Append the 18 double-banana differentials to the 20 raw rows:
    (..., 20, T) → (..., 38, T)."""
    return apply_montage(x)


@functools.lru_cache(maxsize=None)
def _channel_index_on(device: torch.device) -> torch.Tensor:
    n_cols = len(C.EEG_COLUMNS)
    f2i = {name: i for i, name in enumerate(C.EEG_COLUMNS)}
    idx = [f2i[ch] for ch in C.EEG_FEATURES] + list(
        range(n_cols, n_cols + len(C.MAP_FEATURES)))
    return torch.as_tensor(idx, device=device)


def select_and_map_channels(x: torch.Tensor) -> torch.Tensor:
    """Keep the 19 scalp channels + the 18 trailing differential rows:
    (..., 38, T) → (..., 37, T)."""
    return x[..., _channel_index_on(x.device), :]


@functools.lru_cache(maxsize=None)
def _magic8_on(columns: Tuple[str, ...], device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(
        montage_matrix(C.CHRIS_MAGIC_PAIRS, columns, keep_originals=False).T,
        dtype=dtype, device=device)


def chris_magic_ch8(x: torch.Tensor,
                    columns: Sequence[str] = C.EEG_FEATURES) -> torch.Tensor:
    """Chris' magic-8 bipolar features of ``x`` (..., T, C_in) with
    channels named by ``columns``: (..., T, 8)."""
    return torch.matmul(x, _magic8_on(tuple(columns), x.device, x.dtype))
