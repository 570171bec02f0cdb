"""Bipolar-montage differencing as one (C_out, C_in) matrix product over the
channel axis (counterpart of the JAX package's ``ops/montage.py``).

The montage matrices and the channel index of the default montage are made
on a device once per (device, dtype) and kept: a forward copies nothing
from the host, which a captured CUDA graph requires (a pageable copy
cannot be captured).  A caller's own matrix, columns or pairs are copied
to the device at each call."""

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


def _matmul(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` with TF32 off for float32 operands, whatever the caller's
    setting (the JAX package runs it at HIGHEST precision)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not torch.backends.cuda.matmul.allow_tf32:
        return torch.matmul(m, x)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(m, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def apply_montage(x: torch.Tensor, matrix) -> torch.Tensor:
    """Apply a montage matrix (C_out, C_in), a numpy array or a tensor, on
    x's device and in x's dtype: ``x`` (..., C_in, T) → (..., C_out, T)."""
    return _matmul(torch.as_tensor(matrix, dtype=x.dtype, device=x.device),
                   x)


@functools.lru_cache(maxsize=None)
def _matrix_on(keep_channels: Optional[Tuple[str, ...]], device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(
        montage_matrix(C.MAP_FEATURES, keep_channels=keep_channels),
        dtype=dtype, device=device)


def _double_banana(x: torch.Tensor,
                   keep_channels: Optional[Tuple[str, ...]] = None
                   ) -> torch.Tensor:
    """``x``: (..., 20, T) → (..., C_out, T), the double-banana
    :func:`montage_matrix` keeping ``keep_channels`` (all 20 if None), its
    matrix kept on the device: the serving path's, which leaves the TF32
    setting to the caller (off in PyTorch's default)."""
    return torch.matmul(_matrix_on(keep_channels, x.device, x.dtype), x)


def bipolar_differential(x: torch.Tensor,
                         columns: Sequence[str] = C.EEG_COLUMNS,
                         pairs: Sequence[Tuple[str, str]] = C.MAP_FEATURES,
                         ) -> torch.Tensor:
    """Append one differential a pair to the raw rows named by ``columns``:
    (..., C_in, T) → (..., C_in + len(pairs), T); by default the 18
    double-banana differentials to the 20 raw rows."""
    if tuple(columns) == tuple(C.EEG_COLUMNS) \
            and tuple(map(tuple, pairs)) == tuple(C.MAP_FEATURES):
        return _double_banana(x)
    return apply_montage(x, montage_matrix(pairs, columns))


def _channel_index(columns: Sequence[str], features: Sequence[str],
                   n_pairs: int) -> list:
    f2i = {name: i for i, name in enumerate(columns)}
    return [f2i[ch] for ch in features] + list(
        range(len(columns), len(columns) + n_pairs))


@functools.lru_cache(maxsize=None)
def _channel_index_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_channel_index(
        C.EEG_COLUMNS, C.EEG_FEATURES, len(C.MAP_FEATURES)), device=device)


def select_and_map_channels(x: torch.Tensor,
                            columns: Sequence[str] = C.EEG_COLUMNS,
                            features: Sequence[str] = C.EEG_FEATURES,
                            n_pairs: int = len(C.MAP_FEATURES)
                            ) -> torch.Tensor:
    """Keep the ``features`` channels (of the rows named by ``columns``)
    and the ``n_pairs`` trailing differential rows: (..., C_in + n_pairs,
    T) → (..., len(features) + n_pairs, T); by default the 19 scalp
    channels + 18 rows, 38 → 37."""
    if (tuple(columns), tuple(features), n_pairs) == (
            tuple(C.EEG_COLUMNS), tuple(C.EEG_FEATURES),
            len(C.MAP_FEATURES)):
        return x[..., _channel_index_on(x.device), :]
    idx = torch.as_tensor(_channel_index(columns, features, n_pairs),
                          device=x.device)
    return x[..., idx, :]


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
