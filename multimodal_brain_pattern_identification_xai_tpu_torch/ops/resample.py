"""Decimation, padding and resize primitives (counterpart of the JAX
package's ``ops/resample.py``): the reference's ``denoise_filter`` tail
(4-tap rolling mean with *flattened* ``np.roll`` semantics, then
``[:, 0:-1:4]``), ``pad_or_truncate`` and the anti-aliased resize.

The resize operators are made on a device once per (n_in, n_out, device,
dtype): a forward copies nothing from the host (see :mod:`.montage`)."""

from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def decimate(x: torch.Tensor, stride: int, axis: int = -1,
             drop_last: bool = False) -> torch.Tensor:
    """Strided decimation along ``axis``. ``drop_last=True`` reproduces the
    reference's ``y[:, 0:-1:4]`` (drops the final sample first)."""
    x = x.movedim(axis, -1)
    if drop_last:
        x = x[..., :-1]
    return x[..., ::stride].movedim(-1, axis)


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


def _mirror_index(i: np.ndarray, n: int) -> np.ndarray:
    """ndimage 'mirror' boundary (skimage mode='reflect'): reflect about the
    edge pixel centres without repeating them, period 2n-2."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


@functools.lru_cache(maxsize=16)
def _resize_matrix_1d(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) float64 operator of skimage ``resize(...,
    order=1, mode='reflect', anti_aliasing=True)`` along one axis: a
    scipy-exact Gaussian prefilter (sigma = max(0, (n_in/n_out - 1)/2),
    truncate 4.0, mirror boundary) composed with linear interpolation at
    half-pixel centres.  Both stages are convex combinations, so skimage's
    clip to the input range is a no-op and is left out."""
    factor = n_in / n_out
    coords = (np.arange(n_out) + 0.5) * factor - 0.5
    i0 = np.floor(coords).astype(np.int64)
    w = coords - i0
    A = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(A, (rows, _mirror_index(i0, n_in)), 1.0 - w)
    np.add.at(A, (rows, _mirror_index(i0 + 1, n_in)), w)
    sigma = max(0.0, (factor - 1.0) / 2.0)
    if sigma > 0:
        r = int(4.0 * sigma + 0.5)
        t = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-0.5 * (t / sigma) ** 2)
        k /= k.sum()
        G = np.zeros((n_in, n_in), np.float64)
        rows_in = np.arange(n_in)
        for off, kv in zip(range(-r, r + 1), k):
            np.add.at(G, (rows_in, _mirror_index(rows_in + off, n_in)), kv)
        A = A @ G
    return A


@functools.lru_cache(maxsize=16)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """:func:`_resize_matrix_1d` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(_resize_matrix_1d(n_in, n_out), dtype=dtype,
                           device=device)


def resize_antialiased(x: torch.Tensor,
                       target: Tuple[int, int]) -> torch.Tensor:
    """Anti-aliased bilinear resize of the last two axes (skimage
    ``resize(x, target, mode='reflect', anti_aliasing=True)``) as two
    matmuls with the separable operators of :func:`_resize_matrix_1d`.
    A same-shape call returns ``x`` itself."""
    rows, cols = int(target[0]), int(target[1])
    R, Ccur = x.shape[-2], x.shape[-1]
    if (R, Ccur) == (rows, cols):
        return x
    m_h = _resize_matrix_on(R, rows, x.device, x.dtype)
    m_w = _resize_matrix_on(Ccur, cols, x.device, x.dtype)
    return torch.matmul(m_h, torch.matmul(x, m_w.T))


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
