"""Host window gather (the numpy path of the JAX package's
``runtime/loader.py``; its native ``hostloader.cpp`` library is not ported
yet)."""

from __future__ import annotations

import numpy as np


def gather_windows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``out[i] = src[idx[i]]`` with per-channel NaN → mean repair
    (an all-NaN channel becomes 0).  ``src``: (N, C, T) float32."""
    out = np.empty((len(idx), src.shape[1], src.shape[2]), np.float32)
    return gather_windows_into(src, idx, out)


def gather_windows_into(src: np.ndarray, idx: np.ndarray,
                        out: np.ndarray) -> np.ndarray:
    """:func:`gather_windows` into a preallocated C-contiguous float32
    (B, C, T) buffer."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    shape = (len(idx), src.shape[1], src.shape[2])
    if (out.shape != shape or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f"out buffer must be C-contiguous float32 {shape}, "
                         f"got {out.dtype} {out.shape}")
    np.take(src, idx, axis=0, out=out)
    mean = np.nanmean(out, axis=-1, keepdims=True)
    mean = np.where(np.isnan(mean), 0.0, mean)
    np.copyto(out, np.where(np.isnan(out), mean, out))
    return out
