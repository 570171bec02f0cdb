"""Host window gather and the epoch batch queue (the numpy paths of the
JAX package's ``runtime/loader.py``; its native ``hostloader.cpp`` library
is not ported yet)."""

from __future__ import annotations

from typing import Iterator

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


class NativeBatchQueue:
    """One epoch of ``{"x": (B, C, T), "y": (B, n_classes)}`` float32
    batches over a resident store, in the JAX package's order: the sample
    order shuffled by ``default_rng(seed).shuffle`` (when ``shuffle``),
    the last partial batch dropped, and each window's NaNs repaired
    (:func:`gather_windows`).  The numpy path only.

    ``pop_ring`` > 0 cycles a ring of that many preallocated output pairs
    instead of fresh arrays: a yielded batch is valid only until
    ``pop_ring`` further batches have been drawn, so size it above the
    most batches the consumer holds at once."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, pop_ring: int = 0):
        self.x = np.ascontiguousarray(x, np.float32)
        self.y = np.ascontiguousarray(y, np.float32)
        self.batch_size = batch_size
        order = np.arange(len(x), dtype=np.int64)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        self.order = order[:(len(order) // batch_size) * batch_size]
        self.pop_ring = pop_ring

    def __len__(self) -> int:
        return len(self.order) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        B = self.batch_size
        C, T = self.x.shape[1], self.x.shape[2]
        ring = [(np.empty((B, C, T), np.float32),
                 np.empty((B, self.y.shape[1]), np.float32))
                for _ in range(self.pop_ring)]
        for k, s in enumerate(range(0, len(self.order), B)):
            sel = self.order[s:s + B]
            if ring:
                xb, yb = ring[k % len(ring)]
                gather_windows_into(self.x, sel, xb)
                np.take(self.y, sel, axis=0, out=yb)
                yield {"x": xb, "y": yb}
            else:
                yield {"x": gather_windows(self.x, sel), "y": self.y[sel]}
