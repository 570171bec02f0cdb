"""ctypes facade over the port's C++ host library (``hostloader.cpp``,
counterpart of the JAX package's ``runtime/loader.py``).

:func:`gather_windows`, :func:`gather_multimodal` and
:class:`NativeBatchQueue` run in the library, which builds with ``g++`` at
first use (``_build.load_host``) and raises with the compiler's message
when it cannot: nothing falls back to numpy.  The ``*_numpy`` functions are
plain numpy versions of the same semantics, bitwise equal to the library,
for tests and comparisons; no path uses them.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .. import _build

SRC = Path(__file__).resolve().parent / "hostloader.cpp"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host(SRC)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, cint = ctypes.c_int64, ctypes.c_int
    lib.gather_windows.argtypes = [f32p, i64p, f32p, i64, i64, i64, cint]
    lib.gather_multimodal.argtypes = [f32p, i64p, f32p, i64p, i64p, i64p,
                                      i64p, f32p, f32p, i64, i64, i64, i64,
                                      i64, cint]
    lib.bq_create.restype = ctypes.c_void_p
    lib.bq_create.argtypes = [f32p, f32p, i64p, i64, i64, i64, i64, i64,
                              cint, cint]
    lib.bq_next.restype = cint
    lib.bq_next.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.bq_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the host library builds (or is built) and loads here: False,
    not an exception, without a compiler."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_out(what: str, out: Optional[np.ndarray], shape: tuple) -> None:
    """Hard checks, not asserts: the library writes through raw pointers,
    so a wrong buffer would corrupt memory silently."""
    if (out is None or out.shape != shape or out.dtype != np.float32
            or not out.flags.c_contiguous):
        got = None if out is None else (out.dtype, out.shape)
        raise ValueError(f"{what} out buffer must be C-contiguous float32 "
                         f"{shape}, got {got}")


# ---------------------------------------------------------------------------
# window gather

def gather_windows(src: np.ndarray, idx: np.ndarray,
                   n_threads: int = 4) -> np.ndarray:
    """``out[i] = src[idx[i]]`` with each channel's NaNs set to the mean
    of its finite values (0 for an all-NaN channel).  ``src``: (N, C, T)
    float32."""
    out = np.empty((len(idx), src.shape[1], src.shape[2]), np.float32)
    return gather_windows_into(src, idx, out, n_threads)


def gather_windows_into(src: np.ndarray, idx: np.ndarray, out: np.ndarray,
                        n_threads: int = 4) -> np.ndarray:
    """:func:`gather_windows` into a preallocated C-contiguous float32
    (B, C, T) buffer."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    B, C, T = len(idx), src.shape[1], src.shape[2]
    _check_out("window", out, (B, C, T))
    _lib().gather_windows(_f32p(src), _i64p(idx), _f32p(out), B, C, T,
                          int(n_threads))
    return out


def gather_windows_numpy(src: np.ndarray, idx: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`gather_windows` in numpy, bitwise: the mean is the library's
    sequential float64 sum of the finite values over their count, rounded
    to float32."""
    src = np.ascontiguousarray(src, np.float32)
    shape = (len(idx), src.shape[1], src.shape[2])
    if out is None:
        out = np.empty(shape, np.float32)
    _check_out("window", out, shape)
    np.take(src, np.asarray(idx, np.int64), axis=0, out=out)
    bad = np.isnan(out)
    cnt = (~bad).sum(-1, keepdims=True)
    tot = np.cumsum(np.where(bad, 0.0, out), axis=-1,
                    dtype=np.float64)[..., -1:]
    mean = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0).astype(np.float32)
    np.copyto(out, mean, where=bad)
    return out


# ---------------------------------------------------------------------------
# multimodal gather

def _multimodal_outs(eeg_src, spec_buf, B, width, out, want):
    C, T, F = eeg_src.shape[1], eeg_src.shape[2], spec_buf.shape[1]
    if out is None:
        return (np.empty((B, C, T), np.float32) if "eeg" in want else None,
                np.empty((B, F, width), np.float32) if "spec" in want
                else None)
    eeg, spec = out
    if "eeg" in want:
        _check_out("eeg", eeg, (B, C, T))
    if "spec" in want:
        _check_out("spec", spec, (B, F, width))
    return eeg, spec


def gather_multimodal(eeg_src: np.ndarray, eeg_idx: np.ndarray,
                      spec_buf: np.ndarray, spec_off: np.ndarray,
                      spec_len: np.ndarray, spec_idx: np.ndarray,
                      crop_start: np.ndarray, width: int = 300,
                      n_threads: int = 4,
                      out: Optional[Tuple[Optional[np.ndarray],
                                          Optional[np.ndarray]]] = None,
                      want: Sequence[str] = ("eeg", "spec")
                      ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """One combined raw batch from resident stores: the EEG windows
    ``eeg_src[eeg_idx]`` (U, C, T) → (B, C, T), and per row ``width`` time
    rows of the ragged spectrogram buffer (plane ``spec_idx[i]`` at rows
    ``spec_off``, ``spec_len`` long, (rows, F) time-major) from
    ``crop_start[i]``, transposed to (F, width) and zero-padded.

    A modality absent from ``want`` is neither copied nor allocated and
    comes back as None.  ``out``: a preallocated ``(eeg, spec)`` pair to
    fill instead of fresh arrays (None where not wanted)."""
    eeg_src = np.ascontiguousarray(eeg_src, np.float32)
    spec_buf = np.ascontiguousarray(spec_buf, np.float32)
    eeg_idx, spec_off, spec_len, spec_idx, crop_start = (
        np.ascontiguousarray(a, np.int64)
        for a in (eeg_idx, spec_off, spec_len, spec_idx, crop_start))
    B = len(eeg_idx)
    eeg, spec = _multimodal_outs(eeg_src, spec_buf, B, width, out, want)
    _lib().gather_multimodal(
        _f32p(eeg_src), _i64p(eeg_idx), _f32p(spec_buf), _i64p(spec_off),
        _i64p(spec_len), _i64p(spec_idx), _i64p(crop_start),
        _f32p(eeg) if "eeg" in want else None,
        _f32p(spec) if "spec" in want else None,
        B, eeg_src.shape[1], eeg_src.shape[2], spec_buf.shape[1], width,
        int(n_threads))
    return eeg, spec


def gather_multimodal_numpy(eeg_src, eeg_idx, spec_buf, spec_off, spec_len,
                            spec_idx, crop_start, width: int = 300,
                            n_threads: int = 4, out=None,
                            want: Sequence[str] = ("eeg", "spec")):
    """:func:`gather_multimodal` in numpy (``n_threads`` is ignored)."""
    eeg_src = np.ascontiguousarray(eeg_src, np.float32)
    spec_buf = np.ascontiguousarray(spec_buf, np.float32)
    B = len(eeg_idx)
    eeg, spec = _multimodal_outs(eeg_src, spec_buf, B, width, out, want)
    if "eeg" in want:
        np.take(eeg_src, np.asarray(eeg_idx, np.int64), axis=0, out=eeg)
    if "spec" in want:
        spec[:] = 0.0
        for i in range(B):
            s = spec_idx[i]
            plane = spec_buf[spec_off[s]:spec_off[s] + spec_len[s]]
            start = max(int(crop_start[i]), 0)
            avail = max(0, min(width, int(spec_len[s]) - start))
            if avail:
                spec[i, :, :avail] = plane[start:start + avail].T
    return eeg, spec


# ---------------------------------------------------------------------------
# the epoch batch queue

QUEUE_WORKERS = 2     # library threads assembling batches
QUEUE_CAPACITY = 4    # batches ready ahead of the consumer, at most

def epoch_order(n: int, batch_size: int, shuffle: bool = True,
                seed: int = 0) -> np.ndarray:
    """An epoch's sample order: ``default_rng(seed).shuffle`` of
    0..n-1 when ``shuffle``, cut to whole batches."""
    order = np.arange(n, dtype=np.int64)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order[:(n // batch_size) * batch_size]


class NativeBatchQueue:
    """One epoch of ``{"x": (B, C, T), "y": (B, n_classes)}`` float32
    batches over a resident store, assembled by :data:`QUEUE_WORKERS`
    threads of the host library ahead of the consumer (at most
    :data:`QUEUE_CAPACITY` ready)
    and published in the epoch's order (:func:`epoch_order`), each
    window's NaNs repaired as :func:`gather_windows` does.

    ``pop_ring`` > 0 cycles a ring of that many preallocated output pairs
    instead of fresh arrays: a yielded batch is valid only until
    ``pop_ring`` further batches have been drawn, so size it above the
    most batches the consumer holds at once."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0, pop_ring: int = 0):
        self.x = np.ascontiguousarray(x, np.float32)
        self.y = np.ascontiguousarray(y, np.float32)
        self.batch_size = batch_size
        self.order = epoch_order(len(x), batch_size, shuffle, seed)
        self.pop_ring = pop_ring

    def __len__(self) -> int:
        return len(self.order) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        lib = _lib()
        B = self.batch_size
        C, T = self.x.shape[1], self.x.shape[2]
        K = self.y.shape[1]
        ring = [(np.empty((B, C, T), np.float32), np.empty((B, K), np.float32))
                for _ in range(self.pop_ring)]
        handle = lib.bq_create(_f32p(self.x), _f32p(self.y),
                               _i64p(self.order), len(self.order), C, T, K,
                               B, QUEUE_WORKERS, QUEUE_CAPACITY)
        try:
            for k in range(len(self)):
                xb, yb = (ring[k % len(ring)] if ring else
                          (np.empty((B, C, T), np.float32),
                           np.empty((B, K), np.float32)))
                if not lib.bq_next(ctypes.c_void_p(handle), _f32p(xb),
                                   _f32p(yb)):
                    raise RuntimeError("host batch queue ended early")
                yield {"x": xb, "y": yb}
        finally:
            lib.bq_destroy(ctypes.c_void_p(handle))


def batch_queue_numpy(x: np.ndarray, y: np.ndarray, batch_size: int,
                      shuffle: bool = True, seed: int = 0
                      ) -> Iterator[dict]:
    """:class:`NativeBatchQueue`'s batches in numpy, fresh arrays each."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    order = epoch_order(len(x), batch_size, shuffle, seed)
    for s in range(0, len(order), batch_size):
        sel = order[s:s + batch_size]
        yield {"x": gather_windows_numpy(x, sel), "y": y[sel]}
