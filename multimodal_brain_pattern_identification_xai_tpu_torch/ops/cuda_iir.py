"""CUDA SOS-cascade kernels (counterpart of the JAX package's
``ops/pallas_iir.py``) with their plain PyTorch versions.

* :func:`sosfilt` — kernel ``iir_sosfilt_f32`` (``csrc/iir.cu``):
  ``scipy.signal.sosfilt`` along the last axis from zero state, or from
  the steady state ``zi_k · x[0]`` (``lfilter_zi``) with
  ``steady_state_init=True``.  Plain version: :func:`.iir._sos_scan`.
* :func:`sosfilt_rolldec` — kernel ``iir_sosfilt_rolldec_f32``: the
  cascade from zero state followed by the 4-tap mean of y[4u..4u+3]
  (T % 4 == 0), i.e. ``lfilter`` then ``rolling_mean4_decimate_flat``.
  Plain version: exactly that composition over the scan.
* :func:`filtfilt` — the host wrapper of ``pallas_filtfilt``: odd
  extension, two steady-state passes of :func:`sosfilt`, crop.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build
from .iir import FilterCoeffs, _sos_scan, _sos_zi, section_coefs
from .resample import rolling_mean4_decimate_flat

MAX_SECTIONS = 12

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/iir.cu``."""
    lib = _build.load("iir")
    lib.iir_sosfilt_f32.argtypes = [_P, _P, _I, _I, _I, _FP, _FP, _P]
    lib.iir_sosfilt_f32.restype = _I
    lib.iir_sosfilt_rolldec_f32.argtypes = [_P, _P, _I, _I, _I, _FP, _P]
    lib.iir_sosfilt_rolldec_f32.restype = _I
    return lib


def _check_cuda_input(x: torch.Tensor, coeffs: FilterCoeffs) -> None:
    if not x.is_cuda:
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the IIR kernels take float32, got {x.dtype}")
    if not 1 <= len(coeffs.sos) <= MAX_SECTIONS:
        raise ValueError(f"the IIR kernels take 1..{MAX_SECTIONS} sections, "
                         f"got {len(coeffs.sos)}")


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def sosfilt(coeffs: FilterCoeffs, x: torch.Tensor,
            steady_state_init: bool = False) -> torch.Tensor:
    """SOS cascade along the last axis of ``x`` (..., T); every other axis
    is an independent lane."""
    zi = _sos_zi(coeffs) if steady_state_init else None
    if x.device.type == "cpu":
        z = (None if zi is None else
             torch.as_tensor(zi, dtype=x.dtype) * x[..., :1, None])
        return _sos_scan(x, coeffs.sos, z)
    _check_cuda_input(x, coeffs)
    shape, T = x.shape, x.shape[-1]
    xt = x.reshape(-1, T).t().contiguous()              # (T, lanes)
    y = torch.empty_like(xt)
    coef = np.ascontiguousarray(section_coefs(coeffs.sos))
    zi32 = None if zi is None else np.ascontiguousarray(zi, np.float32)
    with torch.cuda.device(x.device):
        rc = _lib().iir_sosfilt_f32(
            xt.data_ptr(), y.data_ptr(), T, xt.shape[1], len(coeffs.sos),
            _f32_ptr(coef), None if zi32 is None else _f32_ptr(zi32),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "iir_sosfilt_f32")
    sosfilt.launches += 1
    return y.t().reshape(shape)


sosfilt.launches = 0


def sosfilt_rolldec(coeffs: FilterCoeffs, x: torch.Tensor) -> torch.Tensor:
    """Cascade from zero state along the last axis of ``x`` (..., T), then
    the mean of every 4 consecutive outputs: (..., T) → (..., T/4)."""
    shape, T = x.shape, x.shape[-1]
    if T % 4:
        raise ValueError(f"sosfilt_rolldec needs T % 4 == 0, got T={T}")
    if x.device.type == "cpu":
        y = _sos_scan(x.reshape(-1, T), coeffs.sos)
        return rolling_mean4_decimate_flat(y, 4).reshape(shape[:-1] + (T // 4,))
    _check_cuda_input(x, coeffs)
    xt = x.reshape(-1, T).t().contiguous()              # (T, lanes)
    y = torch.empty((T // 4, xt.shape[1]), dtype=x.dtype, device=x.device)
    coef = np.ascontiguousarray(section_coefs(coeffs.sos))
    with torch.cuda.device(x.device):
        rc = _lib().iir_sosfilt_rolldec_f32(
            xt.data_ptr(), y.data_ptr(), T, xt.shape[1], len(coeffs.sos),
            _f32_ptr(coef), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "iir_sosfilt_rolldec_f32")
    sosfilt_rolldec.launches += 1
    return y.t().reshape(shape[:-1] + (T // 4,))


sosfilt_rolldec.launches = 0


def filtfilt(coeffs: FilterCoeffs, x: torch.Tensor,
             padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filtering along the last axis (scipy ``filtfilt``
    semantics: odd extension, ``lfilter_zi`` initial state, forward then
    backward), both passes through :func:`sosfilt`."""
    ntaps = max(len(coeffs.a), len(coeffs.b))
    if padlen is None:
        padlen = 3 * ntaps
    T = x.shape[-1]
    if T <= padlen:
        raise ValueError(f"signal length {T} must exceed padlen {padlen}")
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    y = sosfilt(coeffs, ext, steady_state_init=True).flip(-1)
    y = sosfilt(coeffs, y, steady_state_init=True).flip(-1)
    return y[..., padlen:padlen + T]
