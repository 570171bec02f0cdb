"""CUDA SOS-cascade kernels (counterpart of the JAX package's
``ops/pallas_iir.py``) with their plain PyTorch versions.

Both kernels run the chunked scan of ``csrc/iir.cu`` on x in its own
(lanes, T) layout; :func:`.iir._chunked_sos_scan` is the same algorithm in
plain PyTorch (for the tests).

* :func:`sosfilt` — kernel ``iir_sosfilt_f32`` (``csrc/iir.cu``):
  ``scipy.signal.sosfilt`` along the last axis from zero state, or from
  the steady state ``zi_k · x[0]`` (``lfilter_zi``) with
  ``steady_state_init=True``; from a given state ``zi`` (..., K, 2), the
  kernel ``iir_sosfilt_zi_f32``.  Plain version: :func:`.iir._sos_scan`.
* :func:`sosfilt_rolldec` — kernel ``iir_sosfilt_rolldec_f32``: the
  cascade from zero state followed by the 4-tap mean of y[4u..4u+3]
  (T % 4 == 0), i.e. ``lfilter`` then ``rolling_mean4_decimate_flat``.
  Plain version: exactly that composition over the scan.
* :func:`filtfilt` — the host wrapper of ``pallas_filtfilt``: odd
  extension, two steady-state passes of :func:`sosfilt`, crop.

A launch takes at most :data:`MAX_SECTIONS` sections; a longer cascade
runs as consecutive runs of them (:func:`split_sections`), one launch a
run, the rolldec kernel on the last.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its kernel launches in ``<wrapper>.launches``;
:func:`sosfilt`'s launches from a given state count apart, in
``sosfilt.given_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .iir import (FilterCoeffs, _chunk_ops, _odd_extension, _sos_scan,
                  _sos_zi)
from .resample import rolling_mean4_decimate_flat

MAX_SECTIONS = 12          # csrc/iir.cu kMaxSections
MAX_THREADS = 512          # csrc/iir.cu kMaxThreads
GIVEN_THREADS = 256        # csrc/iir.cu kGivenThreads (from a given state)
STAGE = 32                 # csrc/iir.cu kStage
MIN_CHUNK = 64
#: longer chunks ran no faster at B=256 (scripts/torch_iir_sweep.py, H100)
MAX_CHUNK = 320
#: (lane, chunk) threads a launch aims at: 32 chunks a lane at B=256
TARGET_THREADS = 5120 * 32
CTA_THREADS = 256
SMS = 132                  # H100 SXM

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/iir.cu``."""
    lib = _build.load("iir")
    lib.iir_sosfilt_f32.argtypes = [_P, _P, _I, _I, _I, _I, _I, _FP, _FP, _I,
                                    _DP, _P]
    lib.iir_sosfilt_f32.restype = _I
    lib.iir_sosfilt_zi_f32.argtypes = [_P, _P, _I, _I, _I, _I, _I, _FP, _FP,
                                       _P, _DP, _P]
    lib.iir_sosfilt_zi_f32.restype = _I
    lib.iir_sosfilt_rolldec_f32.argtypes = [_P, _P, _I, _I, _I, _I, _I, _FP,
                                            _FP, _DP, _P]
    lib.iir_sosfilt_rolldec_f32.restype = _I
    return lib


def launch_shape(lanes: int, T: int, K: int, chunk: Optional[int] = None,
                 max_threads: int = MAX_THREADS) -> Tuple[int, int, int]:
    """(chunk length L, chunks per lane C, lanes per CTA G) of a launch.

    ``chunk=None`` picks the shortest multiple of STAGE (the kernel's
    staging unit) in [MIN_CHUNK, MAX_CHUNK] that keeps lanes × C near
    TARGET_THREADS; an explicit chunk is rounded up to a multiple of 4.
    A CTA holds every chunk of its G lanes (at most ``max_threads``
    threads: MAX_THREADS, or GIVEN_THREADS from a given state; ~CTA_THREADS
    aimed at, G small enough for SMS CTAs), and, from three chunks on, one
    thread per state row (2K) of each lane."""
    unit = 4
    if chunk is None:
        chunk = min(MAX_CHUNK, -(-T * lanes // TARGET_THREADS))
        chunk, unit = max(MIN_CHUNK, chunk), STAGE
    chunk = max(chunk, -(-T // max_threads))
    chunk = unit * -(-chunk // unit)
    n_chunks = -(-T // chunk)
    width = max(n_chunks, 2 * K) if n_chunks > 2 else n_chunks
    return chunk, n_chunks, max(1, min(CTA_THREADS // width, -(-lanes // SMS)))


def split_sections(sos: Tuple[Tuple[float, ...], ...]
                   ) -> Tuple[Tuple[Tuple[float, ...], ...], ...]:
    """The cascade ``sos`` as consecutive runs of at most
    :data:`MAX_SECTIONS` sections, the most one launch takes.  A cascade is
    the composition of its sections, so filtering by the runs one after
    another is the whole cascade, NaN mask included.  From the steady
    state (``steady_state_init``), each run starts from its own
    ``sosfilt_zi`` times its own input's first sample: a run started in
    steady state outputs its DC gain times x[0] at sample 0, so in exact
    arithmetic the runs start where the whole cascade's ``sosfilt_zi`` ·
    x[0] would."""
    return tuple(sos[i:i + MAX_SECTIONS]
                 for i in range(0, len(sos), MAX_SECTIONS))


def _check_cuda_input(x: torch.Tensor, coeffs: FilterCoeffs) -> None:
    if not x.is_cuda:
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the IIR kernels take float32, got {x.dtype}")
    if not coeffs.sos:
        raise ValueError("the IIR kernels need at least one section")


@functools.lru_cache(maxsize=64)
def _chunk_args(sos, chunk: int):
    """ctypes pointers to ``_chunk_ops(sos, chunk)``'s constants (each
    pointer keeps its array alive), built once rather than per launch."""
    coef, zi, a_pow = _chunk_ops(sos, chunk)
    return (coef.ctypes.data_as(_FP), zi.ctypes.data_as(_FP),
            a_pow.ctypes.data_as(_DP))


def _launch(name: str, sos, x: torch.Tensor, y: torch.Tensor,
            chunk: Optional[int], *start, max_threads: int = MAX_THREADS
            ) -> None:
    """Launch ``name`` with the sections ``sos`` (at most
    :data:`MAX_SECTIONS`) on x (lanes, T) → y, with the chunked scan's
    constants for the chunk length :func:`launch_shape` picks (or for
    ``chunk``, which only the chunk-length sweep sets); ``start`` is the
    entry point's start argument (a flag, or the given state's pointer),
    ``max_threads`` its CTA limit."""
    lanes, T = x.shape
    K = len(sos)
    L, _, G = launch_shape(lanes, T, K, chunk, max_threads)
    coef, zi, a_pow = _chunk_args(sos, L)
    with torch.cuda.device(x.device):
        rc = getattr(_lib(), name)(
            x.data_ptr(), y.data_ptr(), T, lanes, K, L, G, coef, zi, *start,
            a_pow, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)


def sosfilt(coeffs: FilterCoeffs, x: torch.Tensor,
            steady_state_init: bool = False,
            zi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SOS cascade along the last axis of ``x`` (..., T); every other axis
    is an independent lane.  The initial state is zero, the steady state
    ``zi_k · x[0]`` (``steady_state_init``), or ``zi``: the DF2T state of
    every section, broadcastable to (..., K, 2)."""
    if zi is not None and steady_state_init:
        raise ValueError("pass zi or steady_state_init, not both")
    if x.device.type == "cpu":
        z = zi
        if steady_state_init:
            z = torch.as_tensor(_sos_zi(coeffs), dtype=x.dtype) \
                * x[..., :1, None]
        return _sos_scan(x, coeffs.sos, z)
    _check_cuda_input(x, coeffs)
    y = x.reshape(-1, x.shape[-1]).contiguous()
    if zi is None:
        for run in split_sections(coeffs.sos):
            y = _sosfilt_run(run, y, steady_state_init)
        return y.reshape(x.shape)
    K = len(coeffs.sos)
    z = torch.as_tensor(zi, dtype=torch.float32, device=x.device).expand(
        x.shape[:-1] + (K, 2)).reshape(-1, K, 2)
    k0 = 0
    for run in split_sections(coeffs.sos):
        y = _sosfilt_given_run(run, y, z[:, k0:k0 + len(run)].contiguous())
        k0 += len(run)
    return y.reshape(x.shape)


def _sosfilt_run(sos, x2: torch.Tensor, steady_state_init: bool
                 ) -> torch.Tensor:
    """One launch of the plain cascade kernel: x2 (lanes, T) contiguous."""
    y = torch.empty_like(x2)
    _launch("iir_sosfilt_f32", sos, x2, y, None, int(steady_state_init))
    sosfilt.launches += 1
    return y


def _sosfilt_given_run(sos, x2: torch.Tensor, z: torch.Tensor
                       ) -> torch.Tensor:
    """One launch of the cascade kernel from the given state ``z`` (lanes,
    len(sos), 2) contiguous float32 on x2's device."""
    y = torch.empty_like(x2)
    _launch("iir_sosfilt_zi_f32", sos, x2, y, None, z.data_ptr(),
            max_threads=GIVEN_THREADS)
    sosfilt.given_launches += 1
    return y


sosfilt.launches = 0
sosfilt.given_launches = 0


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
    *lead, last = split_sections(coeffs.sos)
    x2 = x.reshape(-1, T).contiguous()
    for run in lead:
        x2 = _sosfilt_run(run, x2, False)
    if x2.data_ptr() % 16:                  # the kernel reads float4
        x2 = x2.clone()
    y = torch.empty((x2.shape[0], T // 4), dtype=x.dtype, device=x.device)
    _launch("iir_sosfilt_rolldec_f32", last, x2, y, None)
    sosfilt_rolldec.launches += 1
    return y.reshape(shape[:-1] + (T // 4,))


sosfilt_rolldec.launches = 0


def filtfilt(coeffs: FilterCoeffs, x: torch.Tensor,
             padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filtering along the last axis (scipy ``filtfilt``
    semantics: odd extension, ``lfilter_zi`` initial state, forward then
    backward), both passes through :func:`sosfilt`."""
    T = x.shape[-1]
    ext, padlen = _odd_extension(coeffs, x, padlen)
    y = sosfilt(coeffs, ext, steady_state_init=True).flip(-1)
    y = sosfilt(coeffs, y, steady_state_init=True).flip(-1)
    return y[..., padlen:padlen + T]
