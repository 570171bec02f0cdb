"""Batched STFT and the DiffEEG conditioner (counterpart of the JAX
package's ``ops/stft.py``).

:func:`stft` follows ``scipy.signal.stft(fs, nperseg, noverlap,
window='hann', boundary='zeros', padded=True, detrend=False)``: periodic
Hann window, ``nperseg//2`` zero extension at both ends, zero padding to a
whole number of hops, and ``1/sum(window)`` scaling.  Every leading axis
is an independent lane; the frames are a strided view and the transform
is ``torch.fft.rfft`` (cuFFT on the card: float32, no TF32).
:func:`stft_log1p_interp` is the whole conditioner: log1p(|STFT|), a
static lerp onto ``out_t`` points, then a per-(lane, bin) min-max.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window, = scipy.signal.get_window('hann', n)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _geometry(T: int, nperseg: int, noverlap: int) -> Tuple[int, int, int]:
    """(hop, zero samples appended after the boundary extension, total
    padded length) of a length-``T`` signal."""
    hop = nperseg - noverlap
    ext = T + nperseg                          # lead + T + lead
    tail_extra = (-(ext - nperseg)) % hop
    return hop, tail_extra, ext + tail_extra


def stft(x: torch.Tensor, fs: float = 200.0, nperseg: int = 64,
         noverlap: int = 32) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """STFT along the last axis.

    Returns ``(f, t, Zxx)``: ``f`` and ``t`` as host numpy, ``Zxx``
    complex of shape ``(..., nperseg//2 + 1, n_frames)`` on x's device."""
    hop, tail_extra, total = _geometry(x.shape[-1], nperseg, noverlap)
    lead = nperseg // 2
    xp = torch.nn.functional.pad(x, (lead, lead + tail_extra))
    frames = xp.unfold(-1, nperseg, hop)       # (..., n_frames, nperseg)
    Zxx = torch.fft.rfft(frames * _window_on(nperseg, x.device, x.dtype),
                         dim=-1).transpose(-1, -2)
    f = np.fft.rfftfreq(nperseg, d=1.0 / fs)
    t = (np.arange(nperseg / 2, total - nperseg / 2 + 1, hop)
         - nperseg / 2) / fs
    return f, t, Zxx


@functools.lru_cache(maxsize=16)
def _window_on(n: int, device: torch.device, dtype: torch.dtype
               ) -> torch.Tensor:
    """The Hann window scaled by 1/Σwindow, on ``device`` once (a forward
    copies nothing from the host)."""
    win = _hann_periodic(n)
    return torch.as_tensor(win / win.sum(), dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _lerp_plan_on(n_frames: int, dt: float, t_end: float, out_t: int,
                  device: torch.device, dtype: torch.dtype):
    """(lo, hi, frac) on ``device``: the lerp of a uniform frame grid (step
    ``dt``) onto ``out_t`` uniform points spanning [0, ``t_end``]."""
    pos = np.linspace(0.0, t_end, out_t) / dt
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_frames - 1)
    hi = np.clip(lo + 1, 0, n_frames - 1)
    frac = (pos - lo).astype(np.float32)
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device),
            torch.as_tensor(frac, dtype=dtype, device=device))


def stft_log1p_interp(x: torch.Tensor, out_t: int = 2000, fs: float = 200.0,
                      nperseg: int = 64, noverlap: int = 32,
                      eps: float = 1e-8) -> torch.Tensor:
    """The DiffEEG STFT conditioner, batched: ``log1p(|STFT|)`` → linear
    interpolation of each frequency bin onto ``out_t`` uniform points over
    ``[0, t[-1]]`` → per-(lane, bin) min-max over time.

    ``x``: (..., T) → (..., nperseg//2+1, out_t)."""
    _, t, Zxx = stft(x, fs, nperseg, noverlap)
    S = torch.log1p(Zxx.abs())                 # (..., F, n_frames)
    lo, hi, w = _lerp_plan_on(S.shape[-1], float(t[1] - t[0]), float(t[-1]),
                              out_t, x.device, S.dtype)
    S_i = S[..., lo] * (1.0 - w) + S[..., hi] * w      # (..., F, out_t)
    mn = S_i.amin(-1, keepdim=True)
    mx = S_i.amax(-1, keepdim=True)
    return (S_i - mn) / (mx - mn + eps)
