"""Plain preprocessing of the HMS windows, float64 on any device, written
from the reference repository's ``HMS_EEG_Dataset`` and
``HMS_Spectrogram_Dataset`` chains with scipy's filter designs.

The settings (sampling rate, band, orders, length, notch, σ) are the
configuration's (:func:`chain`); the defaults below are those of
``fusion_speccnn``.

EEG (``eeg``): raw (B, 20, T) µV → Butterworth bandpass 0.5-20 Hz order 5
from zero state → NaN repair (channel mean) → the 20 rows and the 18
double-banana differences → Butterworth bandpass order 6 from zero state
→ 4-tap rolling mean over each flattened (channel, time) plane (numpy's
axis-less ``roll``) → ``[:, 0:-1:4]`` → per-channel z-score (population
std, eps 1e-6) → the 19 scalp rows and the 18 differences → zero-pad or
cut to 3000 → (B, 1, 37, 3000).

A zero-state IIR filter is a causal convolution with its impulse response;
over a window of T samples the first T taps give it exactly, so each
bandpass runs as a float64 FFT convolution with the response that
``scipy.signal.sosfilt`` gives a unit impulse.

Spectrogram (``spectrogram``): raw (B, H, W) → zero-pad or cut to the
image size → NaN repair along the last axis → baseline correction (minus
the mean down axis −2) → 60 Hz notch (Q 30) ``scipy.signal.filtfilt`` down
axis −2 → ``scipy.ndimage.gaussian_filter`` σ=1 → per-plane min-max (eps
1e-6) → 3 channels.  Both filters are linear in the plane, so each is the
matrix that scipy's own function makes of an identity, applied in float64.

``q`` and ``q_stage`` round the raw EEG and each EEG stage's result, and
``recursion`` runs the EEG bandpasses as plain recursions in a lower
type (the configuration's stated precision for the chain); for
the spectrogram, ``q`` rounds the plane after the NaN repair and the
result of each linear stage (identity for the reference, a lower
precision for the control).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EEG_COLUMNS = ("Fp1", "F3", "C3", "P3", "F7", "T3", "T5", "O1", "Fz", "Cz",
               "Pz", "Fp2", "F4", "C4", "P4", "F8", "T4", "T6", "O2", "EKG")
SCALP = EEG_COLUMNS[:-1]
DOUBLE_BANANA = (("Fp1", "F7"), ("F7", "T3"), ("T3", "T5"), ("T5", "O1"),
                 ("Fp1", "F3"), ("F3", "C3"), ("C3", "P3"), ("P3", "O1"),
                 ("Fp2", "F8"), ("F8", "T4"), ("T4", "T6"), ("T6", "O2"),
                 ("Fp2", "F4"), ("F4", "C4"), ("C4", "P4"), ("P4", "O2"),
                 ("Fz", "Cz"), ("Cz", "Pz"))
EPS = 1e-6
THREADS = min(8, os.cpu_count() or 1)

Round = Callable[[torch.Tensor], torch.Tensor]


class Chain(NamedTuple):
    """The settings a configuration states for both chains."""
    fs: float = 200.0
    band: Tuple[float, float] = (0.5, 20.0)
    orders: Tuple[int, int] = (5, 6)          # first and denoising bandpass
    fixed_length: int = 3000
    notch: Tuple[float, float] = (60.0, 30.0)  # Hz, Q
    sigma: float = 1.0


def chain(cfg: dict) -> Chain:
    """The chains' settings from a configuration's ``eeg`` and
    ``spectrogram`` sections."""
    e, s = cfg["eeg"], cfg["spectrogram"]
    if (e["raw_channels"], e["chans"]) != (len(EEG_COLUMNS),
                                           len(SCALP) + len(DOUBLE_BANANA)):
        raise ValueError(f"the chain reads {len(EEG_COLUMNS)} raw channels "
                         f"into {len(SCALP) + len(DOUBLE_BANANA)}, not "
                         f"{e['raw_channels']} into {e['chans']}")
    return Chain(float(e["fs"]), tuple(map(float, e["band_hz"])),
                 (int(e["first_bandpass_order"]),
                  int(e["denoise_bandpass_order"])), int(e["samples"]),
                 (float(s["notch_hz"]), float(s["notch_q"])),
                 float(s["gaussian_sigma"]))


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


@functools.lru_cache(maxsize=8)
def _sos(order: int, band: Tuple[float, float], fs: float) -> np.ndarray:
    from scipy.signal import butter
    return butter(order, [band[0] / (fs / 2), band[1] / (fs / 2)],
                  btype="band", output="sos")


@functools.lru_cache(maxsize=8)
def _impulse_response(order: int, n: int, band: Tuple[float, float],
                      fs: float) -> np.ndarray:
    from scipy.signal import sosfilt
    x = np.zeros(n)
    x[0] = 1.0
    return sosfilt(_sos(order, band, fs), x)


def _bandpass(x: torch.Tensor, order: int, c: Chain,
              recursion: Optional[type]) -> torch.Tensor:
    """The zero-state Butterworth bandpass along the last axis, float64:
    exact by FFT convolution, or with ``recursion`` (a numpy float type)
    as scipy's sequential ``sosfilt`` in that type, the plain filter at
    that precision (its rounding accumulates along the recursion)."""
    if recursion is None:
        return _causal_conv(x, _impulse_response(order, x.shape[-1], c.band,
                                                 c.fs))
    from concurrent.futures import ThreadPoolExecutor

    from scipy.signal import sosfilt
    sos = _sos(order, c.band, c.fs).astype(recursion)
    lanes = x.reshape(-1, x.shape[-1]).cpu().numpy().astype(recursion)
    parts = np.array_split(lanes, min(len(lanes), 4 * THREADS))
    with ThreadPoolExecutor(THREADS) as pool:    # sosfilt releases the GIL
        y = np.concatenate(list(pool.map(lambda v: sosfilt(sos, v, axis=-1),
                                         parts)))
    return torch.from_numpy(y).to(x.device, torch.float64).reshape(x.shape)


def _causal_conv(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """y[t] = Σ_{k ≤ t} h[k]·x[t − k] along the last axis, float64 FFT."""
    n = x.shape[-1]
    hh = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    m = 2 * n
    y = torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(hh, m), m)
    return y[..., :n]


def _nan_to_mean(x: torch.Tensor) -> torch.Tensor:
    """NaN → the mean of the row's valid values (0 where none is)."""
    valid = ~torch.isnan(x)
    cnt = valid.sum(-1, keepdim=True)
    mean = torch.where(valid, x, 0.0).sum(-1, keepdim=True) / cnt.clamp(min=1)
    return torch.where(valid, x, torch.where(cnt > 0, mean, 0.0))


def _montage() -> np.ndarray:
    """(38, 20): the 20 rows, then one row a bipolar pair."""
    idx = {c: i for i, c in enumerate(EEG_COLUMNS)}
    m = np.zeros((20 + len(DOUBLE_BANANA), 20))
    m[np.arange(20), np.arange(20)] = 1.0
    for r, (a, b) in enumerate(DOUBLE_BANANA):
        m[20 + r, idx[a]], m[20 + r, idx[b]] = 1.0, -1.0
    return m


def eeg(raw: torch.Tensor, q: Round = _ident, q_stage: Round = _ident,
        c: Chain = Chain(), recursion: Optional[type] = None) -> torch.Tensor:
    """(B, 20, T) µV → (B, 1, 37, fixed_length) float32.  ``q`` rounds the
    raw input, ``q_stage`` each filter's output and the z-scored result;
    ``recursion`` runs both bandpasses as recursions in that type."""
    x = q(raw.float()).double()
    x = q_stage(_bandpass(x, c.orders[0], c, recursion))
    x = _nan_to_mean(x)
    m = torch.as_tensor(_montage(), dtype=torch.float64, device=x.device)
    x = torch.einsum("oc,bct->bot", m, x)                    # (B, 38, T)
    y = q_stage(_bandpass(x, c.orders[1], c, recursion))
    flat = y.reshape(y.shape[0], -1)
    flat = (flat + flat.roll(-1, -1) + flat.roll(-2, -1) + flat.roll(-3, -1)) / 4
    y = flat.reshape(y.shape)[..., 0:-1:4]
    y = (y - y.mean(-1, keepdim=True)) / (y.std(-1, keepdim=True,
                                                 correction=0) + EPS)
    keep = [EEG_COLUMNS.index(ch) for ch in SCALP] + list(range(20, 38))
    y = q_stage(y[:, keep])
    n = y.shape[-1]
    y = F.pad(y, (0, c.fixed_length - n)) if n < c.fixed_length else y[..., :c.fixed_length]
    return y[:, None].float()


@functools.lru_cache(maxsize=8)
def _plane_operators(h: int, w: int, c: Chain
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The notch ``filtfilt`` down a column of h samples as an (h, h)
    matrix, and the Gaussian down a column of h and of w samples."""
    from scipy.ndimage import gaussian_filter1d
    from scipy.signal import filtfilt, iirnotch
    b, a = iirnotch(c.notch[0], c.notch[1], c.fs)
    notch = filtfilt(b, a, np.eye(h), axis=0)
    g_h = gaussian_filter1d(np.eye(h), c.sigma, axis=0, mode="reflect",
                            truncate=4.0)
    g_w = gaussian_filter1d(np.eye(w), c.sigma, axis=0, mode="reflect",
                            truncate=4.0)
    return tuple(np.ascontiguousarray(m) for m in (notch, g_h, g_w))


def spectrogram(raw: torch.Tensor, image_size: Sequence[int] = (400, 300),
                q: Round = _ident, c: Chain = Chain()) -> torch.Tensor:
    """(B, H, W) → (B, 3, *image_size) float32."""
    h, w = image_size
    x = raw.double()
    x = F.pad(x, (0, max(0, w - x.shape[-1]), 0, max(0, h - x.shape[-2])))
    x = _nan_to_mean(x[..., :h, :w])
    x = q(x)
    x = x - x.mean(-2, keepdim=True)
    notch, g_h, g_w = (torch.as_tensor(m, dtype=torch.float64, device=x.device)
                       for m in _plane_operators(h, w, c))
    x = q(notch @ x)
    x = q(g_h @ x)
    x = q(x @ g_w.T)
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    x = q((x - mn) / (mx - mn + EPS))
    return x[:, None].expand(-1, 3, -1, -1).float()
