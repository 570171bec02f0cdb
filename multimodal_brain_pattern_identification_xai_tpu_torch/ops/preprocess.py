"""Batched HMS preprocessing chains (counterpart of the JAX package's
``ops/preprocess.py``), float32, with the JAX package's bf16 serving modes
(``serving_dtype``).

* :func:`hms_eeg_preprocess`: raw EEG (..., 20, T) µV → (..., 1, 37, L).
* :func:`hms_spectrogram_preprocess`: raw spectrogram (..., 400, 300) →
  (..., 3, 400, 300), with ``resize_mode="pad"`` and the dense-operator
  route for the linear middle section.
* :func:`preprocess_multimodal`: both.

The IIR cascades run through :mod:`.cuda_iir`: the CUDA kernels for CUDA
tensors, the sequential scan for CPU tensors.  Constant operators are made
on a device once per (device, dtype): a forward copies nothing from the
host (see :mod:`.montage`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import config as C
from . import cuda_iir, iir, montage, nanfix, normalize, resample, smooth


@functools.lru_cache(maxsize=8)
def _spec_linear_operators(h: int, w: int, notch: iir.FilterCoeffs,
                           sigma: float, truncate: float = 4.0):
    """Dense operators (M_h, M_w) with

        gauss2d(filtfilt_H(baseline_H(x))) == (M_h @ x) @ M_w

    for every (h, w) plane: the section is linear for a fixed shape, so it
    is built in float64 by pushing identity matrices through scipy/numpy
    implementations of each step."""
    from scipy.signal import filtfilt as _sp_filtfilt

    kern = smooth._gaussian_kernel1d(float(sigma), truncate)
    base = np.eye(h) - np.full((h, h), 1.0 / h)      # baseline_correction
    a_ff = _sp_filtfilt(np.asarray(notch.b), np.asarray(notch.a), base,
                        axis=0)                       # scipy-default padlen
    m_h = smooth._np_conv1d_symmetric(a_ff, kern)
    m_w = smooth._np_conv1d_symmetric(np.eye(w), kern).T
    return m_h.astype(np.float32), m_w.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _spec_operators_on(h: int, w: int, notch: iir.FilterCoeffs, sigma: float,
                       device: torch.device, dtype: torch.dtype):
    """:func:`_spec_linear_operators` as tensors of ``dtype`` on
    ``device``."""
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in _spec_linear_operators(h, w, notch, sigma))


@functools.lru_cache(maxsize=8)
def _rolldec_map(block: int) -> np.ndarray:
    """(block/4, block) rolling-mean-4 + ::4 operator: out[u] =
    mean(y[4u : 4u+4]) — the ``out_map`` of the block-Toeplitz route."""
    R = np.zeros((block // 4, block))
    for u in range(block // 4):
        R[u, 4 * u:4 * u + 4] = 0.25
    return R


def _bp_and_rolldec(coeffs: iir.FilterCoeffs, x: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Cascade then the reference's 4-tap flat rolling mean + decimation.
    With T % 4 == 0 and stride 4 that is one fused pass (the kept windows
    never cross a channel end); otherwise the flat-wrap post-pass runs."""
    if stride == 4 and x.shape[-1] % 4 == 0:
        return cuda_iir.sosfilt_rolldec(coeffs, x)
    return resample.rolling_mean4_decimate_flat(iir.lfilter(coeffs, x), stride)


def hms_eeg_preprocess(x: torch.Tensor,
                       cfg: C.HMSPreprocessConfig = C.HMSPreprocessConfig(),
                       signal: C.SignalConfig = C.SignalConfig(),
                       assume_finite: bool = False,
                       serving_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``HMS_EEG_Dataset.single_map_func`` over a batch.

    ``x``: (..., 20, T) raw rows (EEG_COLUMNS order, µV).  Returns
    (..., 1, 37, ``signal.fixed_length``) float32.

    Chain: bandpass 0.5–20 Hz → NaN repair → +18 bipolar differentials →
    order-6 bandpass, 4-tap flat rolling mean, ::4 → per-channel z-score →
    channel select (19+18) → pad/truncate.

    ``assume_finite=True`` (input already NaN-free): the repair is the
    identity and the channel-independent cascade commutes with the linear
    montage, so the chain is ONE 11-section cascade on the 20 raw lanes,
    then the (37, 20) montage on the decimated output.  The NaN route keeps
    the first bandpass sequential, so samples before a NaN keep their
    filtered values and the NaN reaches only later samples.

    ``serving_dtype=torch.bfloat16`` (finite route only): x is rounded to
    bf16, as the JAX chain feeds bf16 x to its block-matmul cascade with
    float32 accumulation, and the float32 cascade kernel runs on the
    rounded x (on the card the block-matmul route is 4.4× slower than the
    kernel).  The montage and the z-score stay float32.  The JAX chain
    rounds only where it takes the block-matmul route (stride 4, T % 4 ==
    0), and so does this one.  The JAX NaN route ignores
    ``serving_dtype``; here it raises, so no caller believes it served
    bf16.
    """
    if serving_dtype is not None and not assume_finite:
        raise ValueError("serving_dtype applies to the finite route only "
                         "(assume_finite=True)")
    x = x.float()
    fs = float(signal.sampling_rate)
    bp1 = iir.butter_bandpass(cfg.bandpass.low, cfg.bandpass.high, fs,
                              cfg.first_bandpass_order)
    bp2 = iir.butter_bandpass(cfg.bandpass.low, cfg.bandpass.high, fs,
                              cfg.denoise_bandpass_order)
    if assume_finite:
        if (serving_dtype is not None and cfg.decimate_stride == 4
                and x.shape[-1] % 4 == 0):
            x = x.to(serving_dtype).float()
        y = _bp_and_rolldec(iir.cascade(bp1, bp2), x, cfg.decimate_stride)
        # montage + channel-select as ONE (37, 20) matmul on the T/4 output
        y = montage.apply_montage(y, keep_channels=C.EEG_FEATURES)
        y = normalize.zscore(y, eps=cfg.zscore_eps)
    else:
        x = iir.lfilter(bp1, x)
        x = nanfix.nan_to_channel_mean(x)
        x = montage.bipolar_differential(x)                 # (..., 38, T)
        y = _bp_and_rolldec(bp2, x, cfg.decimate_stride)
        y = normalize.zscore(y, eps=cfg.zscore_eps)
        y = montage.select_and_map_channels(y)              # (..., 37, T/4)
    y = resample.pad_or_truncate(y, signal.fixed_length)
    return y[..., None, :, :]


def hms_spectrogram_preprocess(spec: torch.Tensor,
                               cfg: C.HMSPreprocessConfig = C.HMSPreprocessConfig(),
                               signal: C.SignalConfig = C.SignalConfig(),
                               serving_dtype: Optional[torch.dtype] = None,
                               ) -> torch.Tensor:
    """``HMS_Spectrogram_Dataset`` chain over a batch.

    ``spec``: (..., H, W) offset-cropped, transposed spectrogram.  Returns
    (..., 3, *image_size) float32: zero-pad/crop to ``image_size`` → NaN
    repair → baseline correction → 60 Hz notch ``filtfilt`` down the time
    axis → Gaussian σ=1 → per-plane min-max → tile to 3 channels.  The
    linear middle section runs as the two dense operators
    ``(M_h @ x) @ M_w``.

    ``serving_dtype=torch.bfloat16`` (the JAX chain's bf16 serving mode):
    after the NaN repair, x and both operators are bf16, each matmul
    accumulates in float32 and stores bf16, and the min-max and the tile
    run in bf16; the result is bf16."""
    if signal.resize_mode != "pad":
        raise NotImplementedError(
            f"resize_mode={signal.resize_mode!r} is not ported; use 'pad'")
    x = resample.pad_or_truncate(spec.float(), tuple(signal.image_size))
    x = nanfix.nan_to_channel_mean(x)
    notch = iir.iirnotch(cfg.notch_freq_hz, cfg.notch_quality,
                         float(signal.sampling_rate))
    if serving_dtype is not None:
        x = x.to(serving_dtype)
    m_h, m_w = _spec_operators_on(*x.shape[-2:], notch, cfg.gaussian_sigma,
                                  x.device, x.dtype)
    x = torch.matmul(torch.matmul(m_h, x), m_w)
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    x = (x - mn) / (mx - mn + 1e-6)
    return x[..., None, :, :].expand(x.shape[:-2] + (3,) + x.shape[-2:])


def preprocess_multimodal(raw_eeg: torch.Tensor, raw_spec: torch.Tensor,
                          cfg: C.HMSPreprocessConfig = C.HMSPreprocessConfig(),
                          signal: C.SignalConfig = C.SignalConfig(),
                          assume_finite: bool = False,
                          serving_dtype: Optional[torch.dtype] = None):
    """Both branches of the multimodal dataset.  ``assume_finite`` applies
    to the EEG branch only; the spectrogram branch repairs its own NaNs.
    ``serving_dtype`` is the bf16 serving program of the JAX bench's
    ``--multimodal`` mode: the spectrogram chain in bf16, and the EEG
    chain's finite route on bf16-rounded input (the NaN route stays
    float32)."""
    return (hms_eeg_preprocess(
                raw_eeg, cfg, signal, assume_finite=assume_finite,
                serving_dtype=serving_dtype if assume_finite else None),
            hms_spectrogram_preprocess(raw_spec, cfg, signal,
                                       serving_dtype=serving_dtype))
