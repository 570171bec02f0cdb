"""Batched HMS preprocessing chains (counterpart of the JAX package's
``ops/preprocess.py``), float32, with the JAX package's bf16 serving modes
(``serving_dtype``).

* :func:`eeg_transform`: raw EEG window (..., L, C) → (..., L/5, C'), the
  raw-EEG transformer chain.
* :func:`hms_eeg_preprocess`: raw EEG (..., 20, T) µV → (..., 1, 37, L).
* :func:`hms_spectrogram_preprocess`: raw spectrogram (..., H, W) →
  (..., 3, *image_size), zero-padded or anti-alias-resized
  (``resize_mode``), with the dense-operator route or the op-by-op
  reference chain (``linear_ops``) for the linear middle section.
* :func:`preprocess_multimodal`: both HMS chains.
* :func:`mirror_eeg`: the left/right hemisphere swap.

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
from ..profiling import spanned
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


def eeg_transform(x: torch.Tensor,
                  cfg: C.EEGTransformConfig = C.EEGTransformConfig(),
                  fs: float = 200.0) -> torch.Tensor:
    """The raw-EEG transformer chain over a batch.

    ``x``: (..., L, C) raw window, C = 19 scalp channels or the 20 raw
    columns.  Returns (..., L', C') with L' = ceil(L / ``downsample``) and
    C' = 8 (magic-8) or C.

    Chain: optional magic-8 bipolar montage (channels named by
    ``EEG_COLUMNS`` at 20 columns, ``EEG_FEATURES`` otherwise) →
    clip ±``clip_value``, NaN → 0, ÷ ``scale`` → Butterworth lowpass along
    time from zero state (:func:`.iir.lfilter`: the IIR kernel on a CUDA
    tensor) → optional mu-law → every ``downsample``-th sample."""
    if cfg.apply_chris_magic_ch8:
        cols = (C.EEG_COLUMNS if x.shape[-1] == len(C.EEG_COLUMNS)
                else C.EEG_FEATURES)
        x = montage.chris_magic_ch8(x, cols)
    if cfg.normalize:
        x = normalize.clip_scale(x, cfg.clip_value, cfg.scale)
    if cfg.apply_butter_lowpass_filter:
        coeffs = iir.butter_lowpass(cfg.lowpass_cutoff_hz, fs,
                                    cfg.lowpass_order)
        x = iir.lfilter(coeffs, x, axis=-2)
    if cfg.apply_mu_law_encoding:
        x = normalize.mu_law_encode(x, 1.0)
    if cfg.downsample:
        x = resample.decimate(x, cfg.downsample, axis=-2)
    return x


@spanned("mbx.preprocess.eeg")
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
    0), and so does this one.  The NaN route ignores ``serving_dtype``
    and returns its float32 output, as the JAX chain does.
    """
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
        y = montage._double_banana(y, keep_channels=C.EEG_FEATURES)
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


@spanned("mbx.preprocess.spec")
def hms_spectrogram_preprocess(spec: torch.Tensor,
                               cfg: C.HMSPreprocessConfig = C.HMSPreprocessConfig(),
                               signal: C.SignalConfig = C.SignalConfig(),
                               serving_dtype: Optional[torch.dtype] = None,
                               linear_ops: bool = True,
                               ) -> torch.Tensor:
    """``HMS_Spectrogram_Dataset`` chain over a batch.

    ``spec``: (..., H, W) offset-cropped, transposed spectrogram.  Returns
    (..., 3, *image_size) float32: reach ``image_size`` and repair NaNs →
    baseline correction → 60 Hz notch ``filtfilt`` down the time axis →
    Gaussian σ=1 → per-plane min-max → tile to 3 channels.

    ``signal.resize_mode``: ``"pad"`` zero-pads or crops to ``image_size``,
    then repairs NaNs; ``"resample"`` repairs NaNs first (a NaN would
    otherwise spread over the resize operators' support) and then
    anti-alias-resizes (:func:`.resample.resize_antialiased`, float32).
    Any other mode raises ``ValueError``.

    ``linear_ops=True`` (the serving route): the linear middle section runs
    as the two dense operators ``(M_h @ x) @ M_w``.  ``False``: the
    reference that holds the dense route (as the JAX package's tests use
    it; no serving program takes it), op by op: the notch ``filtfilt``
    through :func:`.cuda_iir.filtfilt` (two launches of the IIR kernel on
    a CUDA tensor) and the Gaussian as shifted sums.

    ``serving_dtype=torch.bfloat16`` (the JAX chain's bf16 serving mode):
    after the NaN repair (and, op by op, the baseline correction) the plane
    is bf16 and so is the result.  Dense route: x and both operators are
    bf16, each matmul accumulates in float32 and stores bf16.  Op by op: the
    IIR kernels take float32 only, and a bf16 recurrence is unstable, so
    the notch filters the bf16-rounded plane in float32 and rounds its
    result to bf16; the Gaussian and the min-max run in bf16."""
    if signal.resize_mode == "resample":
        x = nanfix.nan_to_channel_mean(spec.float())
        x = resample.resize_antialiased(x, tuple(signal.image_size))
    elif signal.resize_mode == "pad":
        x = resample.pad_or_truncate(spec.float(), tuple(signal.image_size))
        x = nanfix.nan_to_channel_mean(x)
    else:
        raise ValueError(f"signal.resize_mode must be 'pad' or 'resample', "
                         f"got {signal.resize_mode!r}")
    notch = iir.iirnotch(cfg.notch_freq_hz, cfg.notch_quality,
                         float(signal.sampling_rate))
    if linear_ops:
        if serving_dtype is not None:
            x = x.to(serving_dtype)
        m_h, m_w = _spec_operators_on(*x.shape[-2:], notch,
                                      cfg.gaussian_sigma, x.device, x.dtype)
        x = torch.matmul(torch.matmul(m_h, x), m_w)
    else:
        x = normalize.baseline_correction(x, axis=-2)
        if serving_dtype is not None:
            x = x.to(serving_dtype)
        x = iir.filtfilt(notch, x.float(), axis=-2).to(x.dtype)
        x = smooth.gaussian_smooth2d(x, cfg.gaussian_sigma)
    x = normalize.minmax(x, axis=(-2, -1))
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


@functools.lru_cache(maxsize=8)
def _mirror_perm(n: int) -> np.ndarray:
    f2i = C.feature_to_index()
    idx1 = [f2i[ch] for ch in C.LL + C.LP]
    idx2 = [f2i[ch] for ch in C.RL + C.RP]
    perm = np.arange(n)
    perm[idx1], perm[idx2] = perm[idx2], perm[idx1].copy()
    return perm


def mirror_eeg(x: torch.Tensor) -> torch.Tensor:
    """Left/right hemisphere swap (augmentation). ``x``: (..., 20, T) in
    ``EEG_COLUMNS`` order."""
    perm = torch.as_tensor(_mirror_perm(x.shape[-2]), device=x.device)
    return x.index_select(-2, perm)
