"""Preprocessing parity of the PyTorch port (CPU: the plain PyTorch
versions) against the JAX package and the scipy golden of
tests/test_ops_preprocess.py, at its bounds."""

import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu_torch import ops as tops
from test_ops_preprocess import _ref_hms_eeg


@pytest.fixture(scope="module")
def raw_eeg():
    x = (np.random.default_rng(42).standard_normal((2, 20, 10_000))
         * 40).astype(np.float32)
    return x


@pytest.mark.parametrize("assume_finite", [False, True])
def test_hms_eeg_preprocess_matches_jax_and_scipy(raw_eeg, assume_finite):
    x = raw_eeg.copy()
    if not assume_finite:
        x[0, 3, 100:200] = np.nan
    got = tops.hms_eeg_preprocess(torch.from_numpy(x),
                                  assume_finite=assume_finite).numpy()
    want = np.asarray(jops.hms_eeg_preprocess(x, assume_finite=assume_finite))
    assert got.shape == want.shape == (2, 1, 37, 3000)
    assert np.max(np.abs(got - want)) < 5e-3           # z-scored units
    for i in range(2):
        assert np.max(np.abs(got[i] - _ref_hms_eeg(x[i]))) < 5e-3


def test_finite_route_equals_nan_route_on_finite_input(raw_eeg):
    """One 11-section cascade then the montage equals bandpass → montage →
    bandpass on NaN-free input (LTI cascade commutes with the montage)."""
    x = torch.from_numpy(raw_eeg)
    fast = tops.hms_eeg_preprocess(x, assume_finite=True).numpy()
    full = tops.hms_eeg_preprocess(x, assume_finite=False).numpy()
    assert np.max(np.abs(fast - full)) < 5e-3


def test_hms_spectrogram_preprocess_matches_jax(rng):
    spec = (rng.standard_normal((2, 400, 300)) * 5).astype(np.float32)
    spec[1, 10, 20:30] = np.nan
    got = tops.hms_spectrogram_preprocess(torch.from_numpy(spec)).numpy()
    want = np.asarray(jops.hms_spectrogram_preprocess(spec))
    assert got.shape == want.shape == (2, 3, 400, 300)
    assert np.max(np.abs(got - want)) < 1e-5          # output lives in [0,1]


def test_eeg_rolling_wrap_when_length_not_multiple_of_4(rng):
    """T % 4 ≠ 0 keeps the reference's flat-roll channel wrap."""
    from multimodal_brain_pattern_identification_xai_tpu import config as JC
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as TC)
    x = (rng.standard_normal((1, 20, 1002)) * 40).astype(np.float32)
    got = tops.hms_eeg_preprocess(
        torch.from_numpy(x), signal=TC.SignalConfig(fixed_length=256)).numpy()
    want = np.asarray(jops.hms_eeg_preprocess(
        x, signal=JC.SignalConfig(fixed_length=256)))
    assert np.max(np.abs(got - want)) < 5e-3

