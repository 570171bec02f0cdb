"""Synthetic fixtures (counterpart of the JAX package's ``data/dummy.py``,
numpy): raw-signal generators for tests and the training entry, and a
``train.csv``-shaped frame."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import config as C


def synthetic_raw_eeg(n: int, rng: np.random.Generator,
                      n_channels: int = 20, n_points: int = 10_000,
                      fs: int = 200) -> np.ndarray:
    """EEG-like raw windows (n, n_channels, n_points) float32: noise plus
    one oscillation a window, µV scale, with a few NaNs like the parquet
    crops."""
    t = np.arange(n_points) / fs
    x = rng.standard_normal((n, n_channels, n_points)).astype(np.float32) * 20
    for i in range(n):
        f = 1.0 + 24.0 * rng.random()
        x[i] += (40 * np.sin(2 * np.pi * f * t + rng.random() * 6.28)
                 ).astype(np.float32)
    nan_idx = rng.integers(0, n_points, size=max(1, n // 4))
    for i, j in enumerate(nan_idx):
        x[i % n, rng.integers(0, n_channels), j] = np.nan
    return x


def synthetic_raw_spectrogram(n: int, rng: np.random.Generator,
                              shape: Tuple[int, int] = (400, 300)
                              ) -> np.ndarray:
    """Raw spectrogram planes (n, *shape) float32 with a 1/f-like decay
    over the frequency rows."""
    base = rng.random((n,) + shape).astype(np.float32) * 10
    decay = (1.0 / (1.0 + np.arange(shape[0]) / 20.0)).astype(np.float32)
    return base * decay[None, :, None]


def dummy_metadata(rng: np.random.Generator, n: int = 60):
    """A ``train.csv``-shaped pandas frame for split / CV tests (needs
    pandas, imported here only)."""
    import pandas as pd
    classes = list(C.CLASSES)
    return pd.DataFrame({
        "eeg_id": np.arange(n),
        "spectrogram_id": np.arange(n),
        "patient_id": rng.integers(0, max(2, n // 5), n),
        "eeg_label_offset_seconds": rng.integers(0, 50, n).astype(float),
        "spectrogram_label_offset_seconds": rng.integers(0, 300, n).astype(
            float),
        "expert_consensus": [classes[i % 6] for i in range(n)],
        **{col: rng.integers(0, 10, n) for col in C.TGT_VOTE_COLS},
    })
