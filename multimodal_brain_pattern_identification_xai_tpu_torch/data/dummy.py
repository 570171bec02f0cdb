"""Synthetic fixtures (counterpart of the JAX package's ``data/dummy.py``,
numpy): raw-signal generators for tests and the training entry, one
sample a class, a
``train.csv``-shaped frame and a miniature HMS tree on disk (both need
pandas, imported in them only)."""

from __future__ import annotations

from typing import Dict, Tuple

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


def dummy_eeg_dataset(rng: np.random.Generator,
                      n_per_class: int = 1,
                      n_channels: int = 19,
                      length: int = 2000,
                      n_classes: int = 6) -> Dict[str, np.ndarray]:
    """``n_per_class`` samples a class (the reference's ``DummyEEGDataset``
    fixture): ``x`` (n, n_channels, length) standard normal float32 and
    ``y`` one-hot (n, n_classes), classes in order."""
    n = n_per_class * n_classes
    x = rng.standard_normal((n, n_channels, length)).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), n_per_class)
    y = np.eye(n_classes, dtype=np.float32)[labels]
    return {"x": x, "y": y}


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


def write_synthetic_hms_tree(root: str, rng: np.random.Generator,
                             n_eeg_ids: int = 6, rows_per_eeg: int = 2,
                             eeg_len: int = 12_000,
                             spec_len: int = 320) -> str:
    """Write a miniature HMS dataset in the Kaggle on-disk schema under
    ``root``: ``train.csv`` + ``train_eegs/{eeg_id}.parquet`` (the
    ``EEG_COLUMNS``) + ``train_spectrograms/{spectrogram_id}.parquet``
    (time + 400 columns), ``rows_per_eeg`` rows an ``eeg_id``, each id's
    votes leaning to its consensus class.  The same files, drawn in the
    same order, as the JAX package's fixture.  Needs pandas (imported here
    only).  Returns ``root``."""
    import os

    import pandas as pd

    eeg_dir = os.path.join(root, "train_eegs")
    spec_dir = os.path.join(root, "train_spectrograms")
    os.makedirs(eeg_dir, exist_ok=True)
    os.makedirs(spec_dir, exist_ok=True)

    rows = []
    classes = list(C.CLASSES)
    for i in range(n_eeg_ids):
        eeg_id, spec_id, patient = 1000 + i, 2000 + i, 100 + i // 2
        eeg = synthetic_raw_eeg(1, rng, n_points=eeg_len)[0].T  # (T, 20)
        pd.DataFrame(eeg, columns=list(C.EEG_COLUMNS)).to_parquet(
            os.path.join(eeg_dir, f"{eeg_id}.parquet"))
        spec = rng.random((spec_len, 400)).astype(np.float32) * 10
        sdf = pd.DataFrame(spec, columns=[f"LL_{k}" for k in range(400)])
        sdf.insert(0, "time", np.arange(spec_len, dtype=np.float32) * 2)
        sdf.to_parquet(os.path.join(spec_dir, f"{spec_id}.parquet"))
        for r in range(rows_per_eeg):
            votes = rng.integers(0, 8, 6)
            votes[i % 6] += 8            # consensus and votes agree
            rows.append({
                "eeg_id": eeg_id, "eeg_sub_id": r,
                "eeg_label_offset_seconds": float(r * 2),
                "spectrogram_id": spec_id, "spectrogram_sub_id": r,
                "spectrogram_label_offset_seconds": float(r * 4),
                "label_id": i * 10 + r, "patient_id": patient,
                "expert_consensus": classes[i % 6],
                **{col: int(v) for col, v in zip(C.TGT_VOTE_COLS, votes)},
            })
    pd.DataFrame(rows).to_csv(os.path.join(root, "train.csv"), index=False)
    return root
