"""Readers, window cropping and the EEG window cache (counterpart of the JAX
package's ``data/loader.py``).

``train.csv`` is read with the stdlib ``csv`` module into a
:class:`ColumnTable` (the values and dtypes ``pandas.read_csv`` gives for
the HMS schema), so the metadata path needs no pandas.  Only the two
parquet readers import pandas, when they are called.  The cache is the same
``.npz`` as the JAX package's: either package reads the other's.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import config as C


class ColumnTable:
    """A table as columns: name → numpy array, every column one row per
    record.  ``table["name"]`` is a column; ``table[rows]`` (a slice or an
    index array) a new table of those rows; ``len(table)`` the row count."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self._cols = dict(columns)
        self.columns: List[str] = list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key: Union[str, slice, np.ndarray]):
        if isinstance(key, str):
            return self._cols[key]
        return ColumnTable({k: v[key] for k, v in self._cols.items()})


def _parse_column(values: List[str]) -> np.ndarray:
    """One CSV column as ``pandas.read_csv`` types it: int64 when every
    value is an integer, else float64 (an empty cell is NaN), else object
    (an empty cell is NaN)."""
    try:
        return np.array([int(v) for v in values], np.int64)
    except (ValueError, OverflowError):
        pass
    try:
        return np.array([float(v) if v else np.nan for v in values],
                        np.float64)
    except ValueError:
        return np.array([v if v else np.nan for v in values], object)


def load_train_metadata(csv_path: str) -> ColumnTable:
    """``train.csv`` (eeg_id / spectrogram_id / patient_id / offsets /
    expert_consensus / vote columns) as a :class:`ColumnTable`."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return ColumnTable({name: _parse_column([r[j] for r in body])
                        for j, name in enumerate(header)})


def load_eeg_parquet(path_or_dir: str, eeg_id: Optional[int] = None,
                     skip_assert: bool = False) -> np.ndarray:
    """One EEG recording → (T, 20) float32 in ``EEG_COLUMNS`` order.
    Needs pandas."""
    import pandas as pd
    path = (os.path.join(path_or_dir, f"{eeg_id}.parquet")
            if eeg_id is not None else path_or_dir)
    df = pd.read_parquet(path)
    if not skip_assert:
        assert list(df.columns) == list(C.EEG_COLUMNS), \
            "EEG columns order is not the same!"
    return df.to_numpy(dtype=np.float32)


def load_spectrogram_parquet(path_or_dir: str,
                             spectrogram_id: Optional[int] = None,
                             skip_assert: bool = False) -> np.ndarray:
    """One Kaggle spectrogram → (T, 400) float32, without the time
    column.  Needs pandas."""
    import pandas as pd
    path = (os.path.join(path_or_dir, f"{spectrogram_id}.parquet")
            if spectrogram_id is not None else path_or_dir)
    df = pd.read_parquet(path)
    cols = [c for c in df.columns if c != "time"]
    return df[cols].to_numpy(dtype=np.float32)


def crop_eeg_window(eeg: np.ndarray, n_points: int = 10_000,
                    offset_seconds: Optional[float] = None,
                    fs: int = 200) -> np.ndarray:
    """Centre-crop (or offset-crop) an (T, C) recording to ``n_points``
    rows, zero-padded at the end, each channel's NaNs set to its mean (0
    for an all-NaN channel).  Returns (n_points, C) float32."""
    T = eeg.shape[0]
    if offset_seconds is not None:
        start = int(offset_seconds * fs)
    else:
        start = max(0, (T - n_points) // 2)
    win = eeg[start:start + n_points]
    if win.shape[0] < n_points:
        pad = np.zeros((n_points - win.shape[0], eeg.shape[1]), eeg.dtype)
        win = np.concatenate([win, pad], axis=0)
    win = win.copy()
    mean = np.nanmean(np.where(np.isnan(win), np.nan, win), axis=0)
    mean = np.where(np.isnan(mean), 0.0, mean)
    idx = np.where(np.isnan(win))
    win[idx] = np.take(mean, idx[1])
    return win.astype(np.float32)


def crop_spectrogram(spec_tc: np.ndarray,
                     offset_seconds: Optional[float] = None,
                     width: int = 300) -> np.ndarray:
    """Offset-crop a (T, 400) time-major plane and transpose it to the
    (400, ``width``) model plane, zero-padded.  The Kaggle spectrograms
    have one row per 2 s, hence ``offset // 2`` (at least 0)."""
    raw = spec_tc
    if offset_seconds is not None:
        off = max(int(offset_seconds) // 2, 0)
        basic = raw[off:off + width, :] if raw.shape[0] >= off else raw
        pad = max(0, width - basic.shape[0])
        if pad:
            basic = np.pad(basic, ((0, pad), (0, 0)))
    else:
        basic = raw
    out = basic.T                                 # (400, ≥width)
    if out.shape[1] < width:
        out = np.pad(out, ((0, 0), (0, width - out.shape[1])))
    return out[:400, :width].astype(np.float32)


class EEGRecordCache:
    """``{eeg_id: (n_points, C) float32 window}`` persisted as one ``.npz``
    keyed by the id's decimal string."""

    def __init__(self, cache_path: str):
        self.cache_path = cache_path
        self._store: Dict[int, np.ndarray] = {}

    def build(self, eeg_dir: str, eeg_ids: Sequence[int],
              n_points: int = 10_000, n_workers: int = 8
              ) -> "EEGRecordCache":
        """Read and crop each id's parquet recording (``n_workers``
        threads: pyarrow's decode releases the GIL).  Needs pandas."""
        ids = [int(e) for e in eeg_ids]

        def one(eeg_id: int):
            raw = load_eeg_parquet(eeg_dir, eeg_id)
            return eeg_id, crop_eeg_window(raw, n_points)

        if n_workers > 1 and len(ids) > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                for eeg_id, win in pool.map(one, ids):
                    self._store[eeg_id] = win
        else:
            for eeg_id in ids:
                self._store[eeg_id] = one(eeg_id)[1]
        missing = set(ids) - set(self._store)
        assert not missing, f"cache build missed {len(missing)} ids"
        return self

    def save(self) -> None:
        np.savez_compressed(
            self.cache_path, **{str(k): v for k, v in self._store.items()})

    @classmethod
    def load(cls, cache_path: str) -> "EEGRecordCache":
        self = cls(cache_path)
        with np.load(cache_path) as z:
            self._store = {int(k): z[k] for k in z.files}
        return self

    def __getitem__(self, eeg_id: int) -> np.ndarray:
        return self._store[int(eeg_id)]

    def __setitem__(self, eeg_id: int, window: np.ndarray) -> None:
        self._store[int(eeg_id)] = window

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, eeg_id: int) -> bool:
        return int(eeg_id) in self._store
