"""The real HMS dataset: metadata → caches → batch sources (counterpart of
the JAX package's ``data/hms.py``).

* votes summed per ``eeg_id`` (:func:`aggregate_votes_by_eeg`);
* the EEG window cache, built or loaded (:func:`build_or_load_eeg_cache`);
* the spectrogram planes (:class:`SpectrogramStore`, parquet or ``.npy``);
* the WaveNet's cross-validation arrays (:func:`wavenet_arrays`);
* the multimodal per-row source (:class:`MultimodalSource`).

The host reads and gathers raw windows; the signal processing runs on the
device.  Metadata is a :class:`..data.loader.ColumnTable` (no pandas); a
tree in numpy form (the ``.npz`` window cache and ``.npy`` spectrograms)
is read without pandas too.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from .. import config as C
from ..runtime import gather_multimodal
from .loader import (ColumnTable, EEGRecordCache, load_spectrogram_parquet,
                     load_train_metadata)

logger = logging.getLogger(__name__)


def unique_in_order(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a`` in the order they first appear
    (``pandas.Series.unique``)."""
    a = np.asarray(a)
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


# ---------------------------------------------------------------------------
# metadata

def aggregate_votes_by_eeg(meta: ColumnTable) -> Dict[str, np.ndarray]:
    """One record per ``eeg_id``, ids sorted: the first ``patient_id`` and
    ``expert_consensus`` of its rows, and its vote columns summed (float64)
    and normalised into probability targets.

    Returns aligned arrays ``eeg_id`` (int64), ``patient_id`` (int64),
    ``y`` (N, 6) float32 and ``consensus`` (class names)."""
    ids, first, inverse = np.unique(meta["eeg_id"], return_index=True,
                                    return_inverse=True)
    votes = np.zeros((len(ids), len(C.TGT_VOTE_COLS)), np.float64)
    for j, col in enumerate(C.TGT_VOTE_COLS):
        np.add.at(votes[:, j], inverse, meta[col].astype(np.float64))
    y = votes / np.maximum(votes.sum(axis=1, keepdims=True), 1e-12)
    return {
        "eeg_id": ids.astype(np.int64),
        "patient_id": meta["patient_id"][first].astype(np.int64),
        "y": y.astype(np.float32),
        "consensus": meta["expert_consensus"][first],
    }


def onehot_consensus(consensus: Sequence[str]) -> np.ndarray:
    """Expert-consensus names → one-hot probability targets."""
    idx = np.asarray([C.NAME2LABEL[name] for name in consensus])
    return np.eye(C.N_CLASSES, dtype=np.float32)[idx]


# ---------------------------------------------------------------------------
# caches

def build_or_load_eeg_cache(cache_path: str, eeg_dir: str,
                            eeg_ids: Sequence[int],
                            n_points: int = 10_000,
                            n_workers: int = 8) -> EEGRecordCache:
    """Load the ``.npz`` window cache when it holds every id at
    ``n_points`` (no parquet read: a full hit needs no pandas).  A cache of
    another window length is rebuilt; one that lacks ids is extended with
    only those.  A built or extended cache is saved."""
    if os.path.exists(cache_path):
        cache = EEGRecordCache.load(cache_path)
        stale = (len(cache) > 0
                 and next(iter(cache._store.values())).shape[0] != n_points)
        if stale:
            logger.info("eeg cache window length mismatch, rebuilding")
            cache = EEGRecordCache(cache_path)
            cache.build(eeg_dir, eeg_ids, n_points=n_points,
                        n_workers=n_workers)
            cache.save()
            return cache
        missing = [e for e in eeg_ids if e not in cache]
        if not missing:
            logger.info("eeg cache hit: %s (%d records)", cache_path,
                        len(cache))
            return cache
        logger.info("eeg cache partial hit (%d missing), extending",
                    len(missing))
        cache.build(eeg_dir, missing, n_points=n_points, n_workers=n_workers)
    else:
        cache = EEGRecordCache(cache_path)
        cache.build(eeg_dir, eeg_ids, n_points=n_points, n_workers=n_workers)
    cache.save()
    logger.info("built eeg cache: %d records → %s", len(cache), cache_path)
    return cache


class SpectrogramStore:
    """Raw Kaggle spectrograms by ``spectrogram_id``: (T, 400) float32,
    time-major, loaded at first use or by :meth:`preload`.  Read from
    ``npy_dir/<id>.npy`` (stored (F, T)) where that file exists, else from
    the parquet directory (which needs pandas)."""

    def __init__(self, spec_dir: str, npy_dir: Optional[str] = None):
        self.spec_dir = spec_dir
        self.npy_dir = npy_dir
        self._store: Dict[int, np.ndarray] = {}

    def _load(self, spec_id: int) -> np.ndarray:
        if self.npy_dir is not None:
            p = os.path.join(self.npy_dir, f"{spec_id}.npy")
            if os.path.exists(p):
                return np.load(p).T.astype(np.float32)     # → (T, 400)
        return load_spectrogram_parquet(self.spec_dir, spec_id)

    def preload(self, spec_ids: Sequence[int], n_workers: int = 8) -> None:
        ids = sorted({int(s) for s in spec_ids} - set(self._store))
        if not ids:
            return
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for sid, arr in zip(ids, pool.map(self._load, ids)):
                self._store[sid] = arr
        logger.info("preloaded %d spectrograms", len(ids))

    def __getitem__(self, spec_id: int) -> np.ndarray:
        sid = int(spec_id)
        if sid not in self._store:
            self._store[sid] = self._load(sid)
        return self._store[sid]

    def __len__(self) -> int:
        return len(self._store)


# ---------------------------------------------------------------------------
# the WaveNet's cross-validation arrays

def wavenet_arrays(paths: C.PathsConfig, cache_dir: str,
                   n_points: int = 10_000, n_workers: int = 8,
                   limit: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``train.csv`` → votes per ``eeg_id`` → window cache → aligned
    arrays ``{"x": (N, n_points, 20) raw µV windows, "y": (N, 6) soft
    targets, "groups": patient ids, "eeg_id": ids}``, the first ``limit``
    ids when given."""
    meta = load_train_metadata(paths.train_csv)
    agg = aggregate_votes_by_eeg(meta)
    ids = agg["eeg_id"][:limit] if limit else agg["eeg_id"]
    cache = build_or_load_eeg_cache(
        os.path.join(cache_dir, "eeg_cache.npz"), paths.train_eegs, ids,
        n_points=n_points, n_workers=n_workers)
    x = np.stack([cache[e] for e in ids])           # (N, n_points, 20)
    n = len(ids)
    return {"x": x, "y": agg["y"][:n], "groups": agg["patient_id"][:n],
            "eeg_id": ids}


# ---------------------------------------------------------------------------
# the multimodal per-row source

class MultimodalSource:
    """Raw samples of the combined EEG + spectrogram pipeline, one a
    metadata row: ``{"eeg": (20, 10000) µV window, "spec": (400, width)
    offset-cropped plane, "y": (6,) one-hot consensus}``.

    Construction builds resident float32 stores once: the EEG windows
    stacked (U, 20, 10000), the spectrogram planes concatenated into one
    ragged buffer, and per row the window's and plane's index and the
    crop's first time row.  A batch is then one call into the host library
    (``runtime.gather_multimodal``)."""

    def __init__(self, meta: ColumnTable, eeg_cache: EEGRecordCache,
                 spec_store: SpectrogramStore,
                 spec_width: int = 300, n_threads: int = 4):
        self.meta = meta
        self.spec_width = spec_width
        self.n_threads = n_threads
        self.y = onehot_consensus(meta["expert_consensus"])

        uniq_eeg, eeg_row2u = np.unique(meta["eeg_id"].astype(np.int64),
                                        return_inverse=True)
        first = eeg_cache[uniq_eeg[0]]
        self._eeg_stack = np.empty(
            (len(uniq_eeg), first.shape[1], first.shape[0]), np.float32)
        for i, e in enumerate(uniq_eeg):                 # (U, 20, 10000)
            self._eeg_stack[i] = eeg_cache[e].T
        self._eeg_row2u = eeg_row2u.astype(np.int64)

        uniq_spec, spec_row2u = np.unique(
            meta["spectrogram_id"].astype(np.int64), return_inverse=True)
        planes = [np.asarray(spec_store[s], np.float32) for s in uniq_spec]
        lens = np.asarray([p.shape[0] for p in planes], np.int64)
        self._spec_buf = (np.concatenate(planes, axis=0) if planes
                          else np.zeros((0, 400), np.float32))
        self._spec_off = (np.concatenate([[0], np.cumsum(lens)[:-1]])
                          .astype(np.int64) if len(lens)
                          else np.zeros(0, np.int64))
        self._spec_len = lens
        self._spec_row2u = spec_row2u.astype(np.int64)

        # each row's crop start as crop_spectrogram takes it: offset // 2,
        # at least 0, where the offset is given and within the plane
        col = "spectrogram_label_offset_seconds"
        off = (meta[col].astype(np.float64) if col in meta.columns
               else np.full(len(meta), np.nan))
        offi = np.maximum(
            np.floor(np.nan_to_num(off, nan=0.0)).astype(np.int64) // 2, 0)
        rows_per = lens[self._spec_row2u]
        self._crop_start = np.where(~np.isnan(off) & (rows_per >= offi),
                                    offi, 0).astype(np.int64)

    def __len__(self) -> int:
        return len(self.meta)

    def gather(self, rows: np.ndarray,
               out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               want: Sequence[str] = ("eeg", "spec"),
               gather: Optional[Callable] = None) -> Dict[str, np.ndarray]:
        """One raw batch of the ``want`` modalities (and ``y``) for the
        given rows, into ``out`` when given.  ``gather`` (default: this
        module's ``gather_multimodal``, the host library's) may be its
        plain numpy version."""
        rows = np.asarray(rows, np.int64)
        eeg, spec = (gather or gather_multimodal)(
            self._eeg_stack, self._eeg_row2u[rows], self._spec_buf,
            self._spec_off, self._spec_len, self._spec_row2u[rows],
            self._crop_start[rows], width=self.spec_width,
            n_threads=self.n_threads, out=out, want=want)
        res = {"y": self.y[rows]}
        if "eeg" in want:
            res["eeg"] = eeg
        if "spec" in want:
            res["spec"] = spec
        return res

    def batches(self, rows: np.ndarray, batch_size: int,
                shuffle: bool = False, seed: int = 0,
                drop_last: bool = True,
                reuse_buffers: bool = False,
                want: Sequence[str] = ("eeg", "spec"),
                gather: Optional[Callable] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Raw batches of the ``want`` modalities (and ``y``) over
        ``rows``, shuffled by ``default_rng(seed)`` when ``shuffle``.

        ``reuse_buffers=True`` cycles two preallocated output pairs: a
        yielded batch's arrays stay valid only until the batch after the
        next is drawn.  The consumer is ``prefetch_to_device(...,
        sync_transfers=True)``, whose copy of batch n has landed before it
        asks for batch n+1."""
        rows = np.asarray(rows)
        if shuffle:
            rows = rows.copy()
            np.random.default_rng(seed).shuffle(rows)
        stop = ((len(rows) // batch_size) * batch_size if drop_last
                else len(rows))
        ring = None
        if reuse_buffers:
            c, t = self._eeg_stack.shape[1], self._eeg_stack.shape[2]
            f = self._spec_buf.shape[1]
            ring = [(np.empty((batch_size, c, t), np.float32)
                     if "eeg" in want else None,
                     np.empty((batch_size, f, self.spec_width), np.float32)
                     if "spec" in want else None)
                    for _ in range(2)]
        for k, s in enumerate(range(0, stop, batch_size)):
            sel = rows[s:s + batch_size]
            out = ring[k % 2] if ring is not None and len(sel) == batch_size \
                else None
            yield self.gather(sel, out=out, want=want, gather=gather)


def multimodal_source(paths: C.PathsConfig, cache_dir: str,
                      n_workers: int = 8,
                      npy_dir: Optional[str] = None,
                      limit: Optional[int] = None) -> MultimodalSource:
    """``train.csv`` (its first ``limit`` rows when given) + the window
    cache under ``cache_dir`` + the spectrograms → a
    :class:`MultimodalSource`."""
    meta = load_train_metadata(paths.train_csv)
    if limit:
        meta = meta[:limit]
    cache = build_or_load_eeg_cache(
        os.path.join(cache_dir, "eeg_cache.npz"), paths.train_eegs,
        unique_in_order(meta["eeg_id"]), n_workers=n_workers)
    store = SpectrogramStore(paths.train_spectr, npy_dir=npy_dir)
    store.preload(unique_in_order(meta["spectrogram_id"]),
                  n_workers=n_workers)
    return MultimodalSource(meta, cache, store)
