"""The port's C++ host library (``runtime/hostloader.cpp``, built with g++
into ``_build/``) bitwise against the JAX package's ``runtime`` (its
native library) and against the port's plain numpy versions: the window
gather with NaN repair, the multimodal gather (``out=``, ``want=``) and the
epoch batch queue (order, ``pop_ring``).  Bad out buffers raise, and a
library that cannot be built raises with the compiler's message."""

import numpy as np
import pytest

from multimodal_brain_pattern_identification_xai_tpu import runtime as jrt
from multimodal_brain_pattern_identification_xai_tpu_torch import _build
from multimodal_brain_pattern_identification_xai_tpu_torch import runtime as rt
from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
    loader)


def _store(seed=0, n=9, c=5, t=301):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c, t)) * 40).astype(np.float32)
    x[1, 2, 10:90] = np.nan
    x[4, 0, :] = np.nan                       # all-NaN channel → 0
    x[7, 4, ::3] = np.nan
    return x


def _multimodal_store(seed=1):
    rng = np.random.default_rng(seed)
    eeg = rng.standard_normal((4, 3, 50)).astype(np.float32)
    lens = np.array([40, 7, 25], np.int64)
    buf = rng.random((int(lens.sum()), 16)).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    b = 6
    eeg_idx = rng.integers(0, 4, b)
    spec_idx = np.array([0, 1, 2, 0, 2, 1], np.int64)
    crop = np.array([0, 3, 20, 35, -4, 9], np.int64)   # short, past the end
    return eeg, eeg_idx, buf, off, lens, spec_idx, crop


def test_library_builds_into_build_dir():
    lib = loader._lib()
    assert lib is loader._lib()
    built = list(_build.BUILD_DIR.glob("libhostloader-*.so"))
    assert built and built[0].parent == _build.BUILD_DIR


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_gather_windows_bitwise(threads):
    x = _store()
    idx = np.array([4, 1, 7, 1, 0, 8, 4], np.int64)
    got = rt.gather_windows(x, idx, n_threads=threads)
    np.testing.assert_array_equal(got, jrt.gather_windows(x, idx))
    np.testing.assert_array_equal(got, rt.gather_windows_numpy(x, idx))
    assert not np.isnan(got).any() and (got[0, 0] == 0).all()
    out = np.full_like(got, 7.0)
    assert rt.gather_windows_into(x, idx, out) is out
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("bad", [
    np.empty((7, 5, 300), np.float32),               # shape
    np.empty((7, 5, 301), np.float64),               # dtype
    np.empty((7, 5, 602), np.float32)[..., ::2],     # not contiguous
])
def test_gather_windows_bad_out_raises(bad):
    x = _store()
    idx = np.arange(7, dtype=np.int64)
    with pytest.raises(ValueError, match="out buffer"):
        rt.gather_windows_into(x, idx, bad)
    with pytest.raises(ValueError, match="out buffer"):
        rt.gather_windows_numpy(x, idx, bad)


@pytest.mark.parametrize("want", [("eeg", "spec"), ("eeg",), ("spec",)])
@pytest.mark.parametrize("with_out", [False, True])
def test_gather_multimodal_bitwise(want, with_out):
    """The EEG windows and the spectrogram crops (transposed, zero-padded
    past each plane's end, a negative start read from 0) equal the JAX
    library's and the numpy version's; an unwanted modality is None, and
    ``out`` buffers are filled and returned."""
    args = _multimodal_store()
    width = 30

    def outs():
        if not with_out:
            return None
        return (np.full((6, 3, 50), 5.0, np.float32) if "eeg" in want
                else None,
                np.full((6, 16, width), 5.0, np.float32) if "spec" in want
                else None)
    res = [fn(*args, width=width, out=outs(), want=want) for fn in (
        rt.gather_multimodal, jrt.gather_multimodal,
        rt.gather_multimodal_numpy)]
    for i, key in enumerate(("eeg", "spec")):
        if key not in want:
            assert all(r[i] is None for r in res)
            continue
        np.testing.assert_array_equal(res[0][i], res[1][i])
        np.testing.assert_array_equal(res[0][i], res[2][i])
    if "spec" in want:
        spec = res[0][1]
        assert (spec[1, :, 4:] == 0).all()            # 7 rows from 3: 4
        assert (spec[3, :, 5:] == 0).all()            # 40 rows from 35: 5
        np.testing.assert_array_equal(spec[4, :, :25], args[2][47:72].T)


def test_gather_multimodal_bad_out_raises():
    args = _multimodal_store()
    good_e = np.empty((6, 3, 50), np.float32)
    good_s = np.empty((6, 16, 30), np.float32)
    for out, want in (((good_e, None), ("eeg", "spec")),
                      ((None, good_s), ("eeg", "spec")),
                      ((good_e[:5], good_s), ("eeg", "spec")),
                      ((good_e, good_s.astype(np.float64)), ("spec",))):
        for fn in (rt.gather_multimodal, rt.gather_multimodal_numpy):
            with pytest.raises(ValueError, match="out buffer"):
                fn(*args, width=30, out=out, want=want)
    eeg, spec = rt.gather_multimodal(*args, width=30, out=(good_e, None),
                                     want=("eeg",))
    assert eeg is good_e and spec is None


@pytest.mark.parametrize("shuffle,ring", [
    (True, 0), (True, 3), (False, 0), (True, 2)])
def test_batch_queue_bitwise(shuffle, ring):
    """The native queue publishes the epoch order's batches (shuffled by
    ``default_rng(seed)``, the short tail dropped) in order although its
    threads assemble them ahead, equal to the JAX library's queue and to ``batch_queue_numpy``;
    with ``pop_ring`` it cycles that many arrays."""
    x = _store(2, n=23)
    y = np.random.default_rng(3).random((23, 6)).astype(np.float32)
    kw = dict(shuffle=shuffle, seed=5)
    q = rt.NativeBatchQueue(x, y, 4, pop_ring=ring, **kw)
    got = [(b["x"].copy(), b["y"].copy(), id(b["x"])) for b in q]
    ref = [{k: v.copy() for k, v in b.items()}
           for b in jrt.NativeBatchQueue(x, y, 4, pop_ring=ring, **kw)]
    plain = list(rt.batch_queue_numpy(x, y, 4, **kw))
    order = rt.epoch_order(23, 4, **kw)
    assert len(q) == len(got) == len(ref) == len(plain) == 5
    for k, ((gx, gy, _), r, p) in enumerate(zip(got, ref, plain)):
        np.testing.assert_array_equal(gx, r["x"])
        np.testing.assert_array_equal(gy, r["y"])
        np.testing.assert_array_equal(gx, p["x"])
        np.testing.assert_array_equal(gy, y[order[4 * k:4 * k + 4]])
    if ring:
        assert len({i for *_, i in got}) == ring
    if not shuffle:
        np.testing.assert_array_equal(order, np.arange(20))


def test_unbuildable_library_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ rejects, or no g++ at all, raises
    with the reason, and so does every entry of the facade."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        _build.load_host(bad)
    monkeypatch.setattr(loader, "SRC", bad)
    loader._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            rt.gather_windows(_store(), np.arange(2))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            next(iter(rt.NativeBatchQueue(_store(), np.zeros((9, 6)), 2)))
    finally:
        loader._lib.cache_clear()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.load_host(bad)
