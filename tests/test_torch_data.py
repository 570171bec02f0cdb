"""The port's real-data layer against the JAX package's on a miniature HMS
tree (6 ``eeg_id``s × 2 rows in the Kaggle schema): the ``train.csv``
column table, the vote aggregation, the crops, the window cache (either
package reads the other's ``.npz``), the spectrogram store, the WaveNet
arrays and the multimodal batches.  Every check is exact equality.  A tree
in numpy form (``.npz`` window cache and ``.npy`` spectrograms) is read
with pandas and pyarrow blocked."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import data as jdata
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import data as tdata
from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
    gather_multimodal_numpy)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hms")
    jdata.write_synthetic_hms_tree(str(root), np.random.default_rng(7),
                                   n_eeg_ids=6, rows_per_eeg=2)
    return str(root)


def _paths(root):
    return (JC.load_config(None, [f"paths.data_root={root}"]).paths,
            TC.PathsConfig.at(root))


def _same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_paths_match_jax(tree):
    jp, tp = _paths(tree)
    for name in ("data_root", "train_csv", "train_eegs", "train_spectr"):
        assert getattr(tp, name) == getattr(jp, name)


def test_tree_writer_matches_jax(tmp_path):
    """The port's ``write_synthetic_hms_tree`` writes the JAX fixture's
    files from the same generator."""
    for pkg, d in ((jdata, "j"), (tdata, "t")):
        pkg.write_synthetic_hms_tree(str(tmp_path / d),
                                     np.random.default_rng(3), n_eeg_ids=2)
    assert (tmp_path / "j/train.csv").read_text() == \
        (tmp_path / "t/train.csv").read_text()
    for sub, key in (("train_eegs", 1001), ("train_spectrograms", 2001)):
        pd.testing.assert_frame_equal(
            pd.read_parquet(tmp_path / "j" / sub / f"{key}.parquet"),
            pd.read_parquet(tmp_path / "t" / sub / f"{key}.parquet"))


def test_metadata_table_matches_read_csv(tree, tmp_path):
    """The ``csv`` column table holds ``pd.read_csv``'s columns, values and
    dtypes (int64, float64; strings as objects), also with an empty cell in
    a float and a string column; row slices and takes keep every column."""
    for path in (os.path.join(tree, "train.csv"), tmp_path / "gaps.csv"):
        if not os.path.exists(path):
            Path(path).write_text("a,b,c,d\n1,2.5,x,7\n2,,,8\n3,1e3,z,9\n")
        want = pd.read_csv(path)
        got = tdata.load_train_metadata(str(path))
        assert got.columns == list(want.columns) and len(got) == len(want)
        for col in want.columns:
            w = want[col]
            if w.dtype.kind in "if":
                assert got[col].dtype == w.dtype, col
                np.testing.assert_array_equal(got[col], w.to_numpy(), col)
            else:
                assert got[col].dtype == object, col
                assert [None if isinstance(v, float) else v
                        for v in got[col]] == \
                    [None if pd.isna(v) else v for v in w], col
    meta = tdata.load_train_metadata(os.path.join(tree, "train.csv"))
    rows = np.array([3, 0, 7])
    part = meta[rows]
    for col in meta.columns:
        np.testing.assert_array_equal(part[col], meta[col][rows])
        np.testing.assert_array_equal(meta[:5][col], meta[col][:5])


def test_aggregate_votes_matches_jax(tree):
    csv = os.path.join(tree, "train.csv")
    want = jdata.aggregate_votes_by_eeg(jdata.load_train_metadata(csv))
    got = tdata.aggregate_votes_by_eeg(tdata.load_train_metadata(csv))
    assert list(got["consensus"]) == list(want.pop("consensus"))
    got.pop("consensus")
    _same_arrays(got, want)


@pytest.mark.parametrize("offset", [None, 0.0, 3.5, 55.0])
def test_crops_match_jax(offset):
    """``crop_eeg_window`` (NaN repair, short recordings zero-padded) and
    ``crop_spectrogram`` (offset // 2, past the plane's end, no offset)."""
    rng = np.random.default_rng(1)
    eeg = rng.standard_normal((11_000, 20)).astype(np.float32)
    eeg[100:300, 3] = np.nan
    eeg[:, 7] = np.nan
    spec = rng.random((120, 400)).astype(np.float32)
    for n in (10_000, 12_000):
        np.testing.assert_array_equal(
            tdata.crop_eeg_window(eeg, n, offset),
            jdata.crop_eeg_window(eeg, n, offset))
    for width in (100, 300):
        np.testing.assert_array_equal(
            tdata.crop_spectrogram(spec, offset, width),
            jdata.crop_spectrogram(spec, offset, width))


def test_eeg_cache_build_and_cross_package_load(tree, tmp_path):
    """Build (threaded and serial) equal to the JAX cache; each package
    loads the other's ``.npz``; a stale window length is rebuilt, a
    partial hit extended, a full hit read as is."""
    eeg_dir = os.path.join(tree, "train_eegs")
    ids = [1000, 1002, 1004]
    t = tdata.EEGRecordCache(str(tmp_path / "t.npz")).build(eeg_dir, ids)
    serial = tdata.EEGRecordCache("").build(eeg_dir, ids, n_workers=1)
    j = jdata.EEGRecordCache(str(tmp_path / "j.npz")).build(eeg_dir, ids)
    t.save()
    j.save()
    for e in ids:
        np.testing.assert_array_equal(t[e], j[e])
        np.testing.assert_array_equal(serial[e], j[e])
    for load, path in ((jdata.EEGRecordCache.load, "t.npz"),
                       (tdata.EEGRecordCache.load, "j.npz")):
        other = load(str(tmp_path / path))
        assert len(other) == 3
        for e in ids:
            np.testing.assert_array_equal(other[e], t[e])

    all_ids = list(range(1000, 1006))
    for n_points, what in ((10_000, "partial"), (10_000, "full"),
                           (8_000, "stale")):
        got = tdata.build_or_load_eeg_cache(str(tmp_path / "t.npz"), eeg_dir,
                                            all_ids, n_points=n_points)
        want = jdata.build_or_load_eeg_cache(str(tmp_path / "j.npz"),
                                             eeg_dir, all_ids,
                                             n_points=n_points)
        assert len(got) == len(want) == 6, what
        for e in all_ids:
            assert got[e].shape == (n_points, 20), what
            np.testing.assert_array_equal(got[e], want[e], what)


def _npy_dir(tree, out):
    """The spectrograms as ``<id>.npy`` (F, T) files, as the JAX CLI's
    ``convert-spectrograms`` writes them."""
    os.makedirs(out, exist_ok=True)
    spec_dir = os.path.join(tree, "train_spectrograms")
    for name in os.listdir(spec_dir):
        sid = int(name.split(".")[0])
        np.save(os.path.join(out, f"{sid}.npy"),
                jdata.load_spectrogram_parquet(spec_dir, sid).T)
    return out


def test_spectrogram_store_matches_jax(tree, tmp_path):
    spec_dir = os.path.join(tree, "train_spectrograms")
    npy = _npy_dir(tree, str(tmp_path / "npy"))
    for npy_dir in (None, npy):
        t = tdata.SpectrogramStore(spec_dir, npy_dir)
        j = jdata.SpectrogramStore(spec_dir, npy_dir)
        t.preload([2000, 2003, 2003], n_workers=2)
        assert len(t) == 2
        for sid in (2000, 2003, 2005):
            assert t[sid].shape == (320, 400) and t[sid].dtype == np.float32
            np.testing.assert_array_equal(t[sid], j[sid])


@pytest.mark.parametrize("limit", [None, 4])
def test_wavenet_arrays_match_jax(tree, tmp_path, limit):
    jp, tp = _paths(tree)
    want = jdata.wavenet_arrays(jp, str(tmp_path), n_workers=2, limit=limit)
    os.remove(tmp_path / "eeg_cache.npz")
    got = tdata.wavenet_arrays(tp, str(tmp_path), n_workers=2, limit=limit)
    assert got["x"].shape == ((limit or 6), 10_000, 20)
    _same_arrays(got, want)


@pytest.fixture(scope="module")
def sources(tree, tmp_path_factory):
    jp, tp = _paths(tree)
    return (tdata.multimodal_source(tp, str(tmp_path_factory.mktemp("t")),
                                    n_workers=2),
            jdata.multimodal_source(jp, str(tmp_path_factory.mktemp("j")),
                                    n_workers=2))


@pytest.mark.parametrize("shuffle,reuse,want,drop_last", [
    (False, False, ("eeg", "spec"), True),
    (True, False, ("eeg", "spec"), True),
    (True, True, ("eeg", "spec"), True),
    (True, True, ("eeg",), True),
    (True, False, ("spec",), False),
    (False, True, ("spec",), False),
])
def test_multimodal_batches_match_jax(sources, shuffle, reuse, want,
                                      drop_last):
    """``MultimodalSource.batches`` (shuffle by seed, the two-buffer ring,
    each ``want``, a short last batch) equal the JAX source's, batch by
    batch (copied as drawn: the ring reuses its arrays), and the plain
    numpy gather's."""
    t, j = sources
    assert len(t) == len(j) == 12
    np.testing.assert_array_equal(t._crop_start, j._crop_start)
    rows = np.arange(1, 12)

    def draw(src, **kw):
        return [{k: v.copy() for k, v in b.items()} for b in src.batches(
            rows, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
            reuse_buffers=reuse, want=want, **kw)]
    got, ref, plain = draw(t), draw(j), draw(t, gather=gather_multimodal_numpy)
    assert len(got) == len(ref) == len(plain) == (2 if drop_last else 3)
    for a, b, c in zip(got, ref, plain):
        assert set(a) == set(want) | {"y"}
        _same_arrays(a, b)
        _same_arrays(a, c)


def test_numpy_form_tree_without_pandas(tree, tmp_path):
    """With the window cache built and the spectrograms as ``.npy``, a
    fresh interpreter with pandas and pyarrow blocked runs
    ``multimodal_source`` and ``wavenet_arrays``; their arrays equal the
    JAX package's from the parquet tree."""
    jp, _ = _paths(tree)
    cache = str(tmp_path)
    want_w = jdata.wavenet_arrays(jp, cache, n_workers=2)
    want_m = jdata.multimodal_source(jp, cache, n_workers=2)
    npy = _npy_dir(tree, str(tmp_path / "npy"))
    out = tmp_path / "out.npz"
    code = (
        "import sys\n"
        "for m in ('pandas', 'pyarrow'): sys.modules[m] = None\n"
        "import numpy as np\n"
        "from multimodal_brain_pattern_identification_xai_tpu_torch import "
        "config as C, data\n"
        f"p = C.PathsConfig.at({tree!r})\n"
        f"w = data.wavenet_arrays(p, {cache!r}, n_workers=2)\n"
        f"s = data.multimodal_source(p, {cache!r}, n_workers=2, "
        f"npy_dir={npy!r})\n"
        "b = s.gather(np.arange(len(s)))\n"
        f"np.savez({str(out)!r}, wx=w['x'], wy=w['y'], wg=w['groups'], "
        "eeg=b['eeg'], spec=b['spec'], y=b['y'])\n"
        "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        np.testing.assert_array_equal(z["wx"], want_w["x"])
        np.testing.assert_array_equal(z["wy"], want_w["y"])
        np.testing.assert_array_equal(z["wg"], want_w["groups"])
        b = want_m.gather(np.arange(len(want_m)))
        for k in ("eeg", "spec", "y"):
            np.testing.assert_array_equal(z[k], b[k])
