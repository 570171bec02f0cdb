"""The port's command line on a mesh: ``--mesh 2 --device cpu`` runs a
command on two gloo ranks (``parallel.launch.spawn``), rank 0 alone
printing and writing, and ``long-eeg`` runs the sequence-parallel
encoder.

The module fixture runs each command once (``cli.main`` in this process;
the ranks are its children, their output read at the file-descriptor
level); the tests read what each printed and wrote.  ``predict --mesh 2``
is held against the single-device ``predict`` on the same demo rows
(1e-5/1e-6), as the JAX command's mesh serving against its
single-device one."""

import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu_torch import cli

RUNS = {
    "predict": ["predict", "--demo"],
    "predict_mesh": ["predict", "--demo", "--mesh", "2"],
    "train_mesh": ["train-multimodal", "--demo", "--mesh", "2", "--epochs",
                   "1"],
    "xai_mesh": ["xai", "--demo", "--mesh", "2"],
    "diffeeg_mesh": ["train-diffeeg", "--demo", "--mesh", "2", "--epochs",
                     "2"],
    "long_eeg": ["long-eeg"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (exit code, stdout, ckpt dir)} of every command in RUNS; the
    standard output is read from one file that this process's
    ``sys.stdout`` and the ranks' file descriptor 1 both write."""
    out = {}
    for name, argv in RUNS.items():
        ckpt = tmp_path_factory.mktemp(name)
        with tempfile.TemporaryFile("w+") as buf:
            saved = os.dup(1)
            os.dup2(buf.fileno(), 1)
            try:
                with contextlib.redirect_stdout(buf):
                    rc = cli.main([*argv, "--device", "cpu", "--ckpt-dir",
                                   str(ckpt)])
                    sys.stdout.flush()
            finally:
                os.dup2(saved, 1)
                os.close(saved)
            buf.seek(0)
            out[name] = (rc, buf.read(), ckpt)
    return out


def _ok(runs, name):
    rc, text, ckpt = runs[name]
    assert rc == 0, text[-3000:]
    return text, ckpt


def _probs(ckpt):
    rows = (ckpt / "predictions.csv").read_text().splitlines()
    return rows[0], np.array([[float(v) for v in r.split(",")[1:7]]
                              for r in rows[1:]])


def test_predict_mesh_matches_single_device(runs):
    """``predict --mesh 2``: each rank serves 4 of every 8 rows; the
    gathered probabilities equal the single-device run's (1e-5/1e-6);
    one ``predictions.csv``, one set of lines."""
    text, ckpt = _ok(runs, "predict_mesh")
    _, ckpt1 = _ok(runs, "predict")
    assert text.count("serving over a 2-device data mesh, batch 8") == 1
    assert text.count("wrote 12 predictions") == 1
    h2, p2 = _probs(ckpt)
    h1, p1 = _probs(ckpt1)
    assert h1 == h2 and p2.shape == (12, 6)
    np.testing.assert_allclose(p2, p1, rtol=1e-5, atol=1e-6)


def test_train_multimodal_mesh(runs):
    """``train-multimodal --mesh 2``: the data-parallel loop with rank 0's
    checkpoints, curves and LIME snapshot."""
    text, ckpt = _ok(runs, "train_mesh")
    assert text.count("training over a 2-device data mesh, batch 8") == 1
    assert "best kldiv:" in text and "lime snapshots: 1" in text
    assert (ckpt / "multimodal" / "best-kldiv" / "state.pt").exists()
    assert (ckpt / "multimodal" / "step_1").is_dir()


def test_xai_mesh_explains_every_sample(runs):
    """``xai --mesh 2`` explains all 8 demo samples with sharded IG and
    SHAP; rank 0 writes the report."""
    text, ckpt = _ok(runs, "xai_mesh")
    assert text.count("sharding 8 explained samples over a 2-device data "
                      "mesh") == 1
    assert text.count("top-10 channels:") == 1
    report = json.loads((ckpt / "xai_report.json").read_text())
    assert report["explained"] == 8 and len(report["top_channels"]) == 10
    assert np.isfinite(report["ig_mass"])


def test_train_diffeeg_mesh(runs):
    text, ckpt = _ok(runs, "diffeeg_mesh")
    assert text.count("training over a 2-device data mesh, micro-batch 8") \
        == 1
    loss = float(text.split("final loss: ")[1].split(";")[0])
    assert np.isfinite(loss)


def test_long_eeg_on_the_cpu(runs):
    """``long-eeg --device cpu``: one seq rank, T = 200·64 samples of 20
    channels through the full-width encoder, the 64×64 rollout."""
    text, ckpt = _ok(runs, "long_eeg")
    assert ("devices=1 seq-sharded T=12800 (1.1 min) logits=(2, 6) "
            "rollout=(2, 64, 64)") in text


def test_mesh_larger_than_the_cards_exits_1(monkeypatch, tmp_path, capsys):
    """``--mesh 2`` on cuda with fewer cards exits 1 with the JAX
    command's message, before any rank starts.  ``bench`` takes no mesh:
    with ``--mesh 2`` it runs in this process, where the harness's own
    start of the card (none behind the patched availability) prints its
    error line and exits 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["predict", "--demo", "--mesh", "2", "--ckpt-dir",
                     str(tmp_path)]) == 1
    assert "error: --mesh 2 > 1 visible devices" in capsys.readouterr().err
    assert not (tmp_path / "predictions.csv").exists()
    monkeypatch.setenv("BENCH_NO_SUPERVISOR", "1")
    assert cli.main(["bench", "--mesh", "2", "--ckpt-dir",
                     str(tmp_path)]) == 1
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line["metric"] == "eeg_windows_per_sec_per_chip"
    assert line["value"] is None and line["unit"] == "error"
    assert "visible devices" not in cap.err
