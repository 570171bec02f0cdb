"""The port's command line (``cli.py``) and configuration loading against
the JAX package's, on the CPU (``--device cpu``): the parser's defaults
and the command set; the commands not ported yet exit 2 with their
message; ``dump-config`` prints JAX's text and ``load_config`` reads a
YAML into JAX's fields; the demos' raw arrays are JAX's; ``predict``
writes JAX's columns with the probabilities of ``entry.make_forward`` on
the same weights (1e-6), fused blocks within 1e-5 of unfused, ``--eval``'s
numbers JAX's metric functions' (1e-6), and, from a ``train-multimodal``
checkpoint on a small HMS tree, the training model's eval forward
(1e-5); ``xai`` prints its channels and LIME label; the sanity check
follows JAX's loss trajectory from carried weights (1e-5); three fused
blocks on an 80×60 input take JAX's route at block 3 (20×15: unfused).
One ``slow`` test runs the JAX command line against the port's."""

import argparse
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import cli as jcli
from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import data as jdata
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu.ops import (
    pallas_specblock)
from multimodal_brain_pattern_identification_xai_tpu_torch import cli
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import data, entry
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock, preprocess_multimodal)
from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
    CheckpointManager)
from torch_ref import make_torch_multimodal

SEED = 42
DEMO = TC.SignalConfig(fixed_length=600, image_size=(80, 60))
COLUMNS = ["eeg_id", *(f"p_{c}" for c in JC.CLASSES), "predicted_class"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torch_ckpt(tmp_path_factory):
    """A reference-layout combined state dict (.pt) for the demos."""
    sd, _ = make_torch_multimodal(seed=7, samples=600)
    path = tmp_path_factory.mktemp("ckpt") / "combined.pt"
    torch.save(sd, str(path))
    return str(path), sd


def _read(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return (rows[0], [int(r[0]) for r in rows[1:]],
            np.asarray([[float(v) for v in r[1:7]] for r in rows[1:]]),
            [r[7] for r in rows[1:]])


def _demo_raw(n, seed=SEED):
    """``predict --demo``'s draws: EEG, spectrograms, labels."""
    rng = np.random.default_rng(seed)
    return (data.synthetic_raw_eeg(n, rng, n_points=2000),
            data.synthetic_raw_spectrogram(n, rng, shape=(80, 60)),
            np.eye(6, dtype=np.float32)[rng.integers(0, 6, n)])


def test_parser_defaults_and_commands_are_jax():
    jp = argparse.ArgumentParser()
    jcli._add_common(jp)
    want = vars(jp.parse_args([]))
    got = vars(cli.build_parser().parse_args(["predict"]))
    assert got.pop("cmd") == "predict" and got.pop("device") == "cuda"
    assert got == want
    assert list(cli.COMMANDS) == list(jcli.COMMANDS)


@pytest.mark.parametrize("argv,what", [
    (["long-eeg"], "long-eeg"), (["bench"], "bench"),
    (["predict", "--demo", "--mesh", "2", "--device", "cpu"], "--mesh 2")])
def test_not_ported_exit_2(tmp_path, capsys, argv, what):
    assert cli.main(argv + ["--ckpt-dir", str(tmp_path)]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(f"error: {what} is not ported")
    assert ("parallel slice" if what != "bench" else "benchmark") in err[0]


def test_dump_config_prints_jax_text(tmp_path, capsys):
    sets = ["--set", "paths.data_root=/d/hms", "--set", "trainer.lr=3e-3",
            "--ckpt-dir", str(tmp_path)]
    assert cli.main(["dump-config", *sets]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["dump-config", *sets]) == 0
    assert got == capsys.readouterr().out
    assert "train_csv: ${data_root}/train.csv" in got


def test_load_config_yaml_equals_jax(tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text(
        "n_folds: 3\n"
        "paths:\n  data_root: /data/x/hms\n"
        "  plot_dir: ${data_root}/plots\n"
        "signal:\n  image_size: [200, 150]\n  resize_mode: resample\n"
        "trainer:\n  lr: 0.003\n  batch_size: 64\n"
        "diffeeg:\n  amp: true\n"
        "map_features: [[Fp1, F7], [F7, T3]]\n")
    over = ["diffeeg.remat=true", "trainer.use_amp=false", "seed=7"]
    got = TC.load_config(str(path), over)
    want = JC.load_config(str(path), over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.signal.image_size == (200, 150)
    assert got.paths.train_csv == "/data/x/hms/train.csv"
    assert TC.dump_yaml(got) == JC.dump_yaml(want)


def test_demo_raw_arrays_are_jax():
    """The draws of ``predict --demo`` and ``xai --demo``, in order."""
    for n, extra in ((12, None), (8, 32)):
        rng_t, rng_j = np.random.default_rng(SEED), np.random.default_rng(SEED)
        for fn in ("synthetic_raw_eeg", "synthetic_raw_spectrogram"):
            kw = ({"n_points": 2000} if fn.endswith("eeg")
                  else {"shape": (80, 60)})
            np.testing.assert_array_equal(
                getattr(data, fn)(n, rng_t, **kw),
                getattr(jdata, fn)(n, rng_j, **kw))
        if extra:
            np.testing.assert_array_equal(
                data.synthetic_raw_eeg(extra, rng_t, n_points=2000),
                jdata.synthetic_raw_eeg(extra, rng_j, n_points=2000))
        else:
            np.testing.assert_array_equal(rng_t.integers(0, 6, n),
                                          rng_j.integers(0, 6, n))


def test_predict_demo_torch_ckpt(tmp_path, torch_ckpt, capsys):
    """JAX's columns; the probabilities ``make_forward``'s on the same
    weights (1e-6); ``--fused-spec 2`` within 1e-5 of unfused."""
    pt, sd = torch_ckpt
    out = {}
    for fused in (0, 2):
        d = tmp_path / f"f{fused}"
        assert cli.main(["predict", "--demo", "--torch-ckpt", pt,
                         "--fused-spec", str(fused), "--device", "cpu",
                         "--ckpt-dir", str(d)]) == 0
        out[fused] = _read(d / "predictions.csv")
    text = capsys.readouterr().out
    assert "imported torch multimodal checkpoint" in text
    assert "wrote 12 predictions" in text
    header, ids, probs, names = out[0]
    assert header == COLUMNS and ids == list(range(12))
    raw_eeg, raw_spec, _ = _demo_raw(12)
    model = entry.build_model(600, 64, fused_blocks=0)
    model.load_state_dict(sd)
    want = entry.make_forward(model, signal=DEMO)(
        torch.as_tensor(raw_eeg), torch.as_tensor(raw_spec)).exp().numpy()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)
    assert names == [JC.CLASSES[i] for i in want.argmax(1)]
    np.testing.assert_allclose(out[2][2], probs, rtol=0, atol=1e-5)
    assert out[2][3] == names


def test_eval_metrics_equal_jax():
    rng = np.random.default_rng(1)
    p = rng.random((40, 6)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    p[3] = np.eye(6)[2]                         # a zero probability clipped
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 40)]
    got = cli.eval_metrics(p, y)
    logp = jnp.log(jnp.clip(jnp.asarray(p), 1e-12, 1.0))
    yj = jnp.asarray(y)
    pred_c, true_c = jnp.argmax(logp, -1), jnp.argmax(yj, -1)
    prec, rec, f1 = jt.macro_precision_recall_f1(pred_c, true_c, 6)
    want = {"kldiv": jt.kldiv_with_log_probs(logp, yj),
            "accuracy": jt.hard_accuracy(logp, yj),
            "soft_accuracy": jt.soft_accuracy(logp, yj),
            "precision": prec, "recall": rec, "f1": f1}
    for k, v in want.items():
        assert abs(got[k] - float(v)) < 1e-6, k
    np.testing.assert_array_equal(
        got["confusion_matrix"], np.asarray(jt.confusion_matrix(pred_c,
                                                                true_c, 6)))


def test_predict_eval_prints_metrics(tmp_path, capsys):
    assert cli.main(["predict", "--demo", "--eval", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "eval over 12 rows: kldiv" in out and "macro P/R/F1" in out


def test_predict_from_train_multimodal_checkpoint(tmp_path, capsys):
    """``train-multimodal --epochs 1`` on a 12-row tree (80×60 planes by
    ``--set signal.*``), then ``predict``: its probabilities are the
    training model's eval forward of the best checkpoint (1e-5)."""
    root = str(tmp_path / "hms")
    data.write_synthetic_hms_tree(root, np.random.default_rng(7),
                                  n_eeg_ids=6, rows_per_eeg=2)
    ck = str(tmp_path / "ck")
    sets = ["--set", f"paths.data_root={root}",
            "--set", "signal.image_size=[80,60]",
            "--set", "signal.resize_mode=resample", "--device", "cpu",
            "--ckpt-dir", ck]
    assert cli.main(["train-multimodal", "--epochs", "1", "--batch-size",
                     "6", *sets]) == 0
    assert "best kldiv" in capsys.readouterr().out
    assert cli.main(["predict", "--batch-size", "16", *sets]) == 0
    assert "restored best multimodal checkpoint" in capsys.readouterr().out
    header, ids, probs, _ = _read(os.path.join(ck, "predictions.csv"))
    sig = TC.load_config(None, ["signal.image_size=[80,60]",
                                "signal.resize_mode=resample"]).signal
    src = data.multimodal_source(TC.PathsConfig.at(root), cache_dir=ck)
    batch = src.gather(np.arange(len(src)))
    model = entry.build_train_model()
    model.load_state_dict(CheckpointManager(f"{ck}/multimodal").load(
        "best-kldiv")["model"])
    model.eval()
    with torch.no_grad():
        e, s = preprocess_multimodal(torch.as_tensor(batch["eeg"]),
                                     torch.as_tensor(batch["spec"]),
                                     signal=sig, assume_finite=True)
        want = model(e, s).exp().numpy()
    assert header == COLUMNS and ids == src.meta["eeg_id"].tolist()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-5)


def test_xai_demo_torch_ckpt(tmp_path, torch_ckpt, capsys):
    assert cli.main(["xai", "--demo", "--torch-ckpt", torch_ckpt[0],
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "top-10 channels: [" in out and "LIME top label" in out
    assert "Grad-CAM heatmap (2, 80, 60)" in out
    assert os.path.exists(tmp_path / "xai_report.json")


def test_sanity_check_follows_jax(tmp_path, capsys):
    """Five epochs of the port's sanity check from the JAX command's own
    initial weights (``model.init(PRNGKey(seed))``, carried) against the
    JAX command's step, loss by loss (1e-5); then the command itself."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:28, 0:28]
    centers = rng.uniform(6, 22, size=(256, 2))
    imgs = np.exp(-(((yy[None] - centers[:, :1, None]) ** 2
                     + (xx[None] - centers[:, 1:, None]) ** 2) / 18.0))
    imgs = imgs.astype(np.float32)
    np.testing.assert_array_equal(entry.sanity_images(SEED), imgs)
    model = jm.DiffEEGSanityCheck(input_dim=784, hidden=128)
    x = jnp.asarray(imgs)
    variables = model.init(jax.random.PRNGKey(SEED), x[:2])
    tx = optax.adam(1e-3)

    @jax.jit
    def step(params, opt_state):
        l, g = jax.value_and_grad(lambda p: jnp.mean(
            (model.apply({"params": p}, x) - x) ** 2))(params)
        upd, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, l

    params, opt_state, want = variables["params"], None, []
    opt_state = tx.init(params)
    for _ in range(5):
        params, opt_state, l = step(params, opt_state)
        want.append(float(l))
    got = entry.sanity_check("cpu", epochs=5, seed=SEED,
                             state_dict=tm.jax_variables_to_state_dict(
                                 variables, arch="diffeeg_sanity_check"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert cli.main(["sanity-check", "--epochs", "5", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "epoch 0: mse" in out and "epoch 4: mse" in out
    assert os.path.exists(tmp_path / "sanity_recon_epoch4.png")


def test_fused_spec_3_at_20x15_takes_jax_route():
    """Block 3 sees 20×15 on an 80×60 input: odd, so neither package fuses
    it (JAX's ``choose_fused_config`` gives None, the port's
    ``fused_applies`` False) and both run blocks 1-2 fused, 3-5 unfused;
    log-probs within 1e-5 (JAX's fused blocks in interpret mode)."""
    assert pallas_specblock.choose_fused_config(20, 15, 64) is None
    assert not cuda_specblock.fused_applies(20, 15)
    x = np.random.default_rng(3).random((1, 3, 80, 60)).astype(np.float32)
    flax_m = jm.SpectrogramCNN(fused_blocks=3, fused_interpret=True)
    v = flax_m.init(jax.random.PRNGKey(0), x)
    want = np.asarray(flax_m.apply(v, x))
    port = tm.SpectrogramCNN(fused_blocks=3)
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    port.eval()
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv,expect", [
    (["train-multimodal", "--demo", "--epochs", "1", "--batch-size", "24"],
     ("best kldiv:", "lime snapshots: 1")),
    (["train-eeg", "--demo", "--epochs", "1"], ("eeg branch best kldiv:",)),
    (["train-spectrogram", "--demo", "--epochs", "1"],
     ("spectrogram branch best kldiv:",)),
    (["train-diffeeg", "--demo", "--epochs", "2"], ("final loss:",)),
    (["generate", "--demo"], ("class 5: (2, 4, 256)", "generated dir:")),
    (["grid-search", "--demo", "--epochs", "1"], ("best: lr=",))],
    ids=lambda v: v[0] if isinstance(v, list) else "")
def test_command_demo_runs(tmp_path, capsys, argv, expect):
    assert cli.main(argv + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert all(e in out for e in expect), out


def test_train_wavenet_demo_with_augment_dir(tmp_path, capsys):
    """``train-wavenet --demo --augment-dir``: pools of the transformed
    19-channel space merged in (a pool of another shape skipped with a
    warning), one fold, ``oof.npy`` written."""
    gen = tmp_path / "gen"
    gen.mkdir()
    rng = np.random.default_rng(0)
    for c in range(5):
        np.save(gen / f"generated_class_{c}.npy",
                rng.standard_normal((3, 19, 400)).astype(np.float32))
    np.save(gen / "generated_class_5.npy", np.zeros((2, 4, 256), np.float32))
    assert cli.main(["train-wavenet", "--demo", "--epochs", "1",
                     "--one-fold", "--set", "n_folds=2", "--augment-dir",
                     str(gen), "--device", "cpu", "--ckpt-dir",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "generated_class_5.npy shape (2, 4, 256) does not match" in out
    assert "augmented dataset: 48 real + " in out and "fold scores" in out
    assert np.load(tmp_path / "oof.npy").shape[1] == 6


def test_cache_build_and_convert_spectrograms(tmp_path, monkeypatch, capsys):
    """On a parquet tree: ``cache-build`` caches every recording and
    ``convert-spectrograms`` writes each plane as (Freq, Time) with NaN →
    0, which the real-data commands then read; without pandas the
    conversion fails with the loader's ``ImportError``."""
    root = str(tmp_path / "hms")
    data.write_synthetic_hms_tree(root, np.random.default_rng(7),
                                  n_eeg_ids=3, rows_per_eeg=2)
    ck = str(tmp_path / "ck")
    sets = ["--set", f"paths.data_root={root}", "--ckpt-dir", ck,
            "--workers", "2"]
    assert cli.main(["cache-build", *sets]) == 0
    assert cli.main(["convert-spectrograms", *sets]) == 0
    out = capsys.readouterr().out
    assert "cached 3 records" in out and "converted 3 spectrograms" in out
    spec_dir = os.path.join(root, "train_spectrograms")
    for f in os.listdir(spec_dir):
        want = np.nan_to_num(data.load_spectrogram_parquet(
            os.path.join(spec_dir, f))).T
        np.testing.assert_array_equal(np.load(os.path.join(
            ck, "spectrograms_npy", f.replace(".parquet", ".npy"))), want)
    assert len(data.EEGRecordCache.load(f"{ck}/eeg_cache.npz")) == 3
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    with pytest.raises(ImportError):
        cli.main(["convert-spectrograms", *sets])


@pytest.mark.slow
def test_jax_cli_against_port_cli_predict(tmp_path, torch_ckpt):
    """``predict --demo --torch-ckpt`` through both command lines: the two
    ``predictions.csv`` within 1e-5, the predicted classes equal."""
    import pandas as pd
    pt = torch_ckpt[0]
    assert jcli.main(["predict", "--demo", "--torch-ckpt", pt,
                      "--ckpt-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(["predict", "--demo", "--torch-ckpt", pt, "--device",
                     "cpu", "--ckpt-dir", str(tmp_path / "port")]) == 0
    want = pd.read_csv(tmp_path / "jax" / "predictions.csv")
    header, ids, probs, names = _read(tmp_path / "port" / "predictions.csv")
    assert header == list(want.columns) and ids == want["eeg_id"].tolist()
    np.testing.assert_allclose(probs, want[header[1:7]].to_numpy(), rtol=0,
                               atol=1e-5)
    assert names == want["predicted_class"].tolist()
