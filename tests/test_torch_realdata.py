"""The port's four real-data entry paths on the CPU, on a miniature HMS tree
(6 ``eeg_id``s × 2 rows): ``train_multimodal(data_root=...)``,
``train_wavenet``, ``grid_search`` and ``train_diffeeg(data_root=...)``.
The data each feeds equals the JAX CLI's (the fold, the raw batches
exactly, the transformed windows within 1e-5 of their max), and the first
step's loss is within 1e-5 of the same step run on the JAX path's batch.
The WaveNet paths run a narrow WaveNet (``entry.wavenet_model``
substituted; the full width runs on the card, chip_smoke phase 13)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import data as jdata
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import entry
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    spectrogram_augment)
from multimodal_brain_pattern_identification_xai_tpu_torch.train.steps import (
    fold_in)

SEED = 42


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FirstLoss:
    """A trainer logger that keeps the loss of the first logged step."""

    def __init__(self):
        self.losses = []

    def log_loss(self, loss, step):
        self.losses.append((step, loss))

    def log_evaluation(self, result, epoch):
        pass


@pytest.fixture
def narrow_wavenet(monkeypatch):
    """``entry.wavenet_model`` at blocks of (2, 1) layers, 8 wide."""
    def make(seed=42):
        model = tm.DilatedInceptionWaveNet(block_layers=(2, 1),
                                           block_dims=(8, 8))
        model.load_state_dict(tm.seeded_state_dict(model, seed))
        return model
    monkeypatch.setattr(entry, "wavenet_model", make)
    return make


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hms")
    jdata.write_synthetic_hms_tree(str(root), np.random.default_rng(7),
                                   n_eeg_ids=6, rows_per_eeg=2)
    return str(root)


@pytest.fixture(scope="module")
def jax_windows(tree, tmp_path_factory):
    """The JAX CLI's ``train-wavenet`` data: ``wavenet_arrays`` and the
    magic-8 ``eeg_transform`` (y, groups and the transformed windows)."""
    paths = JC.load_config(None, [f"paths.data_root={tree}"]).paths
    src = jdata.wavenet_arrays(paths, str(tmp_path_factory.mktemp("j")),
                               n_workers=2)
    tcfg = JC.EEGTransformConfig(apply_chris_magic_ch8=True, n_feats=8)
    x = np.asarray(jax.jit(lambda a: jops.eeg_transform(a, tcfg))(
        jnp.asarray(src["x"])))
    return src, x


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_train_multimodal_real_data(tree, tmp_path):
    """On the first 4 rows: fold 0 of the stratified split and the raw
    batches (shuffled with the seed, the host library's gather) equal the
    JAX CLI's; one epoch at B=2 (1 step) runs the full-width model, writes
    its snapshots, and its
    first step's loss is the loss of the same step on the JAX path's first
    batch (preprocessed on the finite route, augmented with the entry's
    draws) within 1e-5."""
    paths = JC.load_config(None, [f"paths.data_root={tree}"]).paths
    jsrc = jdata.multimodal_source(paths, str(tmp_path), n_workers=2,
                                   limit=4)
    labels = np.asarray([JC.NAME2LABEL[c] for c in jsrc.meta[
        "expert_consensus"]])
    jtr, jva = jt.stratified_kfold(labels, n_splits=2, seed=SEED)[0]
    src, tr, va = entry.multimodal_fold0(tree, str(tmp_path), SEED,
                                         n_folds=2, limit=4, workers=2)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    first = None
    for k, (a, b) in enumerate(zip(
            src.batches(tr, 2, shuffle=True, seed=SEED),
            jsrc.batches(jtr, 2, shuffle=True, seed=SEED))):
        for key in ("eeg", "spec", "y"):
            np.testing.assert_array_equal(a[key], b[key])
        first = first or {key: v.copy() for key, v in b.items()}
    assert k == 0

    log = FirstLoss()
    trainer, best = entry.train_multimodal(
        str(tmp_path), device="cpu", epochs=1, batch_size=2, seed=SEED,
        data_root=tree, n_folds=2, limit=4, workers=2, loggers=[log])
    assert np.isfinite(best) and trainer.state.step == 1
    assert {"best-kldiv", "last", "step_1"} <= set(
        os.listdir(tmp_path / "multimodal"))

    model = entry.build_train_model()
    tt.initialize_kaiming_weights(model, torch.Generator().manual_seed(SEED))
    state = tt.create_train_state(model, tt.make_optimizer(TC.TrainerConfig()
                                                           .lr))
    state.rng.manual_seed(SEED)
    pb = entry.preprocess_batch(*(torch.from_numpy(first[k])
                                  for k in ("eeg", "spec", "y")))
    key = fold_in(fold_in(torch.Generator().manual_seed(SEED + 1), 0,
                          torch.device("cpu")), 0, torch.device("cpu"))
    s, yb = spectrogram_augment(key, pb["spec"], pb["y"], pb["spec"],
                                pb["y"])
    _, m = tt.make_train_step()(state, {"eeg": pb["eeg"], "spec": s,
                                        "y": yb}, state.rng)
    (step, loss), = log.losses
    assert step == 1
    assert loss == pytest.approx(float(m["loss"]), rel=1e-5)


def test_train_wavenet_real_data(tree, tmp_path, jax_windows,
                                 narrow_wavenet):
    """The transformed set (6 magic-8 windows of 2000) within 1e-5 of the
    JAX CLI's, its targets and groups equal, the patient folds equal JAX's
    ``group_kfold``; fold 0 for one epoch at B=2 writes ``oof.npy``, and
    its first step's loss equals the seeded WaveNet's loss on the JAX
    path's first batch within 1e-5."""
    jsrc, jx = jax_windows
    x, y, groups = entry.wavenet_training_set(tree, str(tmp_path), "cpu",
                                              workers=2)
    _close(x, jx)
    np.testing.assert_array_equal(y, jsrc["y"])
    np.testing.assert_array_equal(groups, jsrc["groups"])
    splits = tt.group_kfold(groups, n_splits=2)
    for (a, b), (c, d) in zip(splits, jt.group_kfold(jsrc["groups"], 2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)

    log = FirstLoss()
    oof, scores = entry.train_wavenet(tree, str(tmp_path), device="cpu",
                                      epochs=1, batch_size=2, seed=SEED,
                                      n_folds=2, one_fold=True, workers=2,
                                      loggers=[log])
    assert oof.shape == (6, 6) and len(scores) == 1
    np.testing.assert_array_equal(np.load(tmp_path / "oof.npy"), oof)
    tr = splits[0][0]
    b = next(jdata.batch_iterator({"x": jx[tr], "y": jsrc["y"][tr]}, 2,
                                  shuffle=True, seed=SEED))
    with torch.no_grad():
        want = tt.kldiv_with_logits(narrow_wavenet(SEED)(
            torch.from_numpy(b["x"])), torch.from_numpy(b["y"]))
    (_, loss), = log.losses
    assert loss == pytest.approx(float(want), rel=1e-5)


def test_grid_search_real_data(tree, tmp_path, jax_windows, narrow_wavenet):
    """Two learning rates of the WaveNet for one epoch at B=2 over the
    first 4 transformed windows (2 vmapped steps): the ranked results, and
    each candidate's loss equal to the same candidate trained alone with the
    port's Adam on the JAX path's batches (rel 1e-4: one vmapped conv
    against two)."""
    jsrc, jx = jax_windows
    grid = {"lr": [1e-3, 1e-2]}
    best, results = entry.grid_search(tree, str(tmp_path), device="cpu",
                                      grid=grid, epochs=1, batch_size=2,
                                      seed=SEED, limit=4, workers=2)
    assert [list(r) for r in results] == [["lr", "loss"]] * 2
    assert best == results[0] and results[0]["loss"] <= results[1]["loss"]
    for k, lr in enumerate(grid["lr"]):
        model = narrow_wavenet(SEED + k)
        state = tt.create_train_state(model, tt.make_optimizer(np.float32(lr)))
        step = tt.make_train_step()
        for b in jdata.batch_iterator({"x": jx[:4], "y": jsrc["y"][:4]}, 2,
                                      shuffle=True, seed=SEED):
            state, m = step(state, {k2: torch.from_numpy(v)
                                    for k2, v in b.items()})
        got = next(r["loss"] for r in results
                   if r["lr"] == pytest.approx(lr))
        assert got == pytest.approx(float(m["loss"]), rel=1e-4)


def test_train_diffeeg_real_data(tree, tmp_path):
    """``train_diffeeg(data_root=...)``: the 19-channel training windows
    within 1e-5 of the JAX CLI's transform, then 2 steps of K=2
    micro-batches of 2 off the host library's queue, finite losses and a
    checkpoint."""
    paths = JC.load_config(None, [f"paths.data_root={tree}"]).paths
    raw = jdata.wavenet_arrays(paths, str(tmp_path), n_workers=2)["x"]
    tcfg = JC.EEGTransformConfig(apply_chris_magic_ch8=False, n_feats=19)
    want = np.asarray(jops.eeg_transform(jnp.asarray(raw[..., :19]), tcfg))
    got = entry.diffeeg_training_windows(raw, "cpu")
    _close(got, np.ascontiguousarray(want.transpose(0, 2, 1)))
    cfg = TC.DiffEEGConfig(hidden_channels=8, n_diffusion_steps=6,
                           gradient_accumulate_every=2, batch_size=2,
                           save_and_sample_every=2, evaluate_every=100)
    tr, hist = entry.train_diffeeg(str(tmp_path), device="cpu", cfg=cfg,
                                   steps=2, data_root=tree, workers=2)
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert tr.state.step == 2 and tr.ckpt.latest_step() == 2
    with pytest.raises(ValueError, match="data_root"):
        entry.train_diffeeg(str(tmp_path), device="cpu", raw=raw,
                            data_root=tree)
