"""The port's branch pretraining (``entry.train_branch``, the JAX CLI's
``train-eeg`` / ``train-spectrogram``) and the ``train_multimodal(
init_from=...)`` handoff on the CPU: the arch check before any data work
with the JAX CLI's message, DeepConvNet's short-window error, the demo for
both branches with their ``ARCH`` files, the graft bitwise equal to each
branch's best checkpoint at the first multimodal step, the refusal of a
branch of another arch, the L2 term (λ = 1e-3 in branch training) over
every zoo model against JAX's, and, on a miniature HMS tree (made as in
``test_torch_realdata.py``), the one-modality raw batches equal to the JAX
CLI's and the first step's loss equal to the same step on them (1e-5)."""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import cli as jcli
from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import data as jdata
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import entry
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    hms_eeg_preprocess, hms_spectrogram_preprocess)
from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
    trainer as trainer_mod)
from test_torch_realdata import FirstLoss
from test_torch_zoo import CASES, _variables

SEED = 42


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hms")
    jdata.write_synthetic_hms_tree(str(root), np.random.default_rng(7),
                                   n_eeg_ids=6, rows_per_eeg=2)
    return str(root)


@pytest.mark.parametrize("which,arch", [("eeg", "spectrogram_cnn"),
                                        ("spectrogram", "eegnet")])
def test_wrong_branch_arch_refused_before_data_work(tmp_path, which, arch):
    """The message is the JAX CLI's, and nothing is read or written (the
    data root does not even exist)."""
    with pytest.raises(ValueError) as got:
        entry.train_branch(which, str(tmp_path), arch=arch, device="cpu",
                           data_root=str(tmp_path / "missing"))
    with pytest.raises(SystemExit) as want:
        jcli._train_branch(argparse.Namespace(arch=arch), which)
    assert str(got.value) == str(want.value.code)
    assert f"is not a {which}-branch model" in str(got.value)
    assert not os.listdir(tmp_path)


def test_deepconvnet_short_window_refused(tmp_path):
    """The demo's 600-sample windows are too short for DeepConvNet."""
    with pytest.raises(ValueError, match="DeepConvNet needs ≥1021 time"):
        entry.train_branch("eeg", str(tmp_path), arch="deepconvnet",
                           device="cpu", epochs=1)


def _first_step_state(monkeypatch):
    """The model's state dict as the epoch trainer's first train step
    receives it."""
    seen = {}
    real = trainer_mod.make_train_step

    def make(**kw):
        inner = real(**kw)

        def step(state, *args, **kwargs):
            if not seen:
                seen.update({k: v.clone() for k, v in
                             state.model.state_dict().items()})
            return inner(state, *args, **kwargs)
        return step
    monkeypatch.setattr(trainer_mod, "make_train_step", make)
    return seen


def test_branches_then_init_from(tmp_path, monkeypatch):
    """Both branches on the demo (one epoch of one batch of the 24 rows,
    the default archs), each writing ``ARCH``; then ``train_multimodal(
    init_from=...)`` starts its first step from each branch's best
    checkpoint, bitwise (parameters and BatchNorm statistics)."""
    for which, arch in (("eeg", "eegnet_attention_regularized"),
                        ("spectrogram", "spectrogram_cnn")):
        hist, best = entry.train_branch(which, str(tmp_path), device="cpu",
                                        epochs=1, batch_size=24)
        assert np.isfinite(best) and len(hist["train_loss"]) == 1
        assert (tmp_path / which / "ARCH").read_text() == arch + "\n"
        assert (tmp_path / which / "best-kldiv").exists()
    seen = _first_step_state(monkeypatch)
    trainer, best = entry.train_multimodal(str(tmp_path / "mm"),
                                           device="cpu", epochs=1,
                                           batch_size=24,
                                           init_from=str(tmp_path))
    assert np.isfinite(best) and trainer.state.step == 1
    for which, sub in (("eeg", "eeg_model"),
                       ("spectrogram", "spectrogram_model")):
        branch = tt.CheckpointManager(str(tmp_path / which)).load(
            "best-kldiv")["model"]
        assert branch
        for k, v in branch.items():
            assert torch.equal(seen[f"{sub}.{k}"], v), (sub, k)


def test_train_branch_resume_bitwise(tmp_path):
    """Two epochs of ``efficientnet_b0`` on the demo (head dropout 0.2,
    BatchNorm) equal one epoch resumed to two, bitwise: the dropout draws
    come from the trainer's generator."""
    kw = dict(arch="efficientnet_b0", device="cpu", batch_size=24)
    straight = entry.train_branch("spectrogram", str(tmp_path / "a"),
                                  epochs=2, **kw)
    entry.train_branch("spectrogram", str(tmp_path / "b"), epochs=1, **kw)
    resumed = entry.train_branch("spectrogram", str(tmp_path / "b"),
                                 epochs=2, resume=True, **kw)
    assert resumed == straight
    a, b = (tt.CheckpointManager(str(tmp_path / d / "spectrogram")).load(
        "best-kldiv")["model"] for d in ("a", "b"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_from_refuses_other_arch_and_skips_missing(tmp_path):
    model = entry.build_train_model(samples=600, kern_length=16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="no eeg branch checkpoint"):
        entry.init_from_branches(model, str(tmp_path))
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    os.makedirs(tmp_path / "eeg")
    (tmp_path / "eeg" / "ARCH").write_text("eegnet\n")
    with pytest.raises(ValueError,
                       match="pretrained with --arch eegnet, but the "
                             "multimodal model's eeg branch is "
                             "eegnet_attention_regularized"):
        entry.init_from_branches(model, str(tmp_path))


@pytest.mark.parametrize("which", ["eeg", "spectrogram"])
def test_train_branch_real_data(tree, tmp_path, which):
    """On the first 4 rows: the one-modality raw batch (fold 0, shuffled
    with the seed) equals the JAX CLI's; one epoch at B=2 (1 step) of the
    full-width default model, whose first step's loss is the loss of the
    same step (L2 at 1e-3) on the JAX path's batch, preprocessed by the
    port on the finite route, within 1e-5."""
    key = "eeg" if which == "eeg" else "spec"
    paths = JC.load_config(None, [f"paths.data_root={tree}"]).paths
    jsrc = jdata.multimodal_source(paths, str(tmp_path), n_workers=2,
                                   limit=4)
    labels = np.asarray([JC.NAME2LABEL[c] for c in jsrc.meta[
        "expert_consensus"]])
    jtr, _ = jt.stratified_kfold(labels, n_splits=2, seed=SEED)[0]
    jb = next(jsrc.batches(jtr, 2, shuffle=True, seed=SEED, want=(key,)))
    src, tr, _ = entry.multimodal_fold0(tree, str(tmp_path), SEED, n_folds=2,
                                        limit=4, workers=2)
    pb = next(src.batches(tr, 2, shuffle=True, seed=SEED, want=(key,)))
    assert set(pb) == {key, "y"}
    for k in (key, "y"):
        np.testing.assert_array_equal(pb[k], jb[k])

    log = FirstLoss()
    hist, best = entry.train_branch(which, str(tmp_path), device="cpu",
                                    epochs=1, batch_size=2, seed=SEED,
                                    data_root=tree, n_folds=2, limit=4,
                                    workers=2, loggers=[log])
    assert np.isfinite(best) and len(hist["val_loss"]) == 1

    with torch.no_grad():
        raw = torch.from_numpy(jb[key])
        x = (hms_eeg_preprocess(raw, assume_finite=True) if which == "eeg"
             else hms_spectrogram_preprocess(raw))
    model = entry.branch_model(which, seed=SEED)
    state = tt.create_train_state(model, tt.make_optimizer(
        TC.TrainerConfig().lr))
    state.rng.manual_seed(SEED)
    _, m = tt.make_train_step(l2_lambda=1e-3)(
        state, {"x": x, "y": torch.from_numpy(jb["y"])}, state.rng)
    (step, loss), = log.losses
    assert step == 1
    assert loss == pytest.approx(float(m["loss"]), rel=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_l2_term_covers_flax_kernels(name):
    """The training L2 term over the port's weights equals the JAX
    package's over the flax ``kernel`` and ``embedding`` leaves (the
    packed attention kernel, the LSTM kernels and the ViT's positional
    embedding included), on the same weights."""
    kw, shape = CASES[name]
    x = np.zeros(shape, np.float32)
    jmodel = jm.build(name, **kw)
    v = _variables(jmodel, x, 7)
    port = tm.build(name, **kw)
    port.load_state_dict(tm.jax_variables_to_state_dict(v, arch=name))
    got = float(tt.l2_regularization(port, 1e-3).detach())
    want = float(jax.jit(lambda p: jt.l2_regularization(p, 1e-3))(
        v["params"]))
    assert got == pytest.approx(want, rel=1e-5)
