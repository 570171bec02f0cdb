"""The PyTorch port's training loop around the step: spectrogram
augmentation (its deterministic part against the JAX package's given the
JAX draws), host batching and the prefetcher, the checkpoint manager, the
trainer (resume, plateau, skipped batches), the host gather, the synthetic
data, the cross-validation splitters, checkpoint analysis, and both
training entry points on the CPU (plain IIR versions)."""

import dataclasses
import logging
import os
import threading
import time

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
from multimodal_brain_pattern_identification_xai_tpu_torch import data as tdata
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
    DEMO_SIGNAL, train_entry, train_multimodal)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import augment
from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
    gather_windows, gather_windows_into, gather_windows_numpy)

SAMPLES = 64


# --- augmentation --------------------------------------------------------------

def _jax_draws(key, batch, n_ref, hw, cfg):
    """The draws ``ops.augment.spectrogram_augment`` of the JAX package
    makes from ``key``, in its order, as the port's ``AugmentDraws``."""
    k_lam, k_gate, k_pick, k_time, k_freq = jax.random.split(key, 5)
    lam = jax.random.beta(k_lam, cfg.mixup_alpha, cfg.mixup_alpha, (batch,))
    gate = jax.random.bernoulli(k_gate, cfg.mixup_prob, (batch,))
    pick = jax.random.randint(k_pick, (batch,), 0, n_ref)

    def stripes(k, size):
        kw, kp, kg = jax.random.split(k, 3)
        width = jax.random.uniform(kw, (batch,), minval=cfg.stripe_frac[0],
                                   maxval=cfg.stripe_frac[1]) * size
        start = jax.random.uniform(kp, (batch,)) * (size - width)
        g = jax.random.bernoulli(kg, cfg.dropout_prob, (batch,))
        return augment.StripeDraws(*(torch.from_numpy(np.array(a))
                                     for a in (width, start, g)))
    t = lambda a: torch.from_numpy(np.array(a))
    return augment.AugmentDraws(t(lam), t(gate), t(pick).long(),
                                time=stripes(k_time, hw[1]),
                                freq=stripes(k_freq, hw[0]))


@pytest.mark.parametrize("pool", ["in_batch", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_apply_matches_jax(pool, seed):
    """``apply_augment`` fed the JAX function's own draws equals
    ``spectrogram_augment`` of the JAX package (MixUp against the batch or
    a separate pool of 5, then the stripes), 1e-6; the gates and stripes
    are hit on these seeds (every branch runs)."""
    cfg = JC.SpecAugmentConfig(mixup_prob=0.6, dropout_prob=0.7,
                               stripe_frac=(0.1, 0.3))
    rng = np.random.default_rng(seed)
    spec = rng.random((8, 3, 40, 30)).astype(np.float32)
    y = rng.dirichlet(np.ones(6), 8).astype(np.float32)
    if pool == "in_batch":
        ref_spec, ref_y = spec, y
    else:
        ref_spec = rng.random((5, 3, 40, 30)).astype(np.float32)
        ref_y = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_s, want_y = jops.spectrogram_augment(
        key, jnp.asarray(spec), jnp.asarray(y), jnp.asarray(ref_spec),
        jnp.asarray(ref_y), cfg)
    d = _jax_draws(key, 8, len(ref_spec), (40, 30), cfg)
    assert bool(d.gate.any()) and bool(d.time.gate.any())
    got_s, got_y = augment.apply_augment(
        d, torch.from_numpy(spec), torch.from_numpy(y),
        torch.from_numpy(ref_spec), torch.from_numpy(ref_y))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6,
                               rtol=1e-6)
    assert float((got_s == 0).float().mean()) > 0.01       # stripes cut


def test_augment_draw_statistics():
    """20,000 draws: MixUp and stripe gates at their probabilities (±0.02),
    λ in [0, 1] with Beta(0.4, 0.4)'s mean 0.5 and variance 0.1389 (±0.01),
    picks within the pool, stripe widths within ``stripe_frac`` of the
    axis and each stripe inside it; one seed gives one draw."""
    cfg = TC.SpecAugmentConfig()
    n, hw = 20_000, (400, 300)
    d = augment.draw_augment(torch.Generator().manual_seed(0), n, 7, hw, cfg)
    assert abs(float(d.gate.float().mean()) - cfg.mixup_prob) < 0.02
    assert float(d.lam.min()) >= 0.0 and float(d.lam.max()) <= 1.0
    assert abs(float(d.lam.mean()) - 0.5) < 0.01
    assert abs(float(d.lam.var()) - 0.16 / (0.64 * 1.8)) < 0.01
    assert int(d.pick.min()) == 0 and int(d.pick.max()) == 6
    for s, size in ((d.time, hw[1]), (d.freq, hw[0])):
        assert abs(float(s.gate.float().mean()) - cfg.dropout_prob) < 0.02
        assert float(s.width.min()) >= cfg.stripe_frac[0] * size - 1e-3
        assert float(s.width.max()) <= cfg.stripe_frac[1] * size + 1e-3
        assert float(s.start.min()) >= 0.0
        assert float((s.start + s.width).max()) <= size + 1e-3
    again = augment.draw_augment(torch.Generator().manual_seed(0), n, 7, hw,
                                 cfg)
    assert torch.equal(again.lam, d.lam) and torch.equal(again.pick, d.pick)


def test_augment_with_gates_off_is_identity():
    cfg = TC.SpecAugmentConfig(mixup_prob=0.0, dropout_prob=0.0)
    rng = np.random.default_rng(3)
    spec = torch.from_numpy(rng.random((4, 3, 20, 16)).astype(np.float32))
    y = torch.from_numpy(rng.dirichlet(np.ones(6), 4).astype(np.float32))
    s, yy = augment.spectrogram_augment(torch.Generator().manual_seed(1),
                                        spec, y, spec.flip(0), y.flip(0), cfg)
    assert torch.equal(s, spec) and torch.equal(yy, y)


# --- batching and prefetch -------------------------------------------------------

def test_batch_iterator_matches_jax():
    rng = np.random.default_rng(4)
    arrays = {"x": rng.standard_normal((11, 3)).astype(np.float32),
              "y": rng.standard_normal((11, 6)).astype(np.float32)}
    for kw in (dict(shuffle=True, seed=3), dict(drop_last=False)):
        got = list(tdata.batch_iterator(arrays, 4, **kw))
        want = list(jdata.batch_iterator(arrays, 4, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in arrays:
                np.testing.assert_array_equal(g[k], w[k])
    mm = list(tdata.multimodal_batch_iterator(arrays["x"], arrays["x"],
                                              arrays["y"], 5))
    assert len(mm) == 2 and set(mm[0]) == {"eeg", "spec", "y"}


def test_prefetch_keeps_order_and_copies_when_synced():
    """Batches arrive in order as tensors on the device; with
    ``sync_transfers`` the producer's arrays are copied, so the source may
    reuse its buffers."""
    buf = np.zeros((2, 3), np.float32)

    def reuse():
        for i in range(5):
            buf[...] = i
            yield {"x": buf, "tag": i}

    got = list(tdata.prefetch_to_device(reuse(), size=2, device="cpu",
                                        sync_transfers=True))
    assert [b["tag"] for b in got] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)
    assert [float(b["x"][0, 0]) for b in got] == [0, 1, 2, 3, 4]


def test_prefetch_reraises_producer_errors():
    def bad():
        yield {"x": np.ones((2, 3), np.float32)}
        raise RuntimeError("corrupt parquet")

    it = tdata.prefetch_to_device(bad(), size=2, device="cpu")
    assert next(it)["x"].shape == (2, 3)
    with pytest.raises(RuntimeError, match="corrupt parquet"):
        next(it)


def test_prefetch_close_releases_the_producer():
    """Closing mid-stream stops the producer thread (within its 5 s drain
    bound) instead of leaving it blocked on a full queue."""
    def endless():
        i = 0
        while True:
            yield {"x": np.full((1,), i, np.float32)}
            i += 1

    before = threading.active_count()
    g = tdata.prefetch_to_device(endless(), size=2, device="cpu")
    assert float(next(g)["x"][0]) == 0.0
    assert threading.active_count() == before + 1
    t0 = time.monotonic()
    g.close()
    while threading.active_count() > before and time.monotonic() - t0 < 5:
        time.sleep(0.01)
    assert threading.active_count() == before


# --- checkpoints, trainer ---------------------------------------------------------

def _tiny(seed=5):
    """A small EEGNetAttentionRegularized state and two batches of 4."""
    r = np.random.default_rng(seed)
    torch.manual_seed(seed)
    model = tm.EEGNetAttentionRegularized(samples=SAMPLES, kern_length=8)
    tt.initialize_kaiming_weights(model, torch.Generator().manual_seed(seed))
    x = r.standard_normal((8, 1, 37, SAMPLES)).astype(np.float32)
    y = r.dirichlet(np.ones(6), 8).astype(np.float32)
    state = tt.create_train_state(model, tt.make_optimizer(1e-3))
    return state, [{"x": x[:4], "y": y[:4]}, {"x": x[4:], "y": y[4:]}]


def test_checkpoint_names_pruning_and_roundtrip(tmp_path):
    """best-<metric>, last and step_N snapshots with their .json metas; the
    ``keep`` newest step snapshots survive; a restore is bitwise."""
    state, _ = _tiny()
    ck = tt.CheckpointManager(str(tmp_path), "kldiv", keep=2)
    assert ck.step(0, state, {"kldiv": 1.0})
    assert not ck.step(1, state, {"kldiv": 2.0}, last_epoch=True)
    for s in (1, 2, 3):
        ck.save_step(s, state, {"epoch": s - 1})
    names = sorted(os.listdir(tmp_path))
    assert names == ["best-kldiv", "best-kldiv.json", "last", "last.json",
                     "step_2", "step_2.json", "step_3", "step_3.json"]
    assert ck.latest_step() == 3 and ck.best_epoch == 0
    assert ck.load_meta("step_3") == {"epoch": 2} and ck.load_meta("x") is None
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.conv1.weight.data.add_(1.0)
    state.step = 9
    ck.load_best(state)
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_checkpoint_diverts_on_hyperparam_change(tmp_path):
    """The JAX package's ``test_ckpt_diverts_on_hyperparam_change`` on the
    port's Trainer."""
    state, _ = _tiny()
    d = str(tmp_path / "ck")
    mk = lambda lam, opt: tt.Trainer(
        state, tt.TrainerConfig(epochs=1, l2_lambda=lam,
                                hyperparams={"optimizer": opt}), ckpt_dir=d)
    a = mk(0.0, "adam")
    assert a.ckpt.ckpt_dir == os.path.abspath(d)
    assert mk(0.0, "adam").ckpt.ckpt_dir == os.path.abspath(d)
    b = mk(1e-3, "adam")
    assert b.ckpt.ckpt_dir.startswith(os.path.abspath(d) + "_l2_lambda-")
    c = mk(1e-3, "sgd")
    assert c.ckpt.ckpt_dir.startswith(
        os.path.abspath(d) + "_l2_lambda_optimizer-")
    assert mk(1e-3, "adam").ckpt.ckpt_dir == b.ckpt.ckpt_dir
    b2 = mk(2e-3, "adam")
    assert b2.ckpt.ckpt_dir != b.ckpt.ckpt_dir
    assert mk(2e-3, "adam").ckpt.ckpt_dir == b2.ckpt.ckpt_dir


def _trainer(dir_, epochs, resume=False, plateau=None):
    state, batches = _tiny()
    cfg = tt.TrainerConfig(epochs=epochs, resume=resume,
                           eval_metrics=("kldiv", "accuracy"),
                           plateau=plateau, seed=11)
    return tt.Trainer(state, cfg, ckpt_dir=dir_), batches


def test_trainer_resume_matches_uninterrupted(tmp_path):
    """Train 2 epochs, then a fresh trainer resumes to 4 from step_2:
    bitwise the parameters, BatchNorm statistics and optimizer state of an
    uninterrupted 4-epoch run (the final best-checkpoint state and the
    ``last`` snapshot), the same loss history, best metric and out-of-fold
    predictions (dropout on: the generator is part of the snapshot)."""
    tr_a, ba = _trainer(str(tmp_path / "a"), 4)
    state_a, best_a, oof_a = tr_a.train_eval(lambda: iter(ba),
                                             lambda: iter(ba))
    tr_b1, bb = _trainer(str(tmp_path / "b"), 2)
    tr_b1.train_eval(lambda: iter(bb), lambda: iter(bb))
    tr_b2, bb2 = _trainer(str(tmp_path / "b"), 4, resume=True)
    state_b, best_b, oof_b = tr_b2.train_eval(lambda: iter(bb2),
                                              lambda: iter(bb2))
    assert tr_b2.history == tr_a.history
    assert best_b == best_a
    np.testing.assert_array_equal(oof_a, oof_b)
    for k, v in state_a.model.state_dict().items():
        assert torch.equal(v, state_b.model.state_dict()[k]), k
    for k, v in state_a.opt_state.items():
        assert torch.equal(v, state_b.opt_state[k]), k
    assert state_a.step == state_b.step        # the best epoch's snapshot
    sa = tt.CheckpointManager(str(tmp_path / "a")).load_meta("step_4")
    sb = tt.CheckpointManager(str(tmp_path / "b")).load_meta("step_4")
    assert sa == sb
    last = [torch.load(tmp_path / d / "last" / "state.pt", weights_only=True)
            for d in ("a", "b")]
    assert last[0]["step"] == last[1]["step"] == 8
    for k, v in last[0]["model"].items():
        assert torch.equal(v, last[1]["model"][k]), k


def test_trainer_resume_restores_plateau_state(tmp_path):
    """The plateau controller is host-side state: a resumed run continues
    with the decayed learning rate, not the initial one."""
    mk = lambda d, e, r=False: _trainer(
        d, e, r, tt.ReduceLROnPlateau(1e-3, factor=0.5, patience=0,
                                      threshold=0.999))
    tr_a, ba = mk(str(tmp_path / "a"), 4)
    state_a, _, _ = tr_a.train_eval(lambda: iter(ba), lambda: iter(ba))
    tr_b1, bb = mk(str(tmp_path / "b"), 2)
    tr_b1.train_eval(lambda: iter(bb), lambda: iter(bb))
    assert tr_b1.cfg.plateau.lr < 1e-3
    tr_b2, bb2 = mk(str(tmp_path / "b"), 4, True)
    state_b, _, _ = tr_b2.train_eval(lambda: iter(bb2), lambda: iter(bb2))
    assert tr_b2.cfg.plateau.lr == tr_a.cfg.plateau.lr
    assert float(state_b.opt_state["lr"]) == float(state_a.opt_state["lr"])
    for k, v in state_a.model.state_dict().items():
        assert torch.equal(v, state_b.model.state_dict()[k]), k


def test_trainer_passes_epoch_to_loader(tmp_path):
    _, batches = _tiny()
    seen = []

    def tl(epoch=0):
        seen.append(epoch)
        return iter(batches[:1])

    _trainer(str(tmp_path / "ck"), 2)[0].train_eval(tl, lambda: iter(batches))
    assert seen == [0, 1]
    _trainer(str(tmp_path / "ck"), 4, resume=True)[0].train_eval(
        tl, lambda: iter(batches))
    assert seen == [0, 1, 2, 3]
    calls = []
    tr, _ = _trainer(None, 1)
    tr.train_eval(lambda: calls.append(1) or iter(batches),
                  lambda: iter(batches))
    assert calls == [1]


def test_trainer_epoch_reports_skipped_nonfinite_batches(caplog):
    """An epoch with a NaN batch reports the mean of the applied steps and
    logs the sentinel's skip count."""
    tr, batches = _trainer(None, 1)
    bad = dict(batches[1])
    bad["x"] = bad["x"].copy()
    bad["x"][0, 0, 0, :4] = np.nan
    with caplog.at_level(logging.WARNING):
        loss = tr.train_epoch(iter([batches[0], bad]), epoch=0)
    assert np.isfinite(loss)
    assert any("1/2 batches skipped by the non-finite sentinel" in r.message
               for r in caplog.records)
    assert tr.state.step == 2
    with pytest.raises(ValueError, match="no batches"):
        tr.train_epoch(iter([]), epoch=1)


def test_trainer_schedule_steers_lr_and_mesh_is_not_ported():
    """The schedule steers the learning rate.  ``mesh`` is ported now: in
    a world of one rank (gloo, in this process) ``Trainer(mesh=...)``
    takes the data-parallel step, which equals the single-device epoch
    bitwise once the single-device trainer draws from rank 0's generator
    (``fold_in(rng, 0)``)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        parallel)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.steps \
        import fold_in
    tr, batches = _trainer(None, 1)
    tr.cfg.lr_schedule = tt.step_decay(1e-2, 1, 0.5)
    tr.train_epoch(iter(batches), epoch=0)
    assert float(tr.state.opt_state["lr"]) == pytest.approx(5e-3)

    def run(dev):
        mesh = parallel.make_mesh(TC.MeshConfig(data=1), dev)
        state, _ = _tiny()
        t = tt.Trainer(state, tt.TrainerConfig(seed=11), mesh=mesh)
        return t.train_epoch(iter(batches), epoch=0), t.state
    (loss_m, st_m), = parallel.launch.spawn(run, 1, "cpu")
    single, _ = _trainer(None, 1)
    single.rng = fold_in(single.rng, 0, torch.device("cpu"))
    loss_s = single.train_epoch(iter(batches), epoch=0)
    assert loss_m == loss_s and st_m.step == 2
    for a, b in zip(st_m.model.state_dict().values(),
                    single.state.model.state_dict().values()):
        assert torch.equal(a, b)


# --- host gather, synthetic data, cross-validation, analysis ----------------------

def test_gather_windows_repairs_nans():
    """``out[i] = src[idx[i]]`` with each channel's NaNs set to the
    channel's mean (0 for an all-NaN channel), against a plain loop; the
    host library's gather and its numpy version agree bitwise."""
    rng = np.random.default_rng(6)
    src = rng.standard_normal((5, 4, 50)).astype(np.float32)
    src[1, 2, 7:9] = np.nan
    src[3, 0, :] = np.nan
    idx = np.array([3, 1, 1, 4], np.int64)
    want = src[idx].copy()
    for w in want:
        for ch in w:
            bad = np.isnan(ch)
            ch[bad] = 0.0 if bad.all() else np.mean(ch[~bad])
    got = gather_windows(src, idx)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got, gather_windows_numpy(src, idx))
    with pytest.raises(ValueError):
        gather_windows_into(src, idx, np.empty((4, 4, 49), np.float32))


def test_synthetic_data_matches_jax():
    """The numpy copies draw the same arrays from the same generator."""
    for fn, kw in (("synthetic_raw_eeg", dict(n_points=2000)),
                   ("synthetic_raw_spectrogram", dict(shape=(80, 60)))):
        got = getattr(tdata, fn)(5, np.random.default_rng(1), **kw)
        want = getattr(jdata, fn)(5, np.random.default_rng(1), **kw)
        np.testing.assert_array_equal(got, want)
    got = tdata.dummy_metadata(np.random.default_rng(3), 30)
    want = jdata.dummy_metadata(np.random.default_rng(3), 30)
    assert got.equals(want)


def test_config_copies_match_jax():
    for name in ("SpecAugmentConfig", "TrainerConfig"):
        assert dataclasses.asdict(getattr(TC, name)()) == \
            dataclasses.asdict(getattr(JC, name)())
    assert TC.CLASSES == JC.CLASSES and TC.TGT_VOTE_COLS == JC.TGT_VOTE_COLS
    assert TC.NAME2LABEL == JC.NAME2LABEL


def test_cv_splitters_match_jax():
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 6, 120)
    groups = rng.integers(0, 17, 120)
    for got, want in ((tt.stratified_kfold(labels, 5, seed=3),
                       jt.stratified_kfold(labels, 5, seed=3)),
                      (tt.group_kfold(groups, 5), jt.group_kfold(groups, 5))):
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    votes = rng.integers(0, 5, (10, 6))
    np.testing.assert_array_equal(tt.cv.aggregate_vote_labels(votes),
                                  jt.cv.aggregate_vote_labels(votes))
    soft = rng.dirichlet(np.ones(6), 30)
    assert tt.detect_class_imbalance(soft) == jt.detect_class_imbalance(soft)
    assert tt.detect_class_imbalance(labels) == \
        jt.detect_class_imbalance(labels)


def test_run_cv_scatters_oof_and_analyze_ranks_snapshots(tmp_path):
    """``run_cv`` over a stand-in trainer fills each validation row once;
    ``analyze_checkpoints`` ranks the manager's metadata as the JAX
    package's does."""
    class Stub:
        def train_eval(self, tl, vl, fold):
            n = len(vl)
            return None, float(fold), np.full((n, 6), fold, np.float32)

    splits = tt.stratified_kfold(np.arange(20) % 4, 4)
    oof, scores = tt.run_cv(lambda f: Stub(), lambda tr, va: (tr, va),
                            splits, 20)
    assert scores == [0.0, 1.0, 2.0, 3.0]
    for fold, (_, va) in enumerate(splits):
        assert (oof[va] == fold).all()
    state, _ = _tiny()
    ck = tt.CheckpointManager(str(tmp_path))
    ck.step(0, state, {"kldiv": 0.7, "f1": 0.2})
    ck.step(1, state, {"kldiv": 0.5, "f1": 0.3}, last_epoch=True)
    got = tt.analyze_checkpoints(str(tmp_path), "kldiv")
    want = jt.analyze_checkpoints(str(tmp_path), "kldiv")
    assert got == want and got[0]["epoch"] == 1
    assert tt.analyze_checkpoints(str(tmp_path / "none")) == (None, [])


# --- the entry points on the CPU -----------------------------------------------------

def test_train_entry_two_steps_on_cpu():
    """``train_entry(device="cpu", batch=2)``: the full-width bf16 program,
    preprocessing through the plain IIR versions; two steps apply
    (finite loss and gradient norm, step 2), move the parameters and
    keep them float32."""
    step, state, (eeg, spec, y) = train_entry(device="cpu", batch=2)
    assert eeg.shape == (2, 20, 10_000) and spec.shape == (2, 400, 300)
    assert bool(torch.isfinite(eeg).all())
    assert torch.allclose(y.sum(1), torch.ones(2))
    w0 = state.model.fc2.weight.detach().clone()
    for _ in range(2):
        state, m = step(state, eeg, spec, y)
        assert not bool(m["nonfinite"])
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert state.step == 2
    assert not torch.equal(state.model.fc2.weight, w0)
    assert state.model.spectrogram_model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_train_multimodal_demo_on_cpu(tmp_path):
    """One epoch of the demo loop with the mirror augmentation: snapshots
    under ``<dir>/multimodal``, a finite best KLDiv, the history."""
    tr, best = train_multimodal(str(tmp_path), device="cpu", epochs=1,
                                augment=True)
    names = set(os.listdir(tmp_path / "multimodal"))
    assert {"best-kldiv", "last", "step_1", "hyperparams.json"} <= names
    assert np.isfinite(best) and len(tr.history["train_loss"]) == 1
    assert tr.state.step == 3
    assert tr.state.model.eeg_model.dense1.in_features == \
        16 * (DEMO_SIGNAL.fixed_length // 32)
