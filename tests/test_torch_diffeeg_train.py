"""The PyTorch port's DiffEEG trainer and entries against the JAX
package's: one step fed the JAX step's draws (loss, gradients, parameters
after Adam, EMA), the NaN sentinel, ``fuse_accum``, ``remat``, amp,
checkpoints with a bitwise resume, the EMA evaluation, the epoch batch
queue, ``train_diffeeg``'s transform, and both entries on the CPU.

Small shapes: 2 channels × 64 samples, hidden 8, 6 diffusion steps, K=2
micro-batches of 4, STFT 16/8; the entries at the demo configuration.
Bounds at each test."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import diffusion as jd
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu import runtime as jrt
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu.models import (
    diffeeg as jdiff)
from multimodal_brain_pattern_identification_xai_tpu.train.state import (
    TrainState as JState)
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import entry
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
    NativeBatchQueue)

KW = dict(n_channels=2, input_length=64, hidden_channels=8,
          n_diffusion_steps=6, gradient_accumulate_every=2, batch_size=4,
          stft_n_fft=16, stft_noverlap=8, lr=1e-3, dropout=0.0)
K, B, CH, T = 2, 4, 2, 64


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _batch(seed=0, classes=None):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((K, B, CH, T)).astype(np.float32)
    lab = rng.integers(0, 6, (K, B)) if classes is None else classes
    return xs, np.eye(6, dtype=np.float32)[lab]


def _trainer(sd=None, dtype=torch.float32, cfg=None, **model_kw):
    cfg = cfg or TC.DiffEEGConfig(**KW)
    model = tm.DiffEEG(n_channels=CH, hidden=cfg.hidden_channels,
                       dropout=model_kw.pop("dropout", 0.0), **model_kw)
    model.load_state_dict(sd if sd is not None
                          else tm.seeded_state_dict(model, 0))
    return tt.DiffEEGTrainer(model.to(dtype), cfg, seed=0)


def _params(tr):
    return [p.detach().clone() for p in tr.model.parameters()]


# --- one step against the JAX step ------------------------------------------


def _jax_draws(key, xs):
    """The JAX step's draws (``diffeeg_trainer.py:89``): ``split(key, K)``,
    then ``split(k, 4)`` → mix scores, t, noise, dropout."""
    out = []
    for k, x0 in zip(jax.random.split(key, xs.shape[0]), xs):
        km, kt, kn, _ = jax.random.split(k, 4)
        n = x0.shape[0]
        out.append((np.asarray(jax.random.uniform(km, (n,))),
                    np.asarray(jax.random.randint(kt, (n,), 0, 6)),
                    np.asarray(jax.random.normal(kn, x0.shape, x0.dtype))))
    return out


def _jax_loss_and_grads(params, key, xs, ys):
    """The JAX step's micro-batch loss (``diffeeg_trainer.py:81-110``),
    averaged with its gradients over the K micro-batches."""
    sched = jd.make_schedule(6)
    jmod = jm.DiffEEG(n_channels=CH, hidden=8, dropout=0.0)

    def micro(p, k, x0, y):
        km, kt, kn, kd = jax.random.split(k, 4)
        spec = jops.stft_log1p_interp(x0, out_t=T, nperseg=16, noverlap=8)
        spec = jdiff.recombine_spectrograms(km, spec, jnp.argmax(y, -1), 6)
        t = jax.random.randint(kt, (x0.shape[0],), 0, 6)
        noise = jax.random.normal(kn, x0.shape, x0.dtype)
        a = sched.alpha_bar[t].reshape(-1, 1, 1)
        xt = jnp.sqrt(a) * x0 + jnp.sqrt(1 - a) * noise
        eps = jmod.apply({"params": p}, xt, y, t.astype(jnp.float32), spec,
                         True, rngs={"dropout": kd})
        return jnp.mean((eps - noise) ** 2)

    ls, gs = [], []
    for k, x0, y in zip(jax.random.split(key, K), xs, ys):
        loss, g = jax.value_and_grad(micro)(params, k, jnp.asarray(x0),
                                            jnp.asarray(y))
        ls.append(loss)
        gs.append(g)
    return sum(ls) / K, jax.tree_util.tree_map(lambda *a: sum(a) / K, *gs)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX trainer's initial weights (as a state dict), a batch, its
    step's draws, and in float64 (``jax.enable_x64``): the composed loss
    and gradients, and the JAX trainer's own step (loss, params, EMA)."""
    jtr = jt.DiffEEGTrainer(jm.DiffEEG(n_channels=CH, hidden=8, dropout=0.0),
                            JC.DiffEEGConfig(**KW), seed=0)
    sd = tm.jax_variables_to_state_dict({"params": jtr.state.params})
    xs, ys = _batch()
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jtr.state.params)
        x64, y64 = xs.astype(np.float64), ys.astype(np.float64)
        loss, grads = _jax_loss_and_grads(p64, key, x64, y64)
        st = JState.create(apply_fn=None, params=p64, tx=optax.adam(KW["lr"]))
        new, ema, step_loss = jtr._build_train_step()(
            st, jd.EMA.create(p64, 0.995, 20, 10), key, jnp.asarray(x64),
            jnp.asarray(y64))
        draws = _jax_draws(key, x64)
    grads, params, ema = (tm.jax_variables_to_state_dict({"params": v})
                          for v in (grads, new.params, ema.params))
    return dict(sd=sd, xs=xs, ys=ys, draws=draws, loss=float(loss),
                step_loss=float(step_loss), grads=grads, params=params,
                ema=ema)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_step_matches_jax_step_fed_its_draws(jax_step, dtype):
    """One step (dropout 0), the JAX step's draws injected, against the
    JAX step in float64 (on the CPU, XLA's float32 gradients are the
    noisier side, see ``tests/test_torch_train.py``): loss within 1e-6
    relative; each gradient within 1e-5 of its tensor's max |g| (plus 1e-6
    of the model's largest) in float32, 1e-6 in float64; the parameters
    after Adam (lr 1e-3, whose first step moves each by ~lr) and the EMA
    (reset to them at step 1 < 20) within 1e-6."""
    j = jax_step
    assert j["loss"] == pytest.approx(j["step_loss"], rel=1e-12)
    tr = _trainer(j["sd"], dtype)
    draws = [(_t(s, dtype), _t(t).long(), _t(n, dtype)) for s, t, n in
             j["draws"]]
    xs, ys = _t(j["xs"], dtype), _t(j["ys"], dtype)
    names = [n for n, _ in tr.model.named_parameters()]
    gsum = None
    for k in range(K):
        loss = tr.micro_loss(xs[k], ys[k], draws[k])
        g = torch.autograd.grad(loss, list(tr.model.parameters()))
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
    gmax = max(float(v.abs().max()) for v in j["grads"].values())
    bound = 1e-5 if dtype == torch.float32 else 1e-6
    for n, g in zip(names, gsum):
        want = j["grads"][n].double()
        err = float((g.double() / K - want).abs().max())
        assert err <= bound * float(want.abs().max()) + 1e-6 * gmax, n
    m = tr.train_step(xs, ys, draws)
    assert float(m["loss"]) == pytest.approx(j["loss"], rel=1e-6)
    assert not bool(m["nonfinite"]) and tr.state.step == 1
    ema = tr.state.ema
    for n, p in zip(names, tr.model.parameters()):
        np.testing.assert_allclose(p.detach().double().numpy(),
                                   j["params"][n].double().numpy(), atol=1e-6)
    np.testing.assert_allclose(
        ema.double().numpy(),
        torch.cat([j["ema"][n].reshape(-1) for n in names]).double().numpy(),
        atol=1e-6)


def test_nan_sentinel_keeps_state_bitwise():
    """A micro-batch holding NaN: ``nonfinite`` set, parameters, optimizer
    state and EMA bitwise unchanged, the step advanced; a finite batch then
    updates."""
    tr = _trainer()
    xs, ys = _batch()
    tr.train_step(_t(xs), _t(ys))
    before = (_params(tr), {k: v.clone() for k, v in tr.state.opt_state.items()},
              tr.state.ema.clone())
    bad = xs.copy()
    bad[1, 2, 0, 5:9] = np.nan
    m = tr.train_step(_t(bad), _t(ys))
    assert bool(m["nonfinite"]) and not np.isfinite(float(m["loss"]))
    assert tr.state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(_params(tr), before[0]))
    assert all(torch.equal(tr.state.opt_state[k], v)
               for k, v in before[1].items())
    assert torch.equal(tr.state.ema, before[2])
    m = tr.train_step(_t(xs), _t(ys))
    assert not bool(m["nonfinite"])
    assert any(not torch.equal(a, b) for a, b in zip(_params(tr), before[0]))


def test_fuse_accum_equals_unfused():
    """``fuse_accum=2`` (one pass of 8) against 2 passes of 4, float64, on
    the same draws (the micro-batches hold disjoint classes, so the mixup
    partners are the same): loss, gradient norm and parameters within
    1e-12; 3 does not divide K=2 and raises."""
    xs, ys = _batch(1, classes=np.array([[0, 1, 2, 0], [3, 4, 5, 3]]))
    rng = np.random.default_rng(2)
    draws = [(torch.as_tensor(rng.random(B)),
              torch.as_tensor(rng.integers(0, 6, B)),
              torch.as_tensor(rng.standard_normal((B, CH, T))))
             for _ in range(K)]
    fused = [tuple(torch.cat(parts) for parts in zip(*draws))]
    out = []
    for f, d in ((1, draws), (2, fused)):
        cfg = TC.DiffEEGConfig(**{**KW, "fuse_accum": f})
        tr = _trainer(dtype=torch.float64, cfg=cfg)
        m = tr.train_step(_t(xs, torch.float64), _t(ys, torch.float64), d)
        out.append((m, _params(tr)))
    (m1, p1), (m2, p2) = out
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-12)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    tr = _trainer(cfg=TC.DiffEEGConfig(**{**KW, "fuse_accum": 3}))
    with pytest.raises(ValueError, match="fuse_accum"):
        tr.train_step(_t(xs), _t(ys))


def test_remat_replays_dropout_draws():
    """``remat`` (``torch.utils.checkpoint``) with dropout 0.3: the
    recompute replays the forward's dropout masks, so the step's loss,
    gradient norm and parameters equal those without it bitwise."""
    xs, ys = _batch(3)
    out = []
    for remat in (False, True):
        cfg = TC.DiffEEGConfig(**{**KW, "remat": remat})
        tr = _trainer(cfg=cfg, dropout=0.3)
        m = tr.train_step(_t(xs), _t(ys))
        out.append((m, _params(tr)))
    (m1, p1), (m2, p2) = out
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_loss_falls_and_params_stay_float32(amp):
    """8 steps on one batch at lr 1e-2 (the JAX package's amp test,
    ``tests/test_diffusion.py:324-356``): finite losses, the last three's
    mean below the first three's, float32 parameters and optimizer state."""
    cfg = TC.DiffEEGConfig(**{**KW, "lr": 1e-2, "amp": amp})
    model = tm.DiffEEG(n_channels=CH, hidden=8,
                       dtype=torch.bfloat16 if amp else None)
    model.load_state_dict(tm.seeded_state_dict(model, 0))
    tr = tt.DiffEEGTrainer(model, cfg, seed=0)
    xs, ys = _batch(4)
    losses = [float(tr.train_step(_t(xs), _t(ys))["loss"]) for _ in range(8)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype in (torch.float32, torch.int32)
               for v in tr.state.opt_state.values())


# --- checkpoints, resume, evaluation ----------------------------------------


def _stream(start=0):
    for i in range(start, start + 1000):
        g = np.random.default_rng((7, i))
        yield (g.standard_normal((B, CH, T)).astype(np.float32),
               np.eye(6, dtype=np.float32)[g.integers(0, 6, B)])


def test_save_and_bitwise_resume(tmp_path, caplog):
    """4 steps with checkpoints every 2 against 2 steps, then a new trainer
    resumed from ``step_2`` to 4 (the stream fast-forwarded by step × K):
    parameters, optimizer state, EMA and losses bitwise equal.  A
    checkpoint without the generator's state resumes with a warning."""
    cfg = TC.DiffEEGConfig(**{**KW, "save_and_sample_every": 2})

    def make(d):
        model = tm.DiffEEG(n_channels=CH, hidden=8)
        model.load_state_dict(tm.seeded_state_dict(model, 0))
        return tt.DiffEEGTrainer(model, cfg, ckpt_dir=str(tmp_path / d),
                                 seed=0)

    a = make("a")
    ha = a.train(_stream, total_steps=4)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "step_2", "step_2.json", "step_4", "step_4.json"]
    make("b").train(_stream, total_steps=2)
    b = make("b")
    assert b.load() == 2 and b.state.step == 2
    hb = b.train(_stream, total_steps=4)
    assert hb["loss"] == ha["loss"][2:]
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))
    assert torch.equal(a.state.ema, b.state.ema)
    assert all(torch.equal(v, b.state.opt_state[k])
               for k, v in a.state.opt_state.items())
    d = a.ckpt.load("step_4")
    del d["rng"]
    torch.save(d, tmp_path / "a" / "step_4" / "state.pt")
    c = make("a")
    with caplog.at_level(logging.WARNING):
        assert c.load() == 4
    assert "no generator state" in caplog.text
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(c)))


def test_evaluate_uses_ema_params():
    """The generative evaluation samples with the EMA weights: zeroing
    the online parameters leaves it unchanged, moving the EMA changes it
    (``tests/test_diffusion.py:245-276``)."""
    cfg = TC.DiffEEGConfig(**{**KW, "gradient_accumulate_every": 1})
    tr = _trainer(cfg=cfg)
    rng = np.random.default_rng(0)
    val = [(rng.standard_normal((2, CH, T)).astype(np.float32),
            np.eye(6, dtype=np.float32)[[0, 1]])]
    base = tr.evaluate(val, frac=1.0)
    assert set(base) == {"mmd", "frechet", "pearson"}
    with torch.no_grad():
        for p in tr.model.parameters():
            p.zero_()
    assert tr.evaluate(val, frac=1.0) == base
    tr.state.ema = tr.state.ema + 1.0
    assert tr.evaluate(val, frac=1.0)["mmd"] != pytest.approx(base["mmd"])


# --- the data path of train_diffeeg -----------------------------------------


@pytest.mark.parametrize("shuffle,ring", [(True, 0), (True, 3), (False, 0)])
def test_native_batch_queue_matches_jax(monkeypatch, shuffle, ring):
    """The same batches, in the same order, as the JAX queue's native
    library (NaNs repaired with the channel's float64 mean, the last
    partial batch dropped), exactly: the port's queue runs its own copy of
    that library.  The JAX queue's numpy path repairs with a float32
    ``nanmean``, within 1e-6 of the repaired values and equal elsewhere.
    A ring buffer cycles its arrays."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((23, 3, 16)).astype(np.float32)
    x[4, 1, 2:5] = np.nan
    x[9, 2, :] = np.nan
    y = rng.random((23, 6)).astype(np.float32)
    kw = dict(shuffle=shuffle, seed=5, pop_ring=ring)

    def batches(q):
        return [{k: v.copy() for k, v in b.items()} for b in q]

    native = batches(jrt.NativeBatchQueue(x, y, 4, **kw))
    monkeypatch.setattr(jrt.loader, "_load_lib", lambda: None)
    plain = batches(jrt.NativeBatchQueue(x, y, 4, **kw))
    q = NativeBatchQueue(x, y, 4, **kw)
    got = batches(q)
    assert len(q) == len(got) == len(plain) == len(native) == 5
    for a, b, c in zip(got, plain, native):
        np.testing.assert_array_equal(a["x"], c["x"])
        np.testing.assert_array_equal(a["y"], c["y"])
        np.testing.assert_array_equal(a["y"], b["y"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=1e-6)
    if ring:
        assert len({id(b["x"]) for b in q}) == ring


def test_training_windows_match_jax_transform():
    """``diffeeg_training_windows`` (EKG dropped, ``eeg_transform`` with
    19 channels and no magic-8, chunks of 256 windows, then (N, 19, L/5))
    equals the JAX CLI's transform within 1e-5 of the output's max."""
    rng = np.random.default_rng(0)
    raw = (rng.standard_normal((3, 2000, 20)) * 40).astype(np.float32)
    tcfg = JC.EEGTransformConfig(apply_chris_magic_ch8=False, n_feats=19)
    want = np.asarray(jops.eeg_transform(jnp.asarray(raw[..., :19]), tcfg))
    got = entry.diffeeg_training_windows(raw, "cpu", chunk=2)
    assert got.shape == (3, 19, 400)
    np.testing.assert_allclose(got, want.transpose(0, 2, 1),
                               atol=1e-5 * np.abs(want).max())


# --- the entries on the CPU --------------------------------------------------


def test_demo_entries_on_cpu(tmp_path):
    """``train_diffeeg`` at the demo configuration (12 steps: a checkpoint
    and an evaluation at step 10), then ``generate``: six
    ``generated_class_{c}.npy`` of (2, 4, 256), finite, from the EMA
    weights of ``step_10``; ``generate`` without a checkpoint raises unless
    ``demo``; either demo path given a ``cfg`` raises."""
    tr, hist = entry.train_diffeeg(str(tmp_path), device="cpu", steps=12)
    assert len(hist["loss"]) == 12 and len(hist["eval"]) == 1
    assert all(np.isfinite(hist["loss"]))
    assert tr.state.step == 12 and tr.ckpt.latest_step() == 10
    paths = entry.generate(str(tmp_path), device="cpu", demo=True)
    assert sorted(paths) == list(range(6))
    for c, p in paths.items():
        assert p.endswith(f"generated/generated_class_{c}.npy")
        out = np.load(p)
        assert out.shape == (2, 4, 256) and np.isfinite(out).all()
    with pytest.raises(FileNotFoundError, match="train_diffeeg"):
        entry.generate(str(tmp_path / "none"), device="cpu",
                       cfg=entry.diffeeg_demo_config())
    with pytest.raises(ValueError, match="cfg"):
        entry.generate(str(tmp_path), device="cpu", demo=True,
                       cfg=entry.diffeeg_demo_config())
    with pytest.raises(ValueError, match="cfg"):
        entry.train_diffeeg(str(tmp_path / "c"), device="cpu", steps=1,
                            cfg=entry.diffeeg_demo_config())


def test_train_diffeeg_raw_windows_resume_on_cpu(tmp_path):
    """The non-demo path on 30 raw (10000, 20) windows (27 to train in
    epoch-shuffled micro-batches of 8, 3 to validate): 3 steps against 2
    then a resume to 3, bitwise."""
    rng = np.random.default_rng(0)
    raw = (rng.standard_normal((30, 10_000, 20)) * 40).astype(np.float32)
    y = rng.random((30, 6)).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    cfg = TC.DiffEEGConfig(hidden_channels=8, n_diffusion_steps=6,
                           gradient_accumulate_every=2, batch_size=8,
                           save_and_sample_every=2, evaluate_every=100)
    kw = dict(device="cpu", raw=raw, y=y, cfg=cfg)
    a, ha = entry.train_diffeeg(str(tmp_path / "a"), steps=3, **kw)
    entry.train_diffeeg(str(tmp_path / "b"), steps=2, **kw)
    b, hb = entry.train_diffeeg(str(tmp_path / "b"), steps=3, resume=True,
                                **kw)
    assert len(ha["loss"]) == 3 and hb["loss"] == ha["loss"][2:]
    assert all(torch.equal(x, z) for x, z in zip(_params(a), _params(b)))
    assert torch.equal(a.state.ema, b.state.ema)
