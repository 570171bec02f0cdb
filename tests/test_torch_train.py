"""The PyTorch port's training layer against the JAX package's
``train/``: losses, metrics, schedules, the optax chains of
``make_optimizer``, the train step (loss, gradients, a trajectory, the NaN
sentinel), dropout from an explicit generator and bf16 activations.

Small shapes: ``EEGNetAttentionRegularized(samples=128, kern_length=16)``
and ``SpectrogramCNN`` on 64×48 planes, B=8, weights from flax's init with
BatchNorm moved off identity, carried over by ``jax_variables_to_state_dict``.
Dropout is off on both sides for the parity tests (the flax interceptor of
``tests/test_torch_models.py``; p = 0 in the port).  Bounds are stated at
each test."""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from flax.training import train_state as flax_train_state

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.models.layers import (
    bilinear_resize)
from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
    steps as tsteps)

S, K, B, HW = 128, 16, 8, (64, 48)
L2 = 1e-3
LR = 1e-3


def _soft(rng, n, c=6, zeros=False):
    t = rng.random((n, c)).astype(np.float32)
    if zeros:
        t[:, ::3] = 0.0
    return t / t.sum(1, keepdims=True)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _perturbed(variables, seed):
    """flax init leaves BatchNorm at identity; move its statistics and
    affine so the weight mapping and the running updates are exercised."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), leaf.dtype)
        if "mean" in name or "BatchNorm" in name or "bn" in name:
            return leaf + jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                                      leaf.dtype)
        return leaf
    return {k: jax.tree_util.tree_map_with_path(move, variables[k])
            for k in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def pair():
    """(flax model, variables, numpy batch) of the small multimodal pair."""
    rng = np.random.default_rng(0)
    batch = {"eeg": rng.standard_normal((B, 1, 37, S)).astype(np.float32),
             "spec": rng.standard_normal((B, 3) + HW).astype(np.float32),
             "y": _soft(rng, B)}
    mm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=S, kern_length=K),
        spectrogram_model=jm.SpectrogramCNN())
    v = mm.init(jax.random.PRNGKey(0), jnp.asarray(batch["eeg"][:2]),
                jnp.asarray(batch["spec"][:2]))
    return mm, _perturbed(v, 1), batch


def _port_model(v, dropout=False):
    m = tm.MultimodalModel(
        tm.EEGNetAttentionRegularized(samples=S, kern_length=K),
        tm.SpectrogramCNN())
    m.load_state_dict(tm.jax_variables_to_state_dict(v))
    if not dropout:
        for d in m.modules():
            if isinstance(d, tm.Dropout):
                d.p = 0.0
    return m


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- losses and metrics ----------------------------------------------------

@pytest.mark.parametrize("name", ["kldiv_with_logits", "kldiv_with_log_probs",
                                  "cross_entropy_with_logits"])
def test_losses_match_jax(name):
    """Soft targets with zero entries (0·log 0 := 0); 1e-6 relative."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((16, 6)) * 3).astype(np.float32)
    if name == "kldiv_with_log_probs":
        logits = np.asarray(jax.nn.log_softmax(logits, -1))
    t = _soft(rng, 16, zeros=True)
    want = float(getattr(jt, name)(jnp.asarray(logits), jnp.asarray(t)))
    got = float(getattr(tt, name)(torch.from_numpy(logits),
                                  torch.from_numpy(t)))
    assert got == pytest.approx(want, rel=1e-6)


def test_l2_regularization_matches_jax(pair):
    """The port sums λ·Σw² over the weights of every Conv2d and Linear;
    JAX over the flax leaves named kernel / embedding: the same leaves
    (counted) and the same value, 1e-6 relative."""
    _, v, _ = pair
    m = _port_model(v)
    want = float(jt.l2_regularization(v["params"], L2))
    got = float(tt.l2_regularization(m, L2))
    assert got == pytest.approx(want, rel=1e-6)
    n_jax = sum(1 for path, _ in
                jax.tree_util.tree_leaves_with_path(v["params"])
                if "kernel" in str(path[-1]).lower())
    assert len(tt.losses.l2_weights(m)) == n_jax
    assert float(tt.l2_regularization(m, 0.0)) == 0.0


def test_evaluator_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    t = _soft(rng, 40)
    names = ["kldiv", "ce", "accuracy", "f1"]
    want = jt.Evaluator(names).evaluate(jnp.asarray(t), jnp.asarray(logits))
    got = tt.Evaluator(names).evaluate(torch.from_numpy(t),
                                       torch.from_numpy(logits))
    assert set(got) == set(want)
    for k in names:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    with pytest.raises(ValueError):
        tt.Evaluator(["nope"])


def test_confusion_prf_and_accuracies_match_jax():
    """Integer counts exactly; precision, recall, F1 and the accuracies at
    1e-6."""
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 6, 50)
    true = rng.integers(0, 5, 50)              # class 5 never true
    np.testing.assert_array_equal(
        tt.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(true),
                            6).numpy(),
        np.asarray(jt.confusion_matrix(jnp.asarray(pred), jnp.asarray(true),
                                       6)))
    got = tt.macro_precision_recall_f1(torch.from_numpy(pred),
                                       torch.from_numpy(true), 6)
    want = jt.macro_precision_recall_f1(jnp.asarray(pred), jnp.asarray(true),
                                        6)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=1e-6)
    logits = rng.standard_normal((50, 6)).astype(np.float32)
    t = _soft(rng, 50)
    for fn in ("hard_accuracy", "soft_accuracy"):
        g = float(getattr(tt, fn)(torch.from_numpy(logits),
                                  torch.from_numpy(t)))
        w = float(getattr(jt, fn)(jnp.asarray(logits), jnp.asarray(t)))
        assert g == pytest.approx(w, rel=1e-6), fn


# --- schedules ---------------------------------------------------------------

SCHEDULES = {
    "warmup_cosine": lambda m: m.warmup_cosine_schedule(5, 50, 1e-4, 1e-3,
                                                        1e-5),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine_annealing(
        7, 40, 2e-3, 1e-5),
    "cosine_with_warmup": lambda m: m.cosine_schedule_with_warmup(6, 45,
                                                                  3e-3),
    "step_decay": lambda m: m.step_decay(1e-2, 7, 0.5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """50 steps (past the end of each schedule), 1e-6 relative; JAX
    evaluates in float32, where the cosine's tail (1 + cos → 0) cancels,
    so also 1e-9 absolute (1e-6 of the peak rates, ~1e-3)."""
    want = SCHEDULES[name](jt)
    got = SCHEDULES[name](tt)
    for s in range(50):
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau_matches_jax(mode):
    rng = np.random.default_rng(4)
    metrics = np.cumsum(rng.standard_normal(50)) * 0.1 + 5.0
    a = jt.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=1e-5,
                             mode=mode)
    b = tt.ReduceLROnPlateau(1e-3, factor=0.5, patience=2, min_lr=1e-5,
                             mode=mode)
    for x in metrics:
        assert b.step(float(x)) == a.step(float(x))
        assert (b.best, b.num_bad) == (a.best, a.num_bad)


# --- the optimizer -----------------------------------------------------------

def _tiny_arrays(seed=5):
    rng = np.random.default_rng(seed)
    return {"enc": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                    "bias": rng.standard_normal(4).astype(np.float32)},
            "head": {"kernel": rng.standard_normal((4, 2)).astype(np.float32),
                     "bias": rng.standard_normal(2).astype(np.float32)}}


class _Tiny(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for mod, leaves in arrays.items():
            setattr(self, mod, nn.ParameterDict(
                {k: nn.Parameter(torch.from_numpy(v.copy()))
                 for k, v in leaves.items()}))


OPTIMIZERS = {
    "adam": dict(),
    "adamw": dict(weight_decay=1e-2),
    "adamw_by_name": dict(optimizer="adamw"),
    "sgd": dict(optimizer="sgd"),
    "adam_accum2": dict(grad_accum_steps=2),
    "adamw_accum2": dict(weight_decay=1e-2, grad_accum_steps=2),
    "sgd_accum3": dict(optimizer="sgd", grad_accum_steps=3),
}


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "freeze"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name, freeze):
    """Five steps of identical gradients through the port's optimizer and
    the optax chain of JAX ``make_optimizer`` (``freeze_except(["head"])``
    when ``freeze``; the learning rate set to 3e-4 after step 2 with each
    package's ``set_learning_rate`` on the unfrozen chains): parameters
    within 1e-6 (they are O(1)), frozen ones bitwise unchanged."""
    arrays = _tiny_arrays()
    kw = OPTIMIZERS[name]
    tx_j = jt.state.make_optimizer(1e-2, **kw)
    tx_t = tt.make_optimizer(1e-2, **kw)
    if freeze:
        tx_j = jt.freeze_except(tx_j, arrays, ["head"])
        tx_t = tt.freeze_except(tx_t, ["head"])
    js = flax_train_state.TrainState.create(
        apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, arrays),
        tx=tx_j)
    apply_j = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    model = _Tiny(arrays)
    ts = tt.create_train_state(model, tx_t)
    rng = np.random.default_rng(6)
    for step in range(5):
        if step == 2 and not freeze:
            js = jt.state.set_learning_rate(js, 3e-4)
            tt.set_learning_rate(ts, 3e-4)
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), arrays)
        js = apply_j(js, jax.tree_util.tree_map(jnp.asarray, g))
        tt.apply_gradients(ts, [torch.from_numpy(g[n.split(".")[0]][
            n.split(".")[1]]) for n, _ in model.named_parameters()])
        for n, p in model.named_parameters():
            mod, leaf = n.split(".")
            want = np.asarray(js.params[mod][leaf])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=1e-6, err_msg=f"{n} step {step}")
            if freeze and mod == "enc":
                np.testing.assert_array_equal(p.detach().numpy(),
                                              arrays[mod][leaf])
    assert ts.opt_state["lr"].dtype == torch.float32
    with pytest.raises(ValueError):
        tt.make_optimizer(1e-3, optimizer="lion")


# --- the train step ------------------------------------------------------------
#
# The JAX side runs in float64 (``jax.enable_x64``, the float32 variables
# cast up): on the CPU, XLA's float32 gradients of this network are off by
# up to 5e-2 of a tensor's max |g| (SpectrogramCNN on 64x48, measured
# against the same JAX program in float64, which the port's float64 run
# matches to 3e-6), while the port's float32 gradients are within 3e-5 of
# float64.  So the port's float32 step is held against the float64 JAX step.

def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _jax_loss(mm, v, batch):
    """(loss, BatchNorm updates), grads of the JAX step's loss, float64."""
    def compute(params):
        out, upd = mm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(batch["eeg"]),
                            jnp.asarray(batch["spec"]), True,
                            mutable=["batch_stats"])
        return (jt.kldiv_with_logits(out, jnp.asarray(batch["y"]))
                + jt.l2_regularization(params, L2)), upd
    with fnn.intercept_methods(_no_dropout):
        return jax.jit(jax.value_and_grad(compute, has_aux=True))(
            v["params"])


@pytest.fixture(scope="module")
def jax_grads(pair):
    """((loss, BatchNorm updates), grads) of the JAX step's loss at the
    pair's variables, float64."""
    mm, v, batch = pair
    with jax.enable_x64(True):
        return _jax_loss(mm, _f64(v), _f64(batch))


def test_train_step_loss_and_grads_match_jax(pair, jax_grads):
    """One step's loss (KLDiv + L2) within 1e-6 relative of
    ``jax.value_and_grad`` of the JAX step's loss (float64); each gradient
    within 1e-4 of its tensor's max |g| plus 1e-6 of the largest |g| of
    the model.  The absolute part covers the gradients that are zero in
    exact arithmetic and so float32 rounding noise in the port: BatchNorm
    1's affine (BatchNorm 2 normalises it away in training mode) and the
    attention key's bias (softmax is shift-invariant).  The BatchNorm
    running statistics the forward folds in within 1e-5 of each tensor's
    max."""
    mm, v, batch = pair
    (loss_j, upd), grads_j = jax_grads
    m = _port_model(v)
    loss, _, grads = tsteps.loss_and_grads(m, _tb(batch), None,
                                           l2_lambda=L2)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-6)
    want = tm.jax_variables_to_state_dict({"params": grads_j,
                                           "batch_stats": v["batch_stats"]})
    scale = max(float(want[n].abs().max()) for n, _ in m.named_parameters())
    for (n, _), g in zip(m.named_parameters(), grads):
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * float(want[n].abs().max()) + 1e-6 * scale, n
    new = tm.jax_variables_to_state_dict({"params": v["params"], **upd})
    sd = m.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            assert float((sd[k] - new[k]).abs().max()) <= \
                1e-5 * float(new[k].abs().max()), k


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_trajectory_matches_jax(pair, jax_grads, opt):
    """Three ``make_train_step`` steps (L2 1e-3, sentinel on, lr 1e-3) on
    one batch, the JAX step in float64.

    SGD: losses within 1e-5 relative (measured ≤ 2.2e-6); BatchNorm
    statistics within 1e-4 of each tensor's max (measured 3.6e-5 at step
    3); each parameter within 1e-1 of the largest distance its tensor
    moved plus 3e-7 (two float32 units of an O(1) value).  Measured: 0 /
    9.6e-3 / 5.6e-2 of the distance at steps 1-3: the first update is the
    gradient test's, and later gradients, taken where the two runs'
    parameters already differ by rounding, are more sensitive to it.

    Adam: the first step moves a parameter by −lr·g/(|g| + ε), ≈ ±lr
    wherever |g| ≫ ε, so a gradient that is zero in exact arithmetic (the
    ones named in the gradient test, |g| ≲ 1e-8 in float32) takes a random
    sign in the port and the parameter then differs by up to 2·lr; such
    flips of parameters that do reach the loss moved the third loss by
    1.1e-5 relative.  Held: losses within 1e-5 relative at steps 1-2 and
    1e-4 at step 3; after step 1 the parameters whose
    gradient exceeds 1e-4 (10⁴·ε) within 1e-4·lr + 2e-7 of JAX, and every
    parameter within 2·lr per step; BatchNorm statistics are not held
    (BatchNorm 2's running mean takes up BatchNorm 1's shifted bias)."""
    mm, v, batch = pair
    m = _port_model(v)
    ts = tt.create_train_state(m, tt.make_optimizer(LR, optimizer=opt))
    tstep = tt.make_train_step(l2_lambda=L2)
    p0 = copy.deepcopy(m.state_dict())
    with jax.enable_x64(True):
        v64, b64 = _f64(v), _f64(batch)
        js = jt.TrainState.create(
            apply_fn=mm.apply, params=v64["params"],
            tx=jt.state.make_optimizer(LR, optimizer=opt),
            batch_stats=v64["batch_stats"])
        jstep = jt.make_train_step(l2_lambda=L2)
        g0 = tm.jax_variables_to_state_dict(
            {"params": jax_grads[1], "batch_stats": v["batch_stats"]})
        with fnn.intercept_methods(_no_dropout):
            for i in range(3):
                js, mj = jstep(js, b64, jax.random.PRNGKey(0))
                ts, mt = tstep(ts, _tb(batch))
                want = tm.jax_variables_to_state_dict(
                    {"params": js.params, "batch_stats": js.batch_stats})
                sd = m.state_dict()
                rel = 1e-4 if (opt == "adam" and i == 2) else 1e-5
                assert float(mt["loss"]) == pytest.approx(float(mj["loss"]),
                                                          rel=rel), i
                assert not bool(mt["nonfinite"])
                for k, w in want.items():
                    err = float((sd[k] - w).abs().max())
                    is_stat = k.endswith(("running_mean", "running_var"))
                    if opt == "sgd" and is_stat:
                        assert err <= 1e-4 * float(w.abs().max()), (k, i)
                    elif opt == "sgd":
                        moved = float((w - p0[k]).abs().max())
                        assert err <= 1e-1 * moved + 3e-7, (k, i)
                    elif not is_stat:
                        assert err <= 2 * LR * (i + 1) + 1e-6, (k, i)
                        big = g0[k].abs() > 1e-4
                        if i == 0 and bool(big.any()):
                            d = (sd[k] - w).abs()[big]
                            assert float(d.max()) <= 1e-4 * LR + 2e-7, k
    assert ts.step == 3


def _sentinel_setup(v, ema=False):
    m = _port_model(v, dropout=True)
    ts = tt.create_train_state(m, tt.make_optimizer(LR), seed=3,
                               with_ema=ema)
    return m, ts


def _snapshot(ts):
    return (copy.deepcopy(ts.model.state_dict()),
            {k: t.clone() for k, t in ts.opt_state.items()},
            None if ts.ema is None else ts.ema.clone())


def _assert_same(a, b):
    for (ka, va), (kb, vb) in zip(a[0].items(), b[0].items()):
        assert ka == kb and torch.equal(va, vb), ka
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    if a[2] is not None:
        assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("where", ["input", "target"])
def test_nan_sentinel_keeps_state_bitwise(pair, where):
    """A non-finite batch (NaN input, or a NaN target: finite activations,
    non-finite loss) after one good step: ``nonfinite`` is set, the
    parameters, the optimizer state, the BatchNorm running statistics and
    the EMA stay bitwise as they were, the step counter advances; a good
    batch afterwards trains again (the JAX package's
    ``test_nan_sentinel_skips_bad_update`` and
    ``test_train_step_nan_sentinel_freezes_ema_and_advances_step``)."""
    _, v, batch = pair
    m, ts = _sentinel_setup(v, ema=True)
    step = tt.make_train_step(l2_lambda=L2, ema_decay=0.9)
    ts, m0 = step(ts, _tb(batch))
    assert not bool(m0["nonfinite"])
    assert not torch.equal(ts.ema, tsteps.flat(list(m.parameters())))
    before = _snapshot(ts)
    bad = {k: x.copy() for k, x in batch.items()}
    if where == "input":
        bad["spec"][1, 0, 3, :5] = np.nan
    else:
        bad["y"][2, 1] = np.nan
    ts, mb = step(ts, _tb(bad))
    assert bool(mb["nonfinite"]) and ts.step == 2
    _assert_same(_snapshot(ts), before)
    ts, mg = step(ts, _tb(batch))
    assert not bool(mg["nonfinite"]) and np.isfinite(float(mg["loss"]))
    assert not torch.equal(ts.ema, before[2])


def test_eval_step_uses_ema(pair):
    """``make_eval_step(use_ema=True)`` evaluates with the EMA weights: at
    decay 0 the EMA equals the parameters after the step."""
    _, v, batch = pair
    m, ts = _sentinel_setup(v, ema=True)
    ts, _ = tt.make_train_step(ema_decay=0.0)(ts, _tb(batch))
    assert torch.equal(ts.ema, tsteps.flat(list(m.parameters())))
    a, la = tt.make_eval_step()(ts, _tb(batch))
    b, lb = tt.make_eval_step(use_ema=True)(ts, _tb(batch))
    # equal weights; the CPU convolutions may round differently on
    # weights that are views into the flat EMA
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=1e-6)
    assert not m.training


# --- dropout, determinism, bf16, init ----------------------------------------

def test_dropout_same_seed_same_trajectory(pair):
    """Dropout on (p = 0.5), masks from the trainer's generator folded with
    the step: the same seed gives a bitwise identical three-step trajectory
    and eval logits (the JAX package's
    ``test_determinism_same_key_same_logits``), another seed another one,
    and torch's global generator is not consumed."""
    _, v, batch = pair

    def run(ts, seed):
        step = tt.make_train_step()
        for _ in range(3):
            ts, _ = step(ts, _tb(batch), torch.Generator().manual_seed(seed))
        return tt.make_eval_step()(ts, _tb(batch))[0]

    states = [_sentinel_setup(v)[1] for _ in range(3)]
    state = torch.get_rng_state()
    a, b, c = run(states[0], 7), run(states[1], 7), run(states[2], 8)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_dropout_mask_and_generator():
    """Training mode keeps ~1 − p of the elements scaled by 1/(1 − p), the
    mask a function of the generator's draws; eval mode and p = 0 pass
    x through."""
    d = tm.Dropout(0.25).train()
    x = torch.ones(200, 100)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    with tm.dropout_generator(d, g1):
        y1 = d(x)
    with tm.dropout_generator(d, g2):
        y2 = d(x)
    assert d.generator is None
    assert torch.equal(y1, y2)
    kept = y1 != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(y1[kept], torch.full_like(y1[kept], 1 / 0.75))
    assert torch.equal(d.eval()(x), x)
    assert isinstance(d, nn.Dropout)


def test_bf16_activations_learn_params_stay_f32():
    """``SpectrogramCNN(dtype=bf16)`` (the bf16 program's branch): 25 Adam
    steps lower the loss on one batch; parameters, BatchNorm statistics
    and optimizer state stay float32 (the JAX package's
    ``test_train_step_bf16_activations_learns``)."""
    rng = np.random.default_rng(9)
    model = tm.SpectrogramCNN(dtype=torch.bfloat16)
    tt.initialize_kaiming_weights(model, torch.Generator().manual_seed(0))
    ts = tt.create_train_state(model, tt.make_optimizer(1e-3))
    batch = {"x": torch.from_numpy(rng.random((8, 3) + HW).astype(
                 np.float32)),
             "y": torch.from_numpy(np.eye(6, dtype=np.float32)[
                 rng.integers(0, 6, 8)])}
    step = tt.make_train_step()
    ts, m0 = step(ts, batch)
    for _ in range(25):
        ts, m = step(ts, batch)
    assert float(m["loss"]) < float(m0["loss"])
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    assert all(t.is_floating_point() is False or t.dtype == torch.float32
               for t in ts.opt_state.values())


def test_initialize_kaiming_weights():
    """He-normal fan-out weights (std √(2/fan_out)), zero biases, BatchNorm
    scale 1 and bias 0; the same generator seed gives the same weights."""
    m = tm.SpectrogramCNN()
    tt.initialize_kaiming_weights(m, torch.Generator().manual_seed(0))
    w = m.block5.conv2.weight                       # (256, 256, 3, 3)
    assert float(w.std()) == pytest.approx((2 / (256 * 9)) ** 0.5, rel=0.02)
    assert float(m.fc.weight.std()) == pytest.approx((2 / 6) ** 0.5, rel=0.3)
    assert torch.equal(m.block1.conv1.bias, torch.zeros(16))
    assert torch.equal(m.block3.bn.weight, torch.ones(64))
    assert torch.equal(m.block3.bn.bias, torch.zeros(64))
    m2 = tm.SpectrogramCNN()
    tt.initialize_kaiming_weights(m2, torch.Generator().manual_seed(0))
    assert torch.equal(m2.block5.conv2.weight, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,out", [((400, 300), (200, 150)),
                                    ((100, 75), (50, 37)),
                                    ((25, 18), (12, 9))])
def test_bilinear_resize_backward_is_the_adjoint(hw, out, dtype):
    """The skip's resize: forward identical to ``F.interpolate`` (bilinear,
    align_corners=False); its gathering backward equal to torch's
    scattering one at the model's downscales (float32 exactly, bf16 within
    one bf16 unit of the largest value)."""
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((2, 3) + hw), dtype=dtype
                        ).requires_grad_()
    g = torch.as_tensor(rng.standard_normal((2, 3) + out), dtype=dtype)
    y0 = F.interpolate(x, size=out, mode="bilinear", align_corners=False)
    y1 = bilinear_resize(x, out)
    assert torch.equal(y0, y1)
    (g0,) = torch.autograd.grad(y0, x, g)
    (g1,) = torch.autograd.grad(y1, x, g)
    if dtype == torch.float32:
        assert torch.equal(g0, g1)
    else:
        assert float((g0.float() - g1.float()).abs().max()) <= \
            2 ** -7 * float(g0.float().abs().max())
