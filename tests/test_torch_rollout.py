"""The port's attention rollout and SHAP channel selection against the JAX
package's ``xai/rollout.py`` and ``xai/channel_select.py``.

Rollout: ``attention_rollout`` on the same weights, and
``rollout_from_model`` on the same models (bound 1e-5).  At depth ≤ 10 the
port agrees with JAX's ``rollout_from_model`` itself; at depth 12 JAX's
``collect_attention_weights`` orders the layers by their paths as strings
(``encoder_layer_0, 1, 10, 11, 2, …``), so there the port is held against
JAX's ``attention_rollout`` of the JAX weights taken in layer order, and
JAX's own result is shown to differ from it.

Channel selection: the numpy parts exactly; ``retrain_on_top_channels``
from the JAX run's initial weights (dropout off) against the JAX run's
report at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu.xai import (
    channel_select as jcs, rollout as jr)
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
    channel_select as tcs, rollout as tr)
from test_torch_zoo import _variables

VIT = dict(image_size=(64, 48), dim=32, n_heads=4, mlp_dim=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_attention_rollout_matches_jax():
    """Three layers, with and without a head axis, two residual weights."""
    rng = np.random.default_rng(0)
    ws = [rng.random((2, 3, 7, 7)).astype(np.float32),
          rng.random((2, 7, 7)).astype(np.float32),
          rng.random((2, 3, 7, 7)).astype(np.float32)]
    ws = [w / w.sum(-1, keepdims=True) for w in ws]
    for alpha in (0.5, 0.8):
        _close(tr.attention_rollout([torch.from_numpy(w) for w in ws], alpha),
               jr.attention_rollout([jnp.asarray(w) for w in ws], alpha))


def _pair(name, seed, **kw):
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, 64, 48) if name == "spectrogram_vit" else (2, 1, 37, 384)
    ).astype(np.float32)
    jmodel = jm.build(name, **kw)
    v = _variables(jmodel, x, seed)
    port = tm.build(name, **kw)
    port.load_state_dict(tm.jax_variables_to_state_dict(v, arch=name))
    return jmodel, v, port.eval(), x


@pytest.mark.parametrize("depth", [2, 12])
def test_vit_rollout_in_layer_order(depth):
    jmodel, v, port, x = _pair("spectrogram_vit", depth, depth=depth, **VIT)
    got = tr.rollout_from_model(port, torch.from_numpy(x))
    _, inter = jax.jit(lambda v, x: jmodel.apply(
        v, x, mutable=["intermediates"]))(v, jnp.asarray(x))
    inter = inter["intermediates"]
    in_order = [inter[f"encoder_layer_{i}"]["self_attention"]
                ["attention_weights"][0] for i in range(depth)]
    assert len(tr.collect_attention_weights(port, torch.from_numpy(x))) \
        == depth
    _close(got, jr.attention_rollout(in_order))
    jax_own = np.asarray(jr.attention_rollout(
        jr.collect_attention_weights(inter)))
    if depth <= 10:
        _close(got, jax_own)
    else:
        assert np.abs(got.numpy() - jax_own).max() > 1e-4


@pytest.mark.parametrize("name,kw", [
    ("eegnet_attention_regularized", dict(samples=384)),
    ("eegnet_transformer", dict(samples=384, num_layers=2))])
def test_eeg_rollout_matches_jax(name, kw):
    """The single-head ``Attention`` of the EEGNet attention variant (12
    time tokens) and the transformer's layers (one token a sample)."""
    jmodel, v, port, x = _pair(name, 4, **kw)
    got = tr.rollout_from_model(port, torch.from_numpy(x))
    want = jr.rollout_from_model(jmodel, v, jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want)


def test_rollout_without_attention_raises():
    with pytest.raises(ValueError):
        tr.rollout_from_model(tm.EEGNet(samples=384),
                              torch.zeros(1, 1, 37, 384))


def test_channel_select_numpy_parts_exact():
    rng = np.random.default_rng(1)
    sv = rng.standard_normal((6, 4, 1, 37, 32)).astype(np.float32)
    x = rng.standard_normal((4, 1, 37, 32)).astype(np.float32)
    y = rng.random((4, 6)).astype(np.float32)
    assert np.array_equal(tcs.mean_abs_attribution_per_channel(sv[2]),
                          jcs.mean_abs_attribution_per_channel(sv[2]))
    for n in (1, 5, 37):
        for a, b in zip(tcs.get_top_n_channels(sv[0], n),
                        jcs.get_top_n_channels(sv[0], n)):
            assert np.array_equal(a, b)
    assert tcs.channel_names_37() == jcs.channel_names_37()
    idx = [5, 0, 36]
    for pc in (None, 0, 3):
        for a, b in zip(tcs.restructure_to_top_channels(x, y, idx, pc),
                        jcs.restructure_to_top_channels(x, y, idx, pc)):
            assert np.array_equal(a, b)


def test_retrain_on_top_channels_matches_jax(monkeypatch, tmp_path):
    """Both retrain a binary EEGNet on the top 5 channels from the same
    initial weights (the JAX run's, recorded at its ``create_train_state``
    and loaded by the port where it would draw Kaiming weights), dropout
    off, the same batches: the reports agree at 1e-4.  The learning rate is
    1e-4: BatchNorm 1's bias has a zero gradient in exact arithmetic (BN 2
    removes any shift of it), so Adam moves it by ±lr on the sign of
    rounding noise, which differs between the two programs; at the default
    1e-3 that alone moves the retrained kldiv by ~1e-3 (a 1e-7 relative
    change of the input does as much to the port alone)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 1, 37, 128)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 12)]
    y[:, 0] += (np.arange(12) % 2) * 2
    sv = rng.standard_normal((6, 12, 1, 37, 128)).astype(np.float32)
    kw = dict(model_kwargs={"dropout_rate": 0.0, "kern_length": 16},
              n_channels=5, positive_class=0, epochs=2, batch_size=4,
              lr=1e-4, seed=3)
    made = []
    real = jt.create_train_state

    def record(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    monkeypatch.setattr(jt, "create_train_state", record)
    want = jcs.retrain_on_top_channels(x, y, sv, **kw)
    init = tm.jax_variables_to_state_dict(
        {"params": made[0].params, "batch_stats": made[0].batch_stats},
        arch="eegnet_attention_regularized")
    monkeypatch.setattr(tt, "initialize_kaiming_weights",
                        lambda model, gen: model.load_state_dict(init))
    got = tcs.retrain_on_top_channels(x, y, sv, device="cpu",
                                      ckpt_dir=str(tmp_path), **kw)
    assert got["top_channels"] == want["top_channels"]
    assert got["positive_class"] == want["positive_class"]
    for part in ("fresh", "retrained"):
        assert list(got[part]) == list(want[part])
        for k in got[part]:
            assert got[part][k] == pytest.approx(want[part][k], rel=1e-4,
                                                 abs=1e-4), (part, k)
    assert got["best_kldiv"] == pytest.approx(want["best_kldiv"], rel=1e-4)
    assert want["fresh"]["kldiv"] - want["retrained"]["kldiv"] > 1e-2
