"""Model parity of the PyTorch port against the JAX package's flax models.

Weights come from the reference-layout torch state dicts of
tests/torch_ref.py (non-trivial BatchNorm statistics), are imported into
flax with the JAX package's ``torch_import`` and carried back to the port
with ``jax_variables_to_state_dict``.  Bound: rtol = atol = 2e-4, the JAX
package's own flax-vs-torch logit bound (tests/test_aux_components.py);
it holds both of the port's EEGNet stems (reassociated and canonical)
against flax's reassociated inference stem (flax's two orders agree to
1e-5, tests/test_models.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from torch_ref import (make_torch_eegnet_attention, make_torch_multimodal,
                       make_torch_speccnn)

SAMPLES = 480


def _flax_vars(model, sd, loader, *xs):
    v = model.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in xs])
    v = loader(sd, v)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _port(module, variables):
    module.load_state_dict(tm.jax_variables_to_state_dict(variables))
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fused_inference", [True, False])
def test_eegnet_attention_matches_flax(rng, fused_inference):
    sd, _ = make_torch_eegnet_attention(seed=3, samples=SAMPLES)
    flax_m = jm.EEGNetAttentionRegularized(samples=SAMPLES)
    x = rng.standard_normal((3, 1, 37, SAMPLES)).astype(np.float32)
    v = _flax_vars(flax_m, sd, jm.load_torch_eegnet_attention_state_dict, x)
    port = _port(tm.EEGNetAttentionRegularized(
        samples=SAMPLES, fused_inference=fused_inference), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(flax_m.apply(v, jnp.asarray(x))))


def _stem_pair(seed=3):
    """The port's EEGNet with the reference weights of ``seed`` and
    BatchNorm 1 moved off identity, plus an input (2, 1, 37, SAMPLES)."""
    sd, _ = make_torch_eegnet_attention(seed=seed, samples=SAMPLES)
    m = tm.EEGNetAttentionRegularized(samples=SAMPLES)
    m.load_state_dict(sd)
    x = np.random.default_rng(seed).standard_normal(
        (2, 1, 37, SAMPLES)).astype(np.float32)
    return m.eval(), torch.from_numpy(x)


def test_eegnet_stem_reassociated_matches_canonical():
    """The port's two stem orders agree on the feature map and the
    log-probs (flax's own two orders: 1e-5, tests/test_models.py)."""
    m, x = _stem_pair()
    with torch.no_grad():
        feats, logp = m.features(x), m(x)
        m.fused_inference = False
        np.testing.assert_allclose(feats.numpy(), m.features(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(logp.numpy(), m(x).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_eegnet_training_keeps_canonical_stem():
    """In training mode the stem runs in canonical order: the reassociated
    path (which folds BatchNorm 1's running statistics) is never entered,
    and the training forward with ``fused_inference`` on is bit-equal to
    the one with it off.  A training forward updates the running
    statistics, so each forward starts from a copy of the same state; eval
    mode enters the reassociated path and still gives the eval output of
    that state."""
    m, x = _stem_pair()
    m.dropout.p = 0.0
    saved = copy.deepcopy(m.state_dict())
    calls = []
    reassociated = m._stem_reassociated
    m._stem_reassociated = lambda t: calls.append(1) or reassociated(t)
    with torch.no_grad():
        before = m.eval()(x)
        assert calls
        calls.clear()
        train_out = m.train()(x)
        assert not calls
        assert not torch.equal(m.batchnorm1.running_mean,
                               saved["batchnorm1.running_mean"])
        m.load_state_dict(saved)
        m.fused_inference = False
        assert torch.equal(train_out, m(x))
        m.load_state_dict(saved)
        m.fused_inference = True
        assert torch.equal(m.eval()(x), before)
        assert calls


def _flax_bn_step(bn, v, x):
    """One flax training step of ``bn``: (output, updated variables)."""
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    return np.asarray(y), {"params": v["params"], **upd}


@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (5, 6, 9)])
def test_batchnorm_training_matches_flax(shape):
    """The port's BatchNorm in training mode against flax's
    ``BatchNorm(use_running_average=False, momentum=0.9)`` over two steps:
    outputs and both running statistics at 1e-5.  Features on dim 1 in
    the port, last in flax; the batch's mean is far from 0, so an
    unbiased variance or torch's momentum would show."""
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    c = shape[1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.standard_normal(c).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    port = tm.BatchNorm(c)
    port.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    port.train()
    for step in range(2):
        x = (rng.standard_normal(shape) * 2 + 3 + step).astype(np.float32)
        want, v = _flax_bn_step(bn, v, np.moveaxis(x, 1, -1))
        got = port(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), rtol=1e-5,
                                   atol=1e-5)
        for buf, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(port, buf).numpy(),
                                       np.asarray(v["batch_stats"][key]),
                                       rtol=1e-5, atol=1e-5)


def _no_dropout(next_fun, args, kwargs, context):
    """flax method interceptor: every ``nn.Dropout`` returns its input
    (the JAX ``SpectrogramBlock`` has no dropout knob on ``SpectrogramCNN``)."""
    import flax.linen as fnn
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _train_step_matches_flax(port, flax_m, v, *xs):
    """``port`` in training mode against ``flax_m.apply(train=True,
    mutable=["batch_stats"])`` (dropout off on both sides): log-probs at
    rtol = atol = 1e-5, and each updated running statistic within 1e-5 of
    its largest |value|.  The statistics are held at tensor scale because
    flax's variance E[x²] − E[x]² cancels where mean² ≫ var: on block 5's
    four values a channel mean²/var reaches ~500 here, which lifts the two
    frameworks' f32 conv rounding (~1e-7) to ~4e-5 of a small variance."""
    import flax.linen as fnn
    with fnn.intercept_methods(_no_dropout):
        want, upd = flax_m.apply(v, *[jnp.asarray(x) for x in xs],
                                 train=True, mutable=["batch_stats"])
    port.train()
    got = port(*[torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    new = tm.jax_variables_to_state_dict({"params": v["params"], **upd})
    old = tm.jax_variables_to_state_dict(v)
    stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert stats
    sd = port.state_dict()
    for k in stats:
        assert not torch.equal(new[k], old[k]), k
        err = (sd[k] - new[k]).abs().max() / new[k].abs().max()
        assert float(err) <= 1e-5, (k, float(err))


def test_eegnet_attention_training_matches_flax(rng):
    sd, _ = make_torch_eegnet_attention(seed=3, samples=SAMPLES)
    flax_m = jm.EEGNetAttentionRegularized(samples=SAMPLES, dropout_rate=0.0)
    x = rng.standard_normal((3, 1, 37, SAMPLES)).astype(np.float32)
    v = _flax_vars(flax_m, sd, jm.load_torch_eegnet_attention_state_dict, x)
    port = _port(tm.EEGNetAttentionRegularized(samples=SAMPLES), v)
    port.dropout.p = 0.0
    _train_step_matches_flax(port, flax_m, v, x)


def test_speccnn_training_matches_flax(rng):
    sd, _ = make_torch_speccnn(seed=4)
    x = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    flax_m = jm.SpectrogramCNN(fused_blocks=2)
    v = _flax_vars(jm.SpectrogramCNN(), sd, jm.load_torch_speccnn_state_dict,
                   x)
    port = _port(tm.SpectrogramCNN(fused_blocks=2), v)
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    _train_step_matches_flax(port, flax_m, v, x)


@pytest.mark.parametrize("fused_blocks", [0, 2, 3, 4, 5])
def test_speccnn_matches_flax(rng, fused_blocks):
    sd, _ = make_torch_speccnn(seed=4)
    x = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    v = _flax_vars(jm.SpectrogramCNN(), sd, jm.load_torch_speccnn_state_dict,
                   x)
    flax_m = jm.SpectrogramCNN(fused_blocks=fused_blocks, fused_interpret=True)
    port = _port(tm.SpectrogramCNN(fused_blocks=fused_blocks), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(flax_m.apply(v, jnp.asarray(x))))


def test_multimodal_matches_flax(rng):
    sd, _ = make_torch_multimodal(seed=5, samples=SAMPLES)
    eeg = rng.standard_normal((2, 1, 37, SAMPLES)).astype(np.float32)
    spec = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    flax_m = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES),
        spectrogram_model=jm.SpectrogramCNN())
    v = _flax_vars(flax_m, sd, jm.load_torch_multimodal_state_dict, eeg, spec)
    port = _port(tm.MultimodalModel(
        tm.EEGNetAttentionRegularized(samples=SAMPLES),
        tm.SpectrogramCNN(fused_blocks=2)), v)
    with torch.no_grad():
        got = port(torch.from_numpy(eeg), torch.from_numpy(spec)).numpy()
    _close(got, np.asarray(flax_m.apply(v, jnp.asarray(eeg),
                                        jnp.asarray(spec))))


def _cases():
    return {
        "eegnet_attention": (
            lambda: make_torch_eegnet_attention(seed=1, samples=SAMPLES),
            lambda: tm.EEGNetAttentionRegularized(samples=SAMPLES),
            lambda: (np.random.default_rng(0).standard_normal(
                (2, 1, 37, SAMPLES)).astype(np.float32),)),
        "speccnn": (
            lambda: make_torch_speccnn(seed=2),
            lambda: tm.SpectrogramCNN(),
            lambda: (np.random.default_rng(0).standard_normal(
                (2, 3, 64, 48)).astype(np.float32),)),
        "multimodal": (
            lambda: make_torch_multimodal(seed=3, samples=SAMPLES),
            lambda: tm.MultimodalModel(
                tm.EEGNetAttentionRegularized(samples=SAMPLES),
                tm.SpectrogramCNN(fused_blocks=2)),
            lambda: (np.random.default_rng(0).standard_normal(
                (2, 1, 37, SAMPLES)).astype(np.float32),
                np.random.default_rng(1).standard_normal(
                (2, 3, 64, 48)).astype(np.float32))),
    }


@pytest.mark.parametrize("name", ["eegnet_attention", "speccnn", "multimodal"])
def test_state_dict_keys_equal_reference(name):
    make_ref, make_port, _ = _cases()[name]
    sd, _ = make_ref()
    assert sorted(make_port().state_dict()) == sorted(sd)


@pytest.mark.parametrize("name", ["eegnet_attention", "speccnn", "multimodal"])
def test_reference_state_dict_reproduces_reference_forward(name):
    make_ref, make_port, make_x = _cases()[name]
    sd, ref_forward = make_ref()
    port = make_port()
    port.load_state_dict(sd)
    port.eval()
    xs = [torch.from_numpy(x) for x in make_x()]
    with torch.no_grad():
        _close(port(*xs).numpy(), ref_forward(*xs).numpy())


def test_jax_variables_round_trip_reference_state_dict(rng):
    """Reference state dict → flax (``torch_import``) → port state dict
    gives back the reference tensors exactly."""
    sd, _ = make_torch_multimodal(seed=6, samples=SAMPLES)
    eeg = rng.standard_normal((1, 1, 37, SAMPLES)).astype(np.float32)
    spec = rng.standard_normal((1, 3, 64, 48)).astype(np.float32)
    flax_m = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES),
        spectrogram_model=jm.SpectrogramCNN())
    v = _flax_vars(flax_m, sd, jm.load_torch_multimodal_state_dict, eeg, spec)
    back = tm.jax_variables_to_state_dict(v)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), k)
