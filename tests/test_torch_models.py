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
    """In training mode the stem runs in canonical order: with dropout off
    (BatchNorm always reads its running statistics here) the training
    forward is bit-equal to the canonical eval forward, and the
    reassociated path is never entered."""
    m, x = _stem_pair()
    m.dropout.p = 0.0
    calls = []
    reassociated = m._stem_reassociated
    m._stem_reassociated = lambda t: calls.append(1) or reassociated(t)
    with torch.no_grad():
        train_out = m.train()(x)
        assert not calls
        m.eval()(x)
        assert calls
        m.fused_inference = False
        assert torch.equal(train_out, m(x))


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
