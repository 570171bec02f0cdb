"""The port's bf16 serving program against the JAX package's bf16 modes,
on the CPU (the fused block's plain version; Pallas in interpret mode on
the JAX side).

Bounds are the JAX package's own bf16-versus-f32 bounds, since two bf16
programs that round in different places cannot agree more tightly than
either agrees with float32: 2e-2 absolute on the min-maxed spectrogram
chain (tests/test_ops_preprocess.py:81-91); max 0.25, rms 0.035 and
correlation > 0.999 on the z-scored EEG chain (:251-273); 2e-2 on the
spectrogram CNN's and the whole forward's probabilities
(tests/test_models.py:176-186).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
    build_model, make_forward)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    preprocess as tpre)
from test_torch_slice import KERN, SAMPLES, _perturbed_variables
from torch_ref import make_torch_speccnn

BF16 = torch.bfloat16
PROB_ATOL = 2e-2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_spectrogram_preprocess_bf16(rng):
    spec = (rng.standard_normal((2, 400, 300)) * 5).astype(np.float32)
    spec[1, 10, 20:30] = np.nan
    got = tpre.hms_spectrogram_preprocess(torch.from_numpy(spec),
                                          serving_dtype=BF16)
    assert got.dtype == BF16 and got.shape == (2, 3, 400, 300)
    want = np.asarray(jops.hms_spectrogram_preprocess(
        spec, serving_dtype=jnp.bfloat16)).astype(np.float32)
    f32 = _np(tpre.hms_spectrogram_preprocess(torch.from_numpy(spec)))
    assert np.max(np.abs(_np(got) - want)) < 2e-2
    assert np.max(np.abs(_np(got) - f32)) < 2e-2


def _eeg_close(got: np.ndarray, want: np.ndarray) -> None:
    err = got - want
    assert np.abs(err).max() < 0.25, np.abs(err).max()
    assert np.sqrt((err ** 2).mean()) < 0.035
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_eeg_preprocess_bf16(rng):
    x = (rng.standard_normal((3, 20, 2000)) * 40).astype(np.float32)
    jsig = JC.SignalConfig(fixed_length=500)
    tsig = TC.SignalConfig(fixed_length=500)
    got = tpre.hms_eeg_preprocess(torch.from_numpy(x), signal=tsig,
                                  assume_finite=True, serving_dtype=BF16)
    assert got.dtype == torch.float32 and got.shape == (3, 1, 37, 500)
    jax_bf16 = np.asarray(jops.hms_eeg_preprocess(
        jnp.asarray(x), signal=jsig, assume_finite=True,
        serving_dtype=jnp.bfloat16))
    f32 = tpre.hms_eeg_preprocess(torch.from_numpy(x), signal=tsig,
                                  assume_finite=True)
    _eeg_close(got.numpy(), jax_bf16)
    _eeg_close(got.numpy(), f32.numpy())
    # the input is rounded to bf16: not the float32 chain
    assert not torch.equal(got, f32)


def test_eeg_preprocess_bf16_nan_route_raises(rng):
    """``serving_dtype=bf16`` on the NaN route (``assume_finite=False``):
    the JAX chain ignores ``serving_dtype`` off the finite route, and so
    does the port, which returns the float32 NaN route's output (bit for
    bit the ``serving_dtype=None`` output), within the float32 chains'
    5e-3 z-scored bound (tests/test_torch_preprocess.py) of JAX's."""
    x = (rng.standard_normal((1, 20, 400)) * 40).astype(np.float32)
    x[0, 3, 100:150] = np.nan
    got = tpre.hms_eeg_preprocess(torch.from_numpy(x), assume_finite=False,
                                  serving_dtype=BF16)
    assert got.dtype == torch.float32
    assert torch.equal(got, tpre.hms_eeg_preprocess(torch.from_numpy(x),
                                                    assume_finite=False))
    want = np.asarray(jops.hms_eeg_preprocess(
        x, assume_finite=False, serving_dtype=jnp.bfloat16))
    assert got.shape == want.shape == (1, 1, 37, 3000)
    assert np.max(np.abs(got.numpy() - want)) < 5e-3


@pytest.mark.parametrize("fused_blocks", [0, 2])
def test_speccnn_bf16_matches_flax(rng, fused_blocks):
    sd, _ = make_torch_speccnn(seed=4)
    x = rng.standard_normal((2, 3, 64, 48)).astype(np.float32)
    v = jm.SpectrogramCNN().init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jm.load_torch_speccnn_state_dict(sd, v)
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    want = np.exp(np.asarray(jm.SpectrogramCNN(dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x))))
    port = tm.SpectrogramCNN(fused_blocks=fused_blocks, dtype=BF16)
    port.load_state_dict(tm.jax_variables_to_state_dict(v))
    port.eval()
    f32 = tm.SpectrogramCNN(fused_blocks=fused_blocks)
    f32.load_state_dict(port.state_dict())
    f32.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        p32 = f32(torch.from_numpy(x)).exp()
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.state_dict().values())
    np.testing.assert_allclose(got.exp().numpy(), want, rtol=0,
                               atol=PROB_ATOL)
    np.testing.assert_allclose(got.exp().numpy(), p32.numpy(), rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("assume_finite", [True, False])
def test_bf16_forward_matches_jax_multimodal_bench(assume_finite):
    """``make_forward(serving_dtype=bf16)`` against the JAX bench's
    ``--multimodal`` program (bench.py:238-265 with BENCH_EEG_BF16=1 and
    BENCH_FUSED_SPEC=2): the bf16 spectrogram chain and CNN, the EEG finite
    route on bf16 input (the NaN route stays float32 in both)."""
    rng = np.random.default_rng(0)
    raw_eeg = (rng.standard_normal((2, 20, 2000)) * 40).astype(np.float32)
    raw_spec = (rng.standard_normal((2, 64, 48)) * 5).astype(np.float32)
    if not assume_finite:
        raw_eeg[1, 7, 500:650] = np.nan
    jsig = JC.SignalConfig(fixed_length=SAMPLES, image_size=(64, 48))
    eeg_in = jops.hms_eeg_preprocess(
        raw_eeg, signal=jsig, assume_finite=assume_finite,
        serving_dtype=jnp.bfloat16 if assume_finite else None)
    spec_in = jops.hms_spectrogram_preprocess(raw_spec, signal=jsig,
                                              serving_dtype=jnp.bfloat16)
    mm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES,
                                                kern_length=KERN),
        spectrogram_model=jm.SpectrogramCNN(dtype=jnp.bfloat16,
                                            fused_blocks=2,
                                            fused_interpret=True))
    v = _perturbed_variables(mm.init(jax.random.PRNGKey(0), eeg_in, spec_in),
                             1)
    want = np.exp(np.asarray(mm.apply(v, eeg_in, spec_in)))

    model = build_model(samples=SAMPLES, kern_length=KERN, dtype=BF16)
    model.load_state_dict(tm.jax_variables_to_state_dict(v))
    forward = make_forward(
        model, signal=TC.SignalConfig(fixed_length=SAMPLES,
                                      image_size=(64, 48)),
        assume_finite=assume_finite, serving_dtype=BF16)
    got = forward(torch.from_numpy(raw_eeg), torch.from_numpy(raw_spec))
    assert got.shape == (2, 6) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.exp().numpy(), want, rtol=0,
                               atol=PROB_ATOL)


def test_make_forward_refuses_mismatched_dtype():
    with pytest.raises(ValueError, match="serving_dtype"):
        make_forward(build_model(samples=SAMPLES, kern_length=KERN),
                     serving_dtype=BF16)
