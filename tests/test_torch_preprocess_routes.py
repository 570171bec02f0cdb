"""The spectrogram chain's other routes (anti-aliased resample, op-by-op
``linear_ops=False``), ``eeg_transform``, ``mirror_eeg`` and the
reduced-resolution serving preset, in the PyTorch port (CPU: the plain
PyTorch versions) against the JAX package on the same seeded inputs.

Bounds are the JAX package's own: rtol = atol = 2e-5 for the resize
(tests/test_ops_preprocess.py:171-201); 1e-5 absolute on the min-maxed
[0, 1] spectrogram chain in float32 (:94-103) and 2e-2 in bf16 (:81-91);
rel 1e-4 for ``eeg_transform`` (:106-116); 1e-3 on log-probs for the whole
float32 forward (tests/test_torch_slice.py) and 2e-2 on the bf16 program's
probabilities (tests/test_models.py:176-186).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from multimodal_brain_pattern_identification_xai_tpu import config as JC
from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import ops as jops
from multimodal_brain_pattern_identification_xai_tpu.ops import (
    montage as jmontage, normalize as jnorm, resample as jresample,
    smooth as jsmooth)
from multimodal_brain_pattern_identification_xai_tpu_torch import config as TC
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import ops as tops
from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
    build_model, make_forward)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    montage as tmontage, normalize as tnorm, resample as tresample,
    smooth as tsmooth)
from test_ops_preprocess import _golden_skimage_resize
from test_torch_slice import ATOL, KERN, SAMPLES, _perturbed_variables

BF16 = torch.bfloat16
PROB_ATOL = 2e-2

RESIZE_CASES = [
    ((400, 300), (100, 75)),     # pure downscale (anti-alias active)
    ((50, 40), (80, 64)),        # pure upscale (no prefilter)
    ((100, 80), (50, 160)),      # mixed down/up
    ((7, 300), (13, 300)),       # odd sizes, one axis identity
    ((400, 300), (200, 150)),    # the reduced-resolution preset
]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("shape,target", RESIZE_CASES)
def test_resize_antialiased_matches_jax(rng, shape, target):
    x = rng.standard_normal(shape).astype(np.float32) * 10
    got = _np(tresample.resize_antialiased(torch.from_numpy(x), target))
    want = np.asarray(jresample.resize_antialiased(jnp.asarray(x), target))
    assert got.shape == tuple(target)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _golden_skimage_resize(x, target),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,target", RESIZE_CASES)
def test_resize_matrix_1d_equals_jax(shape, target):
    for n_in, n_out in zip(shape, target):
        np.testing.assert_array_equal(
            tresample._resize_matrix_1d(n_in, n_out),
            jresample._resize_matrix_1d(n_in, n_out))


def test_resize_antialiased_same_shape_is_identity(rng):
    x = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    assert tresample.resize_antialiased(x, (32, 24)) is x


def test_resize_antialiased_batched(rng):
    x = rng.standard_normal((2, 3, 60, 50)).astype(np.float32)
    got = _np(tresample.resize_antialiased(torch.from_numpy(x), (30, 25)))
    want = np.asarray(jresample.resize_antialiased(jnp.asarray(x), (30, 25)))
    assert got.shape == (2, 3, 30, 25)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_gaussian_smooth2d_matches_jax_and_scipy(rng):
    """Edges that differ from their neighbours tell scipy's 'reflect'
    (edge sample repeated) from numpy's 'reflect' (torch's F.pad mode,
    edge not repeated)."""
    x = rng.standard_normal((2, 40, 30)).astype(np.float32)
    x[:, 0, :] += 8.0
    x[:, :, -1] -= 6.0
    got = _np(tsmooth.gaussian_smooth2d(torch.from_numpy(x)))
    want = np.asarray(jsmooth.gaussian_smooth2d(jnp.asarray(x)))
    scipy_ = np.stack([scipy.ndimage.gaussian_filter(p.astype(np.float64),
                                                     sigma=1.0) for p in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, scipy_, rtol=0, atol=1e-5)
    # the plane catches torch's reflect padding (edge not repeated)
    k = torch.from_numpy(tsmooth._gaussian_kernel1d(1.0)).float()
    wrong = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x)[:, None], (4, 4, 4, 4),
                                mode="reflect"),
        (k[:, None] * k[None, :])[None, None])[:, 0]
    assert np.abs(wrong.numpy() - scipy_).max() > 1e-2


def _inf_nan(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, 7] = -np.inf
    return x


@pytest.mark.parametrize("port,ref,prep", [
    pytest.param(lambda x: tnorm.baseline_correction(x, axis=-2),
                 lambda x: jnorm.baseline_correction(x, axis=-2), None,
                 id="baseline_correction"),
    pytest.param(lambda x: tnorm.minmax(x, axis=(-2, -1)),
                 lambda x: jnorm.minmax(x, axis=(-2, -1)), None,
                 id="minmax_planes"),
    pytest.param(tnorm.minmax, jnorm.minmax, None, id="minmax_whole"),
    pytest.param(tnorm.clip_scale, jnorm.clip_scale, _inf_nan,
                 id="clip_scale_nan_inf"),
    pytest.param(lambda x: tnorm.mu_law_encode(x, 1.0),
                 lambda x: jnorm.mu_law_encode(x, 1.0), None,
                 id="mu_law_encode"),
])
def test_normalize_matches_jax(rng, port, ref, prep):
    """Within 1e-6 of the reference's largest |value| (float32 means and
    reductions summed in other orders)."""
    x = (rng.standard_normal((4, 64, 48)) * 2000).astype(np.float32)
    if prep is not None:
        x = prep(x)
    got = _np(port(torch.from_numpy(x)))
    want = np.asarray(ref(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("stride,axis,drop_last",
                         [(5, -2, False), (4, -1, True), (3, 0, False)])
def test_decimate_matches_jax(rng, stride, axis, drop_last):
    x = rng.standard_normal((7, 23, 5)).astype(np.float32)
    got = tresample.decimate(torch.from_numpy(x), stride, axis=axis,
                             drop_last=drop_last)
    want = jresample.decimate(jnp.asarray(x), stride, axis=axis,
                              drop_last=drop_last)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pairs,columns,keep_originals,keep", [
    pytest.param(JC.MAP_FEATURES, JC.EEG_COLUMNS, True, None,
                 id="banana-20"),
    pytest.param(JC.MAP_FEATURES, JC.EEG_COLUMNS, True, JC.EEG_FEATURES,
                 id="banana-keep19"),
    pytest.param(JC.CHRIS_MAGIC_PAIRS, JC.EEG_FEATURES, False, None,
                 id="magic8-19"),
    pytest.param(JC.CHRIS_MAGIC_PAIRS, JC.EEG_COLUMNS, False, None,
                 id="magic8-20"),
])
def test_montage_matrix_equals_jax(pairs, columns, keep_originals, keep):
    np.testing.assert_array_equal(
        tmontage.montage_matrix(pairs, columns, keep_originals, keep),
        jmontage.montage_matrix(pairs, columns, keep_originals, keep))


def _spec_with_nans(rng, shape=(2, 64, 48)):
    spec = (rng.standard_normal(shape) * 5).astype(np.float32)
    spec[0, 9, 13] = np.nan                      # lone pixel
    spec[0, 30, 5:11] = np.nan                   # a run
    spec[1, 20, :] = np.nan                      # an all-NaN row
    return spec


@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("linear_ops", [True, False],
                         ids=["dense", "op_by_op"])
@pytest.mark.parametrize("mode", ["pad", "resample"])
def test_spectrogram_routes_match_jax(rng, mode, linear_ops, dtype):
    spec = _spec_with_nans(rng)
    tsig = TC.SignalConfig(image_size=(32, 24), resize_mode=mode)
    jsig = JC.SignalConfig(image_size=(32, 24), resize_mode=mode)
    got = tops.hms_spectrogram_preprocess(
        torch.from_numpy(spec), signal=tsig, serving_dtype=dtype,
        linear_ops=linear_ops)
    want = np.asarray(jops.hms_spectrogram_preprocess(
        spec, signal=jsig, linear_ops=linear_ops,
        serving_dtype=None if dtype is None else jnp.bfloat16)
    ).astype(np.float32)
    assert got.shape == want.shape == (2, 3, 32, 24)
    assert got.dtype == (torch.float32 if dtype is None else dtype)
    assert np.isfinite(_np(got)).all()
    bound = 1e-5 if dtype is None else 2e-2
    assert np.max(np.abs(_np(got) - want)) < bound
    if dtype is not None:
        # bf16 within the JAX bound of the port's own float32 route
        f32 = tops.hms_spectrogram_preprocess(
            torch.from_numpy(spec), signal=tsig, linear_ops=linear_ops)
        assert np.max(np.abs(_np(got) - _np(f32))) < 2e-2
    elif not linear_ops:
        # op by op equals the dense-operator route (JAX's pin, :94-103)
        dense = tops.hms_spectrogram_preprocess(torch.from_numpy(spec),
                                                signal=tsig)
        assert np.max(np.abs(_np(got) - _np(dense))) < 1e-5


def test_resample_route_repairs_nans_first(rng):
    """NaN repair runs before the resize: a lone NaN pixel and an all-NaN
    row stay local, and the result equals the chain on the pre-repaired
    plane."""
    spec = _spec_with_nans(rng, (2, 128, 96))
    sig = TC.SignalConfig(image_size=(64, 48), resize_mode="resample")
    x = torch.from_numpy(spec)
    out = tops.hms_spectrogram_preprocess(x, signal=sig)
    assert bool(torch.isfinite(out).all())
    want = tops.hms_spectrogram_preprocess(tops.nan_to_channel_mean(x),
                                           signal=sig)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


def test_bad_resize_mode_raises(rng):
    spec = torch.from_numpy(rng.standard_normal((1, 40, 30))
                            .astype(np.float32))
    with pytest.raises(ValueError, match="resize_mode"):
        tops.hms_spectrogram_preprocess(
            spec, signal=TC.SignalConfig(image_size=(40, 30),
                                         resize_mode="bogus"))


@pytest.mark.parametrize("magic8,n_cols", [(False, 19), (True, 19),
                                           (True, 20)])
def test_eeg_transform_matches_jax(rng, magic8, n_cols):
    x = (rng.standard_normal((2, 2000, n_cols)) * 300).astype(np.float32)
    x[0, 100:140, 3] = np.nan
    tcfg = TC.EEGTransformConfig(apply_chris_magic_ch8=magic8,
                                 apply_mu_law_encoding=magic8)
    jcfg = JC.EEGTransformConfig(apply_chris_magic_ch8=magic8,
                                 apply_mu_law_encoding=magic8)
    got = _np(tops.eeg_transform(torch.from_numpy(x), tcfg))
    want = np.asarray(jops.eeg_transform(jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (2, 400, 8 if magic8 else n_cols)
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_mirror_eeg_matches_jax(rng):
    x = rng.standard_normal((2, 20, 50)).astype(np.float32)
    got = tops.mirror_eeg(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jops.mirror_eeg(jnp.asarray(x))))
    f2i = TC.feature_to_index()
    np.testing.assert_array_equal(got[:, f2i["Fp1"]], x[:, f2i["Fp2"]])
    np.testing.assert_array_equal(got[:, f2i["Fz"]], x[:, f2i["Fz"]])


@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
def test_preset_forward_matches_jax(dtype):
    """``make_forward(signal=preset)`` — raw 128×96 planes anti-alias-
    resized to 64×48, the CNN's blocks 1-2 through the fused block —
    against the JAX package's preprocess + ``MultimodalModel`` with
    ``SpectrogramCNN(fused_blocks=2, fused_interpret=True)`` (the JAX
    bench's ``BENCH_SPEC_RES`` program; bf16: with ``BENCH_EEG_BF16=1``)."""
    rng = np.random.default_rng(0)
    raw_eeg = (rng.standard_normal((2, 20, 2000)) * 40).astype(np.float32)
    raw_spec = _spec_with_nans(rng, (2, 128, 96))
    jdt = None if dtype is None else jnp.bfloat16
    jsig = JC.SignalConfig(fixed_length=SAMPLES, image_size=(64, 48),
                           resize_mode="resample")
    eeg_in = jops.hms_eeg_preprocess(raw_eeg, signal=jsig, assume_finite=True,
                                     serving_dtype=jdt)
    spec_in = jops.hms_spectrogram_preprocess(raw_spec, signal=jsig,
                                              serving_dtype=jdt)
    mm = jm.MultimodalModel(
        eeg_model=jm.EEGNetAttentionRegularized(samples=SAMPLES,
                                                kern_length=KERN),
        spectrogram_model=jm.SpectrogramCNN(dtype=jdt or jnp.float32,
                                            fused_blocks=2,
                                            fused_interpret=True))
    v = _perturbed_variables(mm.init(jax.random.PRNGKey(0), eeg_in, spec_in),
                             1)
    want = np.asarray(mm.apply(v, eeg_in, spec_in))

    model = build_model(samples=SAMPLES, kern_length=KERN, dtype=dtype)
    model.load_state_dict(tm.jax_variables_to_state_dict(v))
    forward = make_forward(
        model, signal=TC.SignalConfig(fixed_length=SAMPLES,
                                      image_size=(64, 48),
                                      resize_mode="resample"),
        assume_finite=True, serving_dtype=dtype)
    got = forward(torch.from_numpy(raw_eeg), torch.from_numpy(raw_spec))
    assert got.shape == (2, 6) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    if dtype is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(got.exp().numpy(), np.exp(want), rtol=0,
                                   atol=PROB_ATOL)
