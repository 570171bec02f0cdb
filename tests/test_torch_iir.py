"""IIR parity of the PyTorch port against the JAX package and scipy.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as tests/test_pallas_iir.py runs them) and through the
port's plain PyTorch versions — what a CPU tensor takes in
``ops/cuda_iir.py``.  Bounds are those of tests/test_pallas_iir.py.
"""

import numpy as np
import pytest
import scipy.signal as sps
import jax.numpy as jnp
import torch

import multimodal_brain_pattern_identification_xai_tpu.ops.iir as jiir
from multimodal_brain_pattern_identification_xai_tpu.ops import pallas_iir
from multimodal_brain_pattern_identification_xai_tpu.ops import (
    preprocess as jpre)

import multimodal_brain_pattern_identification_xai_tpu_torch.ops.iir as tiir
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_iir, preprocess as tpre)


def _rel(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


BP5 = (0.5, 20.0, 200.0, 5)
BP6 = (0.5, 20.0, 200.0, 6)


@pytest.mark.parametrize("design", ["bp5", "bp6", "cascade", "notch"])
def test_design_arrays_equal_jax(design):
    """Filter design, steady state and block-Toeplitz operators are the
    JAX package's arrays (same float64 host code)."""
    if design == "bp5":
        pair = (jiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP5))
    elif design == "bp6":
        pair = (jiir.butter_bandpass(*BP6), tiir.butter_bandpass(*BP6))
    elif design == "cascade":
        pair = (jiir.cascade(jiir.butter_bandpass(*BP5),
                             jiir.butter_bandpass(*BP6)),
                tiir.cascade(tiir.butter_bandpass(*BP5),
                             tiir.butter_bandpass(*BP6)))
    else:
        pair = (jiir.iirnotch(60.0, 30.0, 200.0),
                tiir.iirnotch(60.0, 30.0, 200.0))
    j, t = pair
    assert tuple(j) == tuple(t)
    np.testing.assert_array_equal(jiir._sos_zi(j), tiir._sos_zi(t))
    for a, b in zip(jiir._compose_state_space(j.sos),
                    tiir._compose_state_space(t.sos)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jiir._cascade_block_matmul_ops(j.sos, 128),
                    tiir._cascade_block_matmul_ops(t.sos, 128)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(64, 48), (400, 300)])
def test_spec_linear_operators_equal_jax(hw):
    jn = jiir.iirnotch(60.0, 30.0, 200.0)
    tn = tiir.iirnotch(60.0, 30.0, 200.0)
    for a, b in zip(jpre._spec_linear_operators(*hw, jn, 1.0),
                    tpre._spec_linear_operators(*hw, tn, 1.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpre._rolldec_map(128),
                                  tpre._rolldec_map(128))


@pytest.mark.parametrize("steady_state_init", [False, True])
def test_plain_sosfilt_matches_pallas_and_scipy(rng, steady_state_init):
    x = (rng.standard_normal((3, 4, 700)) * 40).astype(np.float32)
    jc, tc = jiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP5)
    sos = np.asarray(jc.sos)
    zi = (sps.sosfilt_zi(sos)[:, None, None, :] * x[None, ..., :1]
          if steady_state_init else None)             # (K, 3, 4, 2)
    if zi is None:
        ref = sps.sosfilt(sos, x.astype(np.float64), axis=-1)
    else:
        ref, _ = sps.sosfilt(sos, x.astype(np.float64), axis=-1, zi=zi)
    pal = np.asarray(pallas_iir.pallas_lfilter(
        jc, jnp.asarray(x), interpret=True, time_block=128,
        steady_state_init=steady_state_init))
    got = cuda_iir.sosfilt(tc, torch.from_numpy(x),
                           steady_state_init=steady_state_init).numpy()
    assert _rel(got, ref) < 2e-4
    assert _rel(got, pal) < 2e-4


def test_plain_rolldec_matches_pallas(rng):
    jc, tc = jiir.butter_bandpass(*BP6), tiir.butter_bandpass(*BP6)
    x = (rng.standard_normal((2, 3, 1024)) * 20).astype(np.float32)
    yref = sps.sosfilt(np.asarray(jc.sos), x.astype(np.float64), axis=-1)
    ref = yref.reshape(2, 3, 256, 4).mean(-1)
    pal = np.asarray(pallas_iir.pallas_lfilter_rolldec(
        jc, jnp.asarray(x), interpret=True, time_block=256))
    got = cuda_iir.sosfilt_rolldec(tc, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 256)
    assert _rel(got, ref) < 2e-4
    assert _rel(got, pal) < 2e-4


def test_filtfilt_matches_pallas(rng):
    jn, tn = jiir.iirnotch(60.0, 30.0, 200.0), tiir.iirnotch(60.0, 30.0, 200.0)
    x = (rng.standard_normal((4, 400)) * 5).astype(np.float32)
    ref = sps.filtfilt(np.asarray(jn.b), np.asarray(jn.a),
                       x.astype(np.float64), axis=-1)
    pal = np.asarray(pallas_iir.pallas_filtfilt(jn, jnp.asarray(x),
                                                interpret=True,
                                                time_block=128))
    got = tiir.filtfilt(tn, torch.from_numpy(x)).numpy()
    assert _rel(got, pal) < 1e-3
    assert _rel(got, ref) < 1e-3
    got0 = tiir.filtfilt(tn, torch.from_numpy(x.T.copy()), axis=0).numpy()
    assert _rel(got0, ref.T) < 1e-3


def test_nan_mask_matches_scipy(rng):
    """A NaN reaches only the samples at and after it (scipy semantics),
    so the samples before it keep their filtered values."""
    tc = tiir.butter_bandpass(*BP5)
    x = (rng.standard_normal((3, 1000)) * 40).astype(np.float32)
    x[0, 300] = np.nan
    x[2, 700:720] = np.nan
    ref = sps.sosfilt(np.asarray(tc.sos), x.astype(np.float64), axis=-1)
    got = tiir.lfilter(tc, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert _rel(got[ok], ref[ok]) < 2e-4


@pytest.mark.parametrize("variant", ["plain", "out_map", "z0"])
def test_block_matmul_route_matches_jax(rng, variant):
    """The block-Toeplitz route (with ``out_map`` or ``z0``) equals the JAX
    package's ``_cascade_block_matmul`` and the sequential scan."""
    if variant == "z0":
        jc, tc = jiir.iirnotch(60.0, 30.0, 200.0), tiir.iirnotch(60.0, 30.0,
                                                               200.0)
    else:
        jc = jiir.cascade(jiir.butter_bandpass(*BP5), jiir.butter_bandpass(*BP6))
        tc = tiir.cascade(tiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP6))
    x = (rng.standard_normal((3, 1000)) * 20).astype(np.float32)
    kw_j, kw_t = {}, {}
    if variant == "out_map":
        kw_j["out_map"] = kw_t["out_map"] = tpre._rolldec_map(128)
    if variant == "z0":
        z0 = (jiir._sos_zi(jc).reshape(-1)[None] * x[:, :1]).astype(np.float32)
        kw_j["z0"], kw_t["z0"] = jnp.asarray(z0), torch.from_numpy(z0)
    want = np.asarray(jiir._cascade_block_matmul(jnp.asarray(x), jc.sos, 128,
                                                 **kw_j))
    got = tiir._cascade_block_matmul(torch.from_numpy(x), tc.sos, 128,
                                     **kw_t).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-5
    zi = None
    if variant == "z0":
        zi = torch.as_tensor(tiir._sos_zi(tc), dtype=torch.float32) \
            * torch.from_numpy(x[:, :1, None])
    scan = tiir._sos_scan(torch.from_numpy(x), tc.sos, zi)
    if variant == "out_map":
        scan = scan.reshape(3, 250, 4).mean(-1)
    assert _rel(got, scan.numpy()) < 2e-4


def test_chain_entry_states_decay_truncation(rng):
    """Skipped Hillis-Steele levels (A_blk^shift below 1e-10) leave the
    entry states as the JAX package computes them."""
    jc = jiir.cascade(jiir.butter_bandpass(*BP5), jiir.butter_bandpass(*BP6))
    _, _, A_blk, _ = jiir._cascade_block_matmul_ops(jc.sos, 128)
    z = (rng.standard_normal((4, 79, A_blk.shape[0]))).astype(np.float32)
    want = np.asarray(jiir._chain_entry_states(
        jnp.asarray(z), A_blk, __import__("jax").lax.Precision.HIGHEST))
    got = tiir._chain_entry_states(torch.from_numpy(z), A_blk).numpy()
    # f32 matmuls over a 22-wide state with large couplings, summed in
    # another order by XLA and by torch: ~1e-5 relative
    assert _rel(got, want) < 1e-4


def _cascade13():
    """The finite route's cascade with ``denoise_bandpass_order=8``: 5 + 8
    = 13 sections, one more than a kernel launch takes."""
    return tiir.cascade(tiir.butter_bandpass(*BP5),
                        tiir.butter_bandpass(0.5, 20.0, 200.0, 8))


def test_split_sections_covers_the_cascade_in_order():
    sos = _cascade13().sos
    runs = cuda_iir.split_sections(sos)
    assert [len(r) for r in runs] == [12, 1]
    assert sum(runs, ()) == sos
    assert cuda_iir.split_sections(sos[:11]) == (sos[:11],)


@pytest.mark.parametrize("kind", ["zero", "steady_state", "rolldec"])
def test_split_sections_chain_equals_whole_cascade(rng, kind):
    """The plain scans chained over ``split_sections``' runs (each run
    from zero, or from its own steady state times its own input's first
    sample; the last run followed by the rolling mean for rolldec), which
    is what a CUDA call of more than 12 sections launches, equal the whole
    13-section scan and scipy at rel 2e-4."""
    coeffs = _cascade13()
    x = (rng.standard_normal((3, 2000)) * 40 + 300).astype(np.float32)
    xt = torch.from_numpy(x)
    steady = kind == "steady_state"
    y = xt
    for run in cuda_iir.split_sections(coeffs.sos):
        zi = (torch.as_tensor(tiir._steady_state(run), dtype=torch.float32)
              * y[..., :1, None] if steady else None)
        y = tiir._sos_scan(y, run, zi)
    sos = np.asarray(coeffs.sos)
    if steady:
        ref, _ = sps.sosfilt(sos, x.astype(np.float64), axis=-1,
                             zi=sps.sosfilt_zi(sos)[:, None, :]
                             * x[None, :, :1])
    else:
        ref = sps.sosfilt(sos, x.astype(np.float64), axis=-1)
    if kind == "rolldec":
        y = y.reshape(3, 500, 4).mean(-1)
        ref = ref.reshape(3, 500, 4).mean(-1)
        whole = cuda_iir.sosfilt_rolldec(coeffs, xt)
    else:
        whole = cuda_iir.sosfilt(coeffs, xt, steady_state_init=steady)
    assert _rel(y.numpy(), whole.numpy()) < 2e-4
    assert _rel(y.numpy(), ref) < 2e-4
