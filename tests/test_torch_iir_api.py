"""The port's public IIR API against the JAX package's: ``lfilter(zi=,
block_size=, engine=)``, ``filtfilt(engine=)``, ``FilterCoeffs.order``,
``_biquad_block_parallel`` with an initial state, and the chunked scan of
the CUDA kernel from a given state (``_chunked_sos_scan(zi=)``) over a
cascade longer than one launch takes.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, as tests/test_pallas_iir.py runs it) and the port's on
CPU tensors.  Bounds are those of tests/test_ops_iir.py: rel 2e-4 to
float64 ``sosfilt`` (max error over the max |value|), 1e-4 between two
routes or packages, 1e-3 for ``filtfilt``, and rtol 1e-4 / atol 1e-5
elementwise for the block-parallel biquad from an initial state.  All
inputs are finite: the block-Toeplitz route smears a NaN back over its
block.
"""

import numpy as np
import pytest
import scipy.signal as sps
import jax.numpy as jnp
import torch

import multimodal_brain_pattern_identification_xai_tpu.ops.iir as jiir

import multimodal_brain_pattern_identification_xai_tpu_torch.ops.iir as tiir
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import cuda_iir

BP5 = (0.5, 20.0, 200.0, 5)
ENGINES = ("auto", "pallas", "scan", "blockmm", "block", "xla")
T_LEN = 450


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _inputs(axis, with_zi, seed=7):
    """x with T_LEN samples along ``axis`` over (3, 4) lanes, and a random
    per-lane state (3, 4, K, 2) or None."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 4, T_LEN)) * 50).astype(np.float32)
    if axis == 0:
        x = np.ascontiguousarray(np.moveaxis(x, -1, 0))
    zi = ((rng.standard_normal((3, 4, 5, 2)) * 10).astype(np.float32)
          if with_zi else None)
    return x, zi


def _scipy(sos, x, axis, zi):
    """float64 ``sosfilt`` along ``axis``; ``zi`` (lanes..., K, 2)."""
    x64 = np.moveaxis(x.astype(np.float64), axis, -1)
    if zi is None:
        y = sps.sosfilt(np.asarray(sos), x64, axis=-1)
    else:
        y = sps.sosfilt(np.asarray(sos), x64, axis=-1,
                        zi=np.moveaxis(zi.astype(np.float64), -2, 0))[0]
    return np.moveaxis(y, -1, axis)


def test_filter_order_equals_jax():
    for args in (BP5, (0.5, 20.0, 200.0, 6)):
        assert (tiir.butter_bandpass(*args).order
                == jiir.butter_bandpass(*args).order == 2 * args[-1])
    assert (tiir.iirnotch(60.0, 30.0, 200.0).order
            == jiir.iirnotch(60.0, 30.0, 200.0).order == 2)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("block_size", [None, 64, 128, 200])
@pytest.mark.parametrize("engine", ENGINES)
def test_lfilter_matches_jax_and_scipy(engine, block_size, with_zi, axis):
    jc, tc = jiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP5)
    x, zi = _inputs(axis, with_zi)
    ref = _scipy(jc.sos, x, axis, zi)
    want = np.asarray(jiir.lfilter(
        jc, jnp.asarray(x), axis=axis, block_size=block_size, engine=engine,
        zi=None if zi is None else jnp.asarray(zi)))
    got = tiir.lfilter(tc, torch.from_numpy(x), axis=axis,
                       zi=None if zi is None else torch.from_numpy(zi),
                       block_size=block_size, engine=engine).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    assert _rel(got, ref) < 2e-4
    assert _rel(want, ref) < 2e-4
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("engine", ["auto", "pallas", "blockmm"])
@pytest.mark.parametrize("design", ["notch", "bp5"])
def test_filtfilt_engines_match_jax_and_scipy(design, engine):
    rng = np.random.default_rng(3)
    if design == "notch":
        jc, tc = (jiir.iirnotch(60.0, 30.0, 200.0),
                  tiir.iirnotch(60.0, 30.0, 200.0))
        x = (rng.standard_normal((6, 400)) * 10).astype(np.float32)
    else:
        jc, tc = jiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP5)
        x = (rng.standard_normal((3, 500)) * 10).astype(np.float32)
    ref = sps.filtfilt(np.asarray(jc.b), np.asarray(jc.a),
                       x.astype(np.float64), axis=-1)
    want = np.asarray(jiir.filtfilt(jc, jnp.asarray(x), engine=engine))
    got = tiir.filtfilt(tc, torch.from_numpy(x), engine=engine).numpy()
    assert _rel(got, ref) < 1e-3
    assert _rel(got, want) < 1e-3
    got0 = tiir.filtfilt(tc, torch.from_numpy(x.T.copy()), axis=0,
                         engine=engine).numpy()
    np.testing.assert_array_equal(got0, got.T)


@pytest.mark.parametrize("block,T", [(64, 700), (128, 640), (200, 150)])
def test_biquad_block_parallel_from_state_matches_jax(block, T):
    """One biquad (the notch) from a per-lane state: the port against
    JAX's ``_biquad_block_parallel`` and against the port's sequential scan
    from the same state; also from zero state."""
    rng = np.random.default_rng(11)
    jc, tc = (jiir.iirnotch(60.0, 30.0, 200.0),
              tiir.iirnotch(60.0, 30.0, 200.0))
    x = rng.standard_normal((5, T)).astype(np.float32)
    z0 = rng.standard_normal((5, 2)).astype(np.float32)
    for z in (z0, None):
        want = np.asarray(jiir._biquad_block_parallel(
            jnp.asarray(x), jc.sos[0], block,
            z0=None if z is None else jnp.asarray(z)))
        got = tiir._biquad_block_parallel(
            torch.from_numpy(x), tc.sos[0], block,
            z0=None if z is None else torch.from_numpy(z)).numpy()
        seq = tiir._sos_scan(torch.from_numpy(x), tc.sos,
                             None if z is None
                             else torch.from_numpy(z)[:, None, :]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, seq, rtol=1e-4, atol=1e-5)


def test_chunked_scan_from_state_over_split_sections():
    """A 13-section cascade from a random state: the CUDA wrapper's runs
    (``split_sections``: 12 + 1 sections, each from its slice of ``zi``)
    through the chunked scan, against the sequential scan of the whole
    cascade from ``zi`` and against float64 ``sosfilt``."""
    rng = np.random.default_rng(5)
    tc = tiir.cascade(tiir.butter_bandpass(*BP5),
                      tiir.butter_bandpass(0.5, 20.0, 200.0, 6),
                      tiir.butter_lowpass(40.0, 200.0, 4))
    assert len(tc.sos) == 13
    runs = cuda_iir.split_sections(tc.sos)
    assert [len(r) for r in runs] == [12, 1]
    x = (rng.standard_normal((6, 1500)) * 20).astype(np.float32)
    zi = (rng.standard_normal((6, 13, 2)) * 5).astype(np.float32)
    ref = _scipy(tc.sos, x, -1, zi)
    y, k0 = torch.from_numpy(x), 0
    for run in runs:
        y = tiir._chunked_sos_scan(
            y, run, cuda_iir.MIN_CHUNK,
            zi=torch.from_numpy(zi[:, k0:k0 + len(run)]))
        k0 += len(run)
    seq = tiir._sos_scan(torch.from_numpy(x), tc.sos,
                         torch.from_numpy(zi)).numpy()
    assert _rel(y.numpy(), ref) < 2e-4
    assert _rel(seq, ref) < 2e-4
    assert _rel(y.numpy(), seq) < 1e-4
    # the wrapper's CPU route is the sequential scan from zi itself
    np.testing.assert_array_equal(
        cuda_iir.sosfilt(tc, torch.from_numpy(x),
                         zi=torch.from_numpy(zi)).numpy(), seq)


@pytest.mark.parametrize("lanes,T", [(1, 10_000), (80, 10_000),
                                     (5120, 10_000), (3, 200_000),
                                     (64, 37), (2, 65_536)])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_given_state_launch_fits_its_cta(lanes, T, k):
    """The given-state kernel's CTAs hold at most GIVEN_THREADS threads
    (csrc/iir.cu ``shape_of`` with ``kGivenThreads``): G lanes of C
    chunks, from three chunks on at least 2K threads a lane; at the
    serving shapes the launch is the zero-state kernel's."""
    L, C, G = cuda_iir.launch_shape(lanes, T, k,
                                    max_threads=cuda_iir.GIVEN_THREADS)
    width = max(C, 2 * k) if C > 2 else C
    assert C == -(-T // L) and L % 4 == 0 and G >= 1
    assert G * width <= cuda_iir.GIVEN_THREADS
    if T == 10_000:
        assert (L, C, G) == cuda_iir.launch_shape(lanes, T, k)


def test_sosfilt_rejects_two_initial_states():
    tc = tiir.butter_bandpass(*BP5)
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError):
        cuda_iir.sosfilt(tc, x, steady_state_init=True,
                         zi=torch.zeros(5, 2))
