"""The chunked scan of the CUDA IIR kernels (``csrc/iir.cu``), in its plain
PyTorch emulation ``iir._chunked_sos_scan``, against the JAX package's
Pallas kernels (interpret mode) and scipy.

Bound: rel 2e-4, that of tests/test_pallas_iir.py.  Chunk lengths include
the shortest the wrappers pick (``cuda_iir.MIN_CHUNK``), ragged last
chunks and signals shorter than one chunk.
"""

import numpy as np
import pytest
import scipy.signal as sps
import jax.numpy as jnp
import torch

import multimodal_brain_pattern_identification_xai_tpu.ops.iir as jiir
from multimodal_brain_pattern_identification_xai_tpu.ops import pallas_iir

import multimodal_brain_pattern_identification_xai_tpu_torch.ops.iir as tiir
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import cuda_iir

BP5 = (0.5, 20.0, 200.0, 5)
BP6 = (0.5, 20.0, 200.0, 6)
MIN_CHUNK = cuda_iir.MIN_CHUNK


def _rel(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _filters(k):
    if k == 5:
        return jiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP5)
    if k == 6:
        return jiir.butter_bandpass(*BP6), tiir.butter_bandpass(*BP6)
    return (jiir.cascade(jiir.butter_bandpass(*BP5), jiir.butter_bandpass(*BP6)),
            tiir.cascade(tiir.butter_bandpass(*BP5), tiir.butter_bandpass(*BP6)))


def _chunked(tc, x, chunk, steady_state_init=False, rolldec=False):
    xt = torch.from_numpy(x)
    zi = None
    if steady_state_init:
        zi = torch.as_tensor(tiir._sos_zi(tc), dtype=torch.float32) \
            * xt[..., :1, None]
    return tiir._chunked_sos_scan(xt, tc.sos, chunk, zi, rolldec).numpy()


def _scipy(jc, x, steady_state_init=False):
    sos = np.asarray(jc.sos)
    if not steady_state_init:
        return sps.sosfilt(sos, x.astype(np.float64), axis=-1)
    zi = sps.sosfilt_zi(sos).reshape((len(sos),) + (1,) * (x.ndim - 1)
                                      + (2,)) * x[None, ..., :1]
    return sps.sosfilt(sos, x.astype(np.float64), axis=-1, zi=zi)[0]


@pytest.mark.parametrize("steady_state_init", [False, True])
@pytest.mark.parametrize("chunk,T", [(MIN_CHUNK, 700),      # ragged last chunk
                                     (128, 1024),           # exact chunks
                                     (256, 200)])           # T < one chunk
def test_sosfilt_matches_pallas_and_scipy(rng, steady_state_init, chunk, T):
    jc, tc = _filters(5)
    x = (rng.standard_normal((3, 4, T)) * 40).astype(np.float32)
    pal = np.asarray(pallas_iir.pallas_lfilter(
        jc, jnp.asarray(x), interpret=True, time_block=128,
        steady_state_init=steady_state_init))
    got = _chunked(tc, x, chunk, steady_state_init)
    assert got.shape == x.shape
    assert _rel(got, _scipy(jc, x, steady_state_init)) < 2e-4
    assert _rel(got, pal) < 2e-4


@pytest.mark.parametrize("k,chunk", [(11, MIN_CHUNK), (11, 256), (6, 96)])
def test_rolldec_matches_pallas_and_scipy(rng, k, chunk):
    jc, tc = _filters(k)
    x = (rng.standard_normal((2, 3, 1000)) * 20).astype(np.float32)
    ref = _scipy(jc, x).reshape(2, 3, 250, 4).mean(-1)
    pal = np.asarray(pallas_iir.pallas_lfilter_rolldec(
        jc, jnp.asarray(x), interpret=True, time_block=200))
    got = _chunked(tc, x, chunk, rolldec=True)
    assert got.shape == (2, 3, 250)
    assert _rel(got, ref) < 2e-4
    assert _rel(got, pal) < 2e-4


def _dc_drift(rng, lanes, T):
    """Scalp-EEG-like: ×20 noise on a 500 µV offset and a slow drift."""
    t = np.arange(T) / 200.0
    return (rng.standard_normal((lanes, T)) * 20 + 500
            + 100 * np.sin(2 * np.pi * 0.05 * t)).astype(np.float32)


@pytest.mark.parametrize("k,steady_state_init,rolldec",
                         [(5, True, False), (11, True, False),
                          (11, False, True)])
def test_dc_offset_at_shortest_chunk(rng, k, steady_state_init, rolldec):
    """At chunk 64 the chain cancels a chunk's exit state against A^L·e.
    Seeded from zero, each chunk would see a 500 µV step whose transient
    leaves ~5e-4 (K=5) to ~1e-3 (K=11) relative error in steady-state
    mode; the steady-state seed w_j = zi·x[jL] keeps it near the
    sequential scan's."""
    jc, tc = _filters(k)
    x = _dc_drift(rng, 6, 2000)
    ref = _scipy(jc, x, steady_state_init)
    got = _chunked(tc, x, MIN_CHUNK, steady_state_init, rolldec)
    if rolldec:
        ref = ref.reshape(6, 500, 4).mean(-1)
    assert _rel(got, ref) < 2e-4


@pytest.mark.parametrize("where", ["interior", "chunk_boundary", "last"])
def test_nan_mask_matches_scipy(rng, where):
    """A NaN reaches exactly the outputs at and after it, in its own chunk
    and every later one, as in scipy."""
    jc, tc = _filters(5)
    x = (rng.standard_normal((3, 640)) * 40).astype(np.float32)
    at = {"interior": 300, "chunk_boundary": 3 * MIN_CHUNK, "last": 639}[where]
    x[1, at] = np.nan
    x[2, at - 1] = np.nan
    ref = _scipy(jc, x)
    got = _chunked(tc, x, MIN_CHUNK)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert _rel(got[ok], ref[ok]) < 2e-4


@pytest.mark.parametrize("k", [5, 6, 11])
def test_chunk_power_equals_jax_block_operator(k):
    """The host A^L (L=128) is the JAX package's ``A_blk`` of
    ``_cascade_block_matmul_ops(sos, 128)`` for the float32-rounded
    sections the scans run, in the state order of
    ``_sos_zi(...).reshape(-1)``, and close to that of the float64 design."""
    jc, tc = _filters(k)
    coef, zi, a_pow = tiir._chunk_ops(tc.sos, 128)
    rounded = tiir._float32_sections(tc.sos)
    np.testing.assert_array_equal(
        a_pow, jiir._cascade_block_matmul_ops(rounded, 128)[2])
    design = jiir._cascade_block_matmul_ops(jc.sos, 128)[2]
    assert np.abs(a_pow - design).max() < 1e-2 * np.abs(design).max()
    np.testing.assert_array_equal(zi, jiir._sos_zi(jc).astype(np.float32))
    np.testing.assert_array_equal(coef, tiir.section_coefs(tc.sos))
    assert a_pow.shape == (2 * k, 2 * k) and zi.shape == (k, 2)


@pytest.mark.parametrize("lanes,T,k,want", [
    (5120, 10_000, 11, (320, 32, 8)),    # finite route, B=256
    (9728, 10_000, 6, (320, 32, 8)),     # NaN route's rolldec, B=256
    (80, 10_000, 11, (64, 157, 1)),      # B=4: the shortest chunk
    (76_800, 418, 1, (224, 2, 128)),     # filtfilt's notch, B=256
])
def test_launch_shape(lanes, T, k, want):
    L, C, G = cuda_iir.launch_shape(lanes, T, k)
    assert (L, C, G) == want
    assert L % cuda_iir.STAGE == 0 and L >= MIN_CHUNK and C == -(-T // L)
    width = max(C, 2 * k) if C > 2 else C
    assert G * width <= cuda_iir.MAX_THREADS


def test_launch_shape_caps_chunks_per_lane():
    L, C, G = cuda_iir.launch_shape(1, 1_000_000, 12, chunk=64)
    assert C <= cuda_iir.MAX_THREADS and L % 4 == 0 and G == 1
