"""CUDA kernels of the PyTorch port against their plain PyTorch versions,
at the main path's shapes.  Needs an NVIDIA GPU (sm_90a) and nvcc: every
test here carries the ``cuda`` marker and skips without a card.  Run on
the card with
``python -m pytest -m cuda --noconftest tests/test_torch_cuda_kernels.py``.

Bounds: tests/test_pallas_iir.py (rel 2e-4, filtfilt 1e-3; #1 from a
given state too),
tests/test_pallas_specblock.py (f32 1e-5, against the chain in float64;
bf16 max 0.03 / mean 0.003 at
tensor scale; gradients 2e-4; the same for every width), bf16 against the
plain bf16 chain 1e-2 of its max (chip_smoke.py's BF16_PLAIN_REL), 1e-3 on
log-probs for whole models (chip_smoke.py's GPU-vs-CPU bound), 1e-6 for a
captured forward against eager (the same kernels on the same inputs) and the duty probe's 1e-4 relative (bf16
products are exact in float32; only the summation order differs), exact
on bf16 integer operands, whose sums are exact in float32.  The sequential plain scan runs on the CPU over a subset of
lanes (it is a Python loop over time)."""

import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu_torch import config as C
from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
    capture_forward, entry)
from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
    SpectrogramCNN, seeded_state_dict)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_duty, cuda_iir, cuda_specblock, eeg_transform, iir)

pytestmark = pytest.mark.cuda

BP5 = iir.butter_bandpass(0.5, 20.0, 200.0, 5)
BP6 = iir.butter_bandpass(0.5, 20.0, 200.0, 6)
NOTCH = iir.iirnotch(60.0, 30.0, 200.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def _signal(shape, scale, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32)


def test_sosfilt_zero_init(dev):
    x = _signal((80, 10_000), 40)
    n0 = cuda_iir.sosfilt.launches
    got = cuda_iir.sosfilt(BP5, x.to(dev))
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt.launches == n0 + 1
    assert _rel(got[::10], cuda_iir.sosfilt(BP5, x[::10])) < 2e-4


def test_sosfilt_nan_mask(dev):
    x = _signal((64, 2000), 40)
    x[5, 300] = float("nan")
    got = cuda_iir.sosfilt(BP5, x.to(dev)).cpu()
    want = cuda_iir.sosfilt(BP5, x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def test_filtfilt_steady_state(dev):
    x = _signal((1200, 400), 5)
    got = cuda_iir.filtfilt(NOTCH, x.to(dev))
    assert _rel(got[::40], cuda_iir.filtfilt(NOTCH, x[::40])) < 1e-3


@pytest.mark.parametrize("shape", [(4, 400, 300), (2, 200, 150)])
def test_filtfilt_along_axis_minus2(dev, shape):
    """The op-by-op spectrogram chain's notch: ``iir.filtfilt`` down the
    time axis of (B, H, W) planes, a strided view of B·W lanes, in two
    IIR launches, against the CPU's sequential scan."""
    x = _signal(shape, 5, seed=7)
    n0 = cuda_iir.sosfilt.launches
    got = iir.filtfilt(NOTCH, x.to(dev), axis=-2)
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt.launches == n0 + 2
    assert got.shape == shape
    assert _rel(got, iir.filtfilt(NOTCH, x, axis=-2)) < 1e-4


@pytest.mark.parametrize("shape,magic8", [((4, 10_000, 19), False),
                                          ((2, 10_000, 20), True)])
def test_eeg_transform_matches_cpu(dev, shape, magic8):
    """``eeg_transform``'s lowpass along axis -2 in one IIR launch, against
    the CPU's chain (rel 1e-4, the JAX package's bound)."""
    x = _signal(shape, 300, seed=8)
    x[0, 100:140, 3] = float("nan")
    cfg = C.EEGTransformConfig(apply_chris_magic_ch8=magic8,
                               apply_mu_law_encoding=magic8)
    n0 = cuda_iir.sosfilt.launches
    got = eeg_transform(x.to(dev), cfg)
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt.launches == n0 + 1
    want = eeg_transform(x, cfg)
    assert got.shape == want.shape == (shape[0], 2000, 8 if magic8 else 19)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("k", [6, 11])
def test_sosfilt_rolldec(dev, k):
    coeffs = BP6 if k == 6 else iir.cascade(BP5, BP6)
    x = _signal((152, 10_000), 20)
    n0 = cuda_iir.sosfilt_rolldec.launches
    got = cuda_iir.sosfilt_rolldec(coeffs, x.to(dev))
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt_rolldec.launches == n0 + 1
    assert got.shape == (152, 2500)
    assert _rel(got[::19], cuda_iir.sosfilt_rolldec(coeffs, x[::19])) < 2e-4


def _dc_drift(shape, seed=0):
    """×20 noise on a 500 µV offset and a slow drift (200 Hz)."""
    t = np.arange(shape[-1]) / 200.0
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape) * 20 + 500
                           + 100 * np.sin(2 * np.pi * 0.05 * t),
                           dtype=torch.float32)


def _held(coeffs, x, got, rolldec=False, zi=False, step=1):
    """The kernel's lanes x[::step] against the sequential scan and against
    the chunked scan's plain emulation at the kernel's chunk length, both
    on the CPU."""
    lanes, T = x.shape
    xs = x[::step]
    L = cuda_iir.launch_shape(lanes, T, len(coeffs.sos))[0]
    z = (torch.as_tensor(iir._sos_zi(coeffs), dtype=torch.float32)
         * xs[..., :1, None]) if zi else None
    seq = iir._sos_scan(xs, coeffs.sos, z)
    if rolldec:
        seq = seq.reshape(xs.shape[0], T // 4, 4).mean(-1)
    emu = iir._chunked_sos_scan(xs, coeffs.sos, L, z, rolldec)
    got = got[::step].cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(seq))
    ok = ~torch.isnan(seq)
    assert _rel(got[ok], seq[ok]) < 2e-4
    assert _rel(got[ok], emu[ok]) < 2e-4


# B=4 and B=256 lane counts of the serving path: its first bandpass (K=5,
# B·20 lanes), the finite route's cascade (K=11, B·20) and the NaN route's
# second bandpass (K=6, B·38)
@pytest.mark.parametrize("lanes,zi", [(80, False), (5120, False), (80, True)])
def test_sosfilt_serving_lanes(dev, lanes, zi):
    x = _signal((lanes, 10_000), 40, seed=1)
    got = cuda_iir.sosfilt(BP5, x.to(dev), steady_state_init=zi)
    _held(BP5, x, got, zi=zi, step=max(1, lanes // 16))


@pytest.mark.parametrize("k,lanes", [(11, 80), (11, 5120), (6, 152),
                                     (6, 9728)])
def test_sosfilt_rolldec_serving_lanes(dev, k, lanes):
    coeffs = BP6 if k == 6 else iir.cascade(BP5, BP6)
    x = _signal((lanes, 10_000), 20, seed=2)
    got = cuda_iir.sosfilt_rolldec(coeffs, x.to(dev))
    assert got.shape == (lanes, 2500)
    _held(coeffs, x, got, rolldec=True, step=max(1, lanes // 16))


@pytest.mark.parametrize("kind", ["sosfilt_zi", "rolldec"])
def test_dc_offset_at_shortest_chunk(dev, kind):
    """80 lanes (B=4) pick the shortest chunk; a 500 µV offset plus drift
    stays within the bound (a zero seed would miss it, see
    tests/test_torch_iir_chunked.py)."""
    x = _dc_drift((80, 10_000), seed=3)
    assert cuda_iir.launch_shape(80, 10_000, 11)[0] == cuda_iir.MIN_CHUNK
    if kind == "rolldec":
        coeffs = iir.cascade(BP5, BP6)
        got = cuda_iir.sosfilt_rolldec(coeffs, x.to(dev))
    else:
        coeffs = BP5
        got = cuda_iir.sosfilt(coeffs, x.to(dev), steady_state_init=True)
    _held(coeffs, x, got, rolldec=kind == "rolldec", zi=kind != "rolldec",
          step=5)


@pytest.mark.parametrize("T", [10_001, 9_998, 999, 37])
def test_sosfilt_ragged_length(dev, T):
    """T % 4 != 0 (scalar loads), a ragged last chunk, and T below one
    chunk."""
    x = _signal((96, T), 40, seed=4)
    got = cuda_iir.sosfilt(BP5, x.to(dev))
    _held(BP5, x, got, step=6)


def test_sosfilt_nan_at_chunk_boundary(dev):
    x = _signal((80, 10_000), 40, seed=5)
    L = cuda_iir.launch_shape(80, 10_000, 5)[0]
    x[3, 3 * L] = float("nan")          # a chunk's first sample
    x[7, 3 * L - 1] = float("nan")      # the chunk before's last sample
    x[11, 9_999] = float("nan")         # the last sample
    x[12, 0] = float("nan")
    got = cuda_iir.sosfilt(BP5, x.to(dev))
    _held(BP5, x, got)


# #1 from a given per-lane state (lfilter(zi=)): 1, 5, 11 and 13 sections
# (13: two launches, 12 + 1, each from its slice of zi)
K13 = iir.cascade(BP5, BP6, iir.butter_lowpass(40.0, 200.0, 4))
BY_K = {1: NOTCH, 5: BP5, 11: iir.cascade(BP5, BP6), 13: K13}


def _held_given(coeffs, x, zi, got, step=1):
    """The kernel's lanes x[::step] from the state zi[::step] against the
    sequential scan from that state and against the chunked scan's plain
    emulation run by run (each at the kernel's chunk length, from its
    slice of the state), both on the CPU."""
    lanes, T = x.shape
    xs, zs = x[::step], zi[::step]
    seq = iir._sos_scan(xs, coeffs.sos, zs)
    emu, k0 = xs, 0
    for run in cuda_iir.split_sections(coeffs.sos):
        L = cuda_iir.launch_shape(lanes, T, len(run),
                                  max_threads=cuda_iir.GIVEN_THREADS)[0]
        emu = iir._chunked_sos_scan(emu, run, L, zs[:, k0:k0 + len(run)])
        k0 += len(run)
    got = got[::step].cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(seq))
    ok = ~torch.isnan(seq)
    assert _rel(got[ok], seq[ok]) < 2e-4
    assert _rel(got[ok], emu[ok]) < 2e-4


@pytest.mark.parametrize("lanes,T", [(1, 10_000), (5120, 10_000),
                                     (96, 9_998)])
@pytest.mark.parametrize("k", sorted(BY_K))
def test_sosfilt_given_state(dev, k, lanes, T):
    coeffs = BY_K[k]
    assert len(coeffs.sos) == k
    x = _signal((lanes, T), 40, seed=7)
    zi = _signal((lanes, k, 2), 10, seed=8)
    n0, g0 = cuda_iir.sosfilt.launches, cuda_iir.sosfilt.given_launches
    got = cuda_iir.sosfilt(coeffs, x.to(dev), zi=zi.to(dev))
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt.launches == n0
    assert (cuda_iir.sosfilt.given_launches
            == g0 + len(cuda_iir.split_sections(coeffs.sos)))
    _held_given(coeffs, x, zi, got, step=max(1, lanes // 8))


@pytest.mark.parametrize("k", [5, 13])
def test_sosfilt_given_state_nan(dev, k):
    """A NaN in chunk 0 of one lane and in a later chunk of another."""
    coeffs = BY_K[k]
    x = _signal((80, 10_000), 40, seed=9)
    zi = _signal((80, k, 2), 10, seed=10)
    L = cuda_iir.launch_shape(80, 10_000, min(k, cuda_iir.MAX_SECTIONS),
                              max_threads=cuda_iir.GIVEN_THREADS)[0]
    x[3, L // 2] = float("nan")
    x[9, 5 * L + 3] = float("nan")
    got = cuda_iir.sosfilt(coeffs, x.to(dev), zi=zi.to(dev))
    _held_given(coeffs, x, zi, got)
    assert torch.isnan(got[3, L // 2:]).all() and torch.isnan(
        got[9, 5 * L + 3:]).all()


def test_sosfilt_given_state_equals_steady_state(dev):
    """The steady state given as a state (``zi_k · x[0]``, broadcast from
    (K, 2)) is the same start as ``steady_state_init``: bitwise equal."""
    x = _dc_drift((80, 10_000), seed=11).to(dev)
    zi = torch.as_tensor(iir._sos_zi(BP5), dtype=torch.float32, device=dev)
    got = cuda_iir.sosfilt(BP5, x, zi=zi * x[:, :1, None])
    assert torch.equal(got, cuda_iir.sosfilt(BP5, x, steady_state_init=True))
    one = cuda_iir.sosfilt(BP5, x, zi=zi)            # (K, 2) to every lane
    assert torch.equal(one, cuda_iir.sosfilt(
        BP5, x, zi=zi.expand(80, 5, 2).contiguous()))


@pytest.mark.parametrize("engine", ["auto", "pallas", "scan", "blockmm",
                                    "block", "xla"])
@pytest.mark.parametrize("with_zi", [False, True])
def test_lfilter_engines_on_card(dev, engine, with_zi):
    """``ops.lfilter`` on a CUDA tensor against the same call on the CPU:
    the sequential-scan engines and every ``zi`` launch the kernel (from
    the given state where there is one), the block routes none."""
    x = _signal((64, 2000), 40, seed=12)
    zi = _signal((64, 5, 2), 10, seed=13) if with_zi else None
    n0, g0 = cuda_iir.sosfilt.launches, cuda_iir.sosfilt.given_launches
    got = iir.lfilter(BP5, x.to(dev), zi=None if zi is None else zi.to(dev),
                      engine=engine)
    torch.cuda.synchronize()
    scan = with_zi or engine in ("auto", "pallas", "scan")
    assert cuda_iir.sosfilt.given_launches == g0 + int(with_zi)
    assert cuda_iir.sosfilt.launches == n0 + int(scan and not with_zi)
    assert _rel(got, iir.lfilter(BP5, x, zi=zi, engine=engine)) < 2e-4


def test_misaligned_input(dev):
    """A view 4 bytes off a 16-byte boundary: sosfilt reads it with scalar
    loads, sosfilt_rolldec copies it first."""
    base = _signal((40, 10_004), 40, seed=6).to(dev)
    flat = base.reshape(-1)[1:1 + 40 * 10_000].reshape(40, 10_000)
    assert flat.data_ptr() % 16 == 4
    got = cuda_iir.sosfilt(BP5, flat)
    _held(BP5, flat.cpu(), got, step=4)
    coeffs = iir.cascade(BP5, BP6)
    got = cuda_iir.sosfilt_rolldec(coeffs, flat)
    _held(coeffs, flat.cpu(), got, rolldec=True, step=4)


def _block_args(cin, cout, h, w, b=2, seed=0, wscale=0.2):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
    x = f(b, h, w, cin)
    ks = [f(3, 3, ci, cout) * wscale for ci in (cin, cout, cout)]
    bs = [f(cout) * 0.1 for _ in range(3)]
    return x, ks, bs


def _chain_f64(x, ks, bs, pool):
    """The fused block's chain (``_chain_convpool``) in float64, NHWC."""
    import torch.nn.functional as F
    h = x.double().permute(0, 3, 1, 2)
    for k, b in zip(ks, bs):
        h = torch.relu(F.conv2d(h, k.double().permute(3, 2, 0, 1),
                                b.double(), padding=1))
    h = F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return h.permute(0, 2, 3, 1)


def _case(dtype, cin, cout, h, w, pool, batch=2, scale=1.0, id=None,
          wscale=0.2):
    dt = "dtype0" if dtype == torch.float32 else "dtype1"
    return pytest.param(dtype, cin, cout, h, w, pool, batch, scale, wscale,
                        id=f"{id or f'{cin}-{cout}-{h}-{w}-{pool}'}-{dt}")


# Cout 8/16/32: float32 runs the 3xTF32 tensor-core kernel, bf16 the bf16
# tensor-core one
_SPECBLOCK_CASES = [
    _case(dt, *shape)
    for shape in ((3, 16, 400, 300, "max"),       # block 1
                  (16, 32, 200, 150, "avg"),      # block 2
                  (5, 8, 8, 20, "max"))           # ragged small plane
    for dt in (torch.float32, torch.bfloat16)
] + [
    # block 1 of the 200x150 preset (its only fused block)
    _case(dt, 3, 16, 200, 150, "max", id="preset-block1")
    for dt in (torch.float32, torch.bfloat16)
] + [
    # Cout 8, every stage on the tensor cores, both sides ragged against 16
    _case(torch.float32, 16, 8, 34, 38, "avg"),
    # one tile, W smaller than the halo
    _case(torch.float32, 8, 16, 18, 2, "max"),
    _case(torch.float32, 16, 32, 200, 150, "avg", batch=1, id="block2-B1"),
    # large inputs: a missing lo term of the 3xTF32 split shows at once
    _case(torch.float32, 16, 32, 200, 150, "avg", scale=100.0,
          id="block2-x100"),
] + [
    # the bf16 kernel's edges: Cout 8 (k16 steps, then one k8 step) with a
    # 16-channel conv1, ragged; cin 8 (16-byte staging, k8 tail in conv1)
    # on one tile narrower than the halo; B = 1; x100 inputs
    _case(torch.bfloat16, 16, 8, 34, 38, "avg"),
    _case(torch.bfloat16, 8, 16, 18, 2, "max"),
    _case(torch.bfloat16, 16, 32, 200, 150, "avg", batch=1, id="block2-B1"),
    _case(torch.bfloat16, 16, 32, 200, 150, "avg", scale=100.0,
          id="block2-x100"),
] + [
    # the wide kernel (blocks 3-5's widths), on the planes of a 64x48 input
    # and on one plane wider than its tile (8x8; 4x4 at Cout 256); weights
    # at the He scale, so activations stay O(1) through fan-ins up to 2304
    _case(dt, cin, cout, h, w, pool, wscale=float(np.sqrt(2 / (9 * cin))))
    for cin, cout in ((32, 64), (64, 128), (128, 256))
    for h, w in ((16, 12), (8, 6), (20, 18))
    for pool in ("max", "avg")
    for dt in (torch.float32, torch.bfloat16)
] + [
    # the wide convs' edges: Cin 24 and 5 (conv1 zero-padded to 32
    # channels); B = 1 on 10x6 (M = 60, under one 128-pixel tile); x100
    # inputs at Cout 256 (a dropped lo term of the 3xTF32 split shows at
    # once); a 100x76 plane (many tiles, B = 2)
    _case(dt, cin, cout, h, w, pool, batch=batch, scale=scale,
          id=ident, wscale=float(np.sqrt(2 / (9 * cin))))
    for dt in (torch.bfloat16, torch.float32)
    for cin, cout, h, w, pool, batch, scale, ident in (
        (24, 64, 16, 12, "max", 2, 1.0, "wide-cin24"),
        (5, 64, 10, 6, "avg", 2, 1.0, "wide-cin5"),
        (32, 64, 10, 6, "max", 1, 1.0, "wide-B1-10x6"),
        (128, 256, 8, 6, "max", 2, 100.0, "wide-256-x100"),
        (32, 64, 100, 76, "avg", 2, 1.0, "wide-100x76"))
]


@pytest.mark.parametrize("dtype,cin,cout,h,w,pool,batch,scale,wscale",
                         _SPECBLOCK_CASES)
def test_specblock_matches_plain(dev, dtype, cin, cout, h, w, pool, batch,
                                 scale, wscale):
    x, ks, bs = _block_args(cin, cout, h, w, b=batch, wscale=wscale)
    xd, kd, bd = (x * scale).to(dev), [k.to(dev) for k in ks], [
        b.to(dev) for b in bs]
    fused = cuda_specblock.fused_specblock_convpool
    name = cuda_specblock.kernel_name(cout, dtype)
    n0, k0 = fused.launches, fused.kernel_launches[name]
    got = fused(xd, kd, bd, pool=pool, dtype=dtype).float()
    torch.cuda.synchronize()
    assert fused.launches == n0 + 1
    assert fused.kernel_launches[name] == k0 + 1
    truth = cuda_specblock._plain_convpool(xd, kd, bd, pool,
                                           torch.float32).float()
    assert got.shape == truth.shape == (batch, h // 2, w // 2, cout)
    if dtype == torch.float32:
        # atol is in units of the input: at x100 an output that ReLU and
        # the pool leave near zero still carries rounding of partial sums
        # ~100x larger, in any f32 summation order (cuDNN's own f32 chain
        # misses atol 1e-5 against float64 there); a dropped lo term of the
        # 3xTF32 split errs by ~2^-11 of those sums, ~100x this atol.  The
        # reference is the chain in float64: at the wide blocks' fan-ins (up
        # to 2304) cuDNN's f32 chain alone sits up to 0.84 of this bound from
        # float64 (128 -> 256 on 20x18), so kernel and chain, each rounding
        # its own way, can differ by more than the bound while the kernel
        # stays within 0.37 of it (H100, 3xTF32 wide conv;
        # scripts/torch_specblock_f64.py prints both)
        torch.testing.assert_close(got.double(), _chain_f64(xd, kd, bd, pool),
                                   rtol=1e-5, atol=1e-5 * scale)
    else:
        err = (got - truth).abs() / truth.abs().max()
        assert float(err.max()) < 0.03 and float(err.mean()) < 0.003
        plain = cuda_specblock._plain_convpool(xd, kd, bd, pool,
                                               torch.bfloat16).float()
        assert _rel(got, plain) < 1e-2


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_specblock_vjp_matches_unfused_chain(dev, pool):
    """The fused block's backward on the card (fused forward, recomputed
    cuDNN chain) against autograd of the unfused chain, w.r.t. x, kernels
    and biases, at block 2's shape."""
    x, ks, bs = _block_args(16, 32, 200, 150)
    args = [t.to(dev).requires_grad_() for t in (x, *ks, *bs)]
    g = torch.randn((2, 100, 75, 32), generator=torch.Generator().manual_seed(1))
    n0 = cuda_specblock.fused_specblock_convpool.launches
    out = cuda_specblock.fused_specblock_convpool(
        args[0], args[1:4], args[4:7], pool=pool, dtype=torch.float32)
    got = torch.autograd.grad(out, args, g.to(dev))
    assert cuda_specblock.fused_specblock_convpool.launches == n0 + 1
    ref = cuda_specblock._chain_convpool(args[0], args[1:4], args[4:7], pool,
                                         torch.float32)
    want = torch.autograd.grad(ref, args, g.to(dev))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) < 2e-4


def test_specblock_other_width_raises(dev):
    """A width with no instantiation raises and names the widths taken."""
    x, ks, bs = _block_args(8, 48, 8, 8)
    with pytest.raises(ValueError, match="64, 128, 256"):
        cuda_specblock.fused_specblock_convpool(
            x.to(dev), [k.to(dev) for k in ks], [b.to(dev) for b in bs])


def _wide_captured_equals_eager(dev, pool, dtype):
    """A wide call (its t1, t2 scratch allocated under capture) captured
    in a CUDA graph gives the eager call's output exactly on two inputs
    copied into the graph's input tensor."""
    x, ks, bs = _block_args(32, 64, 16, 12, wscale=float(np.sqrt(2 / 288)))
    xd = x.to(dev).to(dtype)
    kd, bd = [k.to(dev) for k in ks], [b.to(dev) for b in bs]
    call = lambda: cuda_specblock.fused_specblock_convpool(
        xd, kd, bd, pool=pool, dtype=dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                                   # warm-up (build, pack)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for shift in (0.0, 0.5):
        xd.copy_((x + shift).to(dtype))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_specblock_wide_bf16_captured_equals_eager(dev, pool):
    _wide_captured_equals_eager(dev, pool, torch.bfloat16)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_specblock_wide_f32_captured_equals_eager(dev, pool):
    _wide_captured_equals_eager(dev, pool, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,h,w", [(3, 8, 4, 2), (32, 64, 2, 2)])
def test_specblock_batch_above_grid_y(dev, dtype, cin, cout, h, w):
    """B = 65,536, one more sample than gridDim.y can hold: the 16x16-tile
    kernels launch the batch in slices of 65,535 and the wide convs take any B
    with B*H*W < 2^31, so both run against the plain chain at the bounds
    of test_specblock_matches_plain (Cout 8: 6 MB of f32 x)."""
    x, ks, bs = _block_args(cin, cout, h, w, b=65_536,
                            wscale=float(np.sqrt(2 / (9 * cin))))
    xd, kd, bd = x.to(dev).to(dtype), [k.to(dev) for k in ks], [
        b.to(dev) for b in bs]
    fused = cuda_specblock.fused_specblock_convpool
    name = cuda_specblock.kernel_name(cout, dtype)
    k0 = fused.kernel_launches[name]
    got = fused(xd, kd, bd, pool="max", dtype=dtype).float()
    torch.cuda.synchronize()
    assert fused.kernel_launches[name] == k0 + 1
    plain = cuda_specblock._plain_convpool(xd, kd, bd, "max", dtype).float()
    assert got.shape == plain.shape == (65_536, h // 2, w // 2, cout)
    if dtype == torch.float32:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, plain) < 1e-2


def _spec_block(cin, cout, pool, dev, seed=0):
    """A bf16 fused ``SpectrogramBlock`` in eval mode with the benchmark's
    weight scales (convs N(0, 1.4/fan_in), biases and running means sd
    0.1, BatchNorm scales 1 + N(0, 0.1), running variances U(0.5, 1.5))."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        layers)
    g = torch.Generator().manual_seed(seed)
    blk = layers.SpectrogramBlock(cin, cout, pool_type=pool, fused=True,
                                  dtype=torch.bfloat16)
    with torch.no_grad():
        for m in (blk.conv1, blk.conv2, blk.conv3, blk.conv1x1):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (1.4 / m.weight[0].numel()) ** 0.5)
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
        blk.bn.weight.copy_(1 + 0.1 * torch.randn(cout, generator=g))
        blk.bn.bias.copy_(0.1 * torch.randn(cout, generator=g))
        blk.bn.running_mean.copy_(0.1 * torch.randn(cout, generator=g))
        blk.bn.running_var.copy_(0.5 + torch.rand(cout, generator=g))
    return blk.to(dev).eval()


def _block_input(cin, h, w, b, dev, seed=0):
    """(base, x): block 1's input, a [0, 1] plane expanded to three
    channels (channel stride 0, as ``hms_spectrogram_preprocess`` returns
    it), or block 2's, ReLU outputs of ``cin`` channels in channels-last
    (the NHWC output of block 1 seen as NCHW); writing ``base`` writes x."""
    g = torch.Generator().manual_seed(seed)
    if cin == 3:
        base = torch.rand((b, 1, h, w), generator=g).to(dev, torch.bfloat16)
        return base, base.expand(b, 3, h, w)
    base = torch.randn((b, h, w, cin), generator=g).relu().to(
        dev, torch.bfloat16)
    return base, base.permute(0, 3, 1, 2)


def _todays_path(blk, x):
    """The block as it runs where autograd records: conv x3 + pool through
    the fused kernel, BatchNorm, skip and add in stock ops."""
    fused = cuda_specblock.fused_specblock_convpool
    k0 = fused.kernel_launches["specblock_convpool_bf16"]
    with torch.enable_grad():
        out = blk(x).detach()
    assert fused.kernel_launches["specblock_convpool_bf16"] == k0 + 1
    return out


# (cin, cout, h, w, batch, pool): blocks 1 and 2 of the 400x300 program at
# B=256, and each width at B = 1 and 3 on ragged planes, both inputs
_WHOLE_CASES = [
    (3, 16, 400, 300, 256, "max"), (16, 32, 200, 150, 256, "avg"),
    (3, 8, 34, 38, 3, "avg"), (16, 8, 34, 38, 1, "max"),
    (3, 16, 18, 20, 1, "avg"), (16, 16, 50, 38, 3, "max"),
    (3, 32, 36, 22, 3, "max"), (16, 32, 200, 150, 1, "avg"),
]


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("cin,cout,h,w,batch,pool", _WHOLE_CASES)
def test_whole_block_matches_todays_path(dev, cin, cout, h, w, batch, pool,
                                         graph):
    """The whole bf16 block (one launch of ``specblock_bf16_tc_kernel<C,
    true>``, x read in place) against the same block on today's path (the
    fused kernel, then BatchNorm, skip and add in stock ops): 1e-2 of the
    latter's max (BF16_PLAIN_REL), NHWC out seen as NCHW.  Captured in a
    CUDA graph, each replay on a new input written into the captured one
    equals the eager whole block exactly."""
    blk = _spec_block(cin, cout, pool, dev, seed=cin + cout)
    base, x = _block_input(cin, h, w, batch, dev)
    fused = cuda_specblock.fused_specblock_convpool
    name = cuda_specblock.WHOLE_KERNEL

    def whole():
        k0 = fused.kernel_launches[name]
        with torch.no_grad():
            out = blk(x)
        assert fused.kernel_launches[name] == k0 + 1
        return out

    if not graph:
        got = whole()
        assert got.shape == (batch, cout, h // 2, w // 2)
        assert got.permute(0, 2, 3, 1).is_contiguous()
        assert _rel(got, _todays_path(blk, x)) < 1e-2
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        whole()                                  # warm-up (build, pack)
    torch.cuda.current_stream().wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        out = whole()
    for seed in (1, 2):
        base.copy_(_block_input(cin, h, w, batch, dev, seed=seed)[0])
        cuda_graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, whole())
        assert _rel(out, _todays_path(blk, x)) < 1e-2


def test_speccnn_whole_blocks_match_todays_path(dev):
    """The bf16 ``SpectrogramCNN(fused_blocks=2)`` at 400x300: with autograd
    off its blocks 1-2 run whole (two launches, no fused-only launch);
    with it on they take today's path.  Probabilities within 2e-2 (the
    JAX package's bf16 bound), log-probs within 1e-2 of their max."""
    model = SpectrogramCNN(fused_blocks=2, dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 4))
    model.to(dev).eval()
    x = torch.rand((2, 1, 400, 300), generator=torch.Generator()
                   .manual_seed(3)).to(dev, torch.bfloat16).expand(
                       2, 3, 400, 300)
    fused = cuda_specblock.fused_specblock_convpool
    k = dict(fused.kernel_launches)
    with torch.inference_mode():
        got = model(x)
    torch.cuda.synchronize()
    assert fused.kernel_launches[cuda_specblock.WHOLE_KERNEL] == k[
        cuda_specblock.WHOLE_KERNEL] + 2
    assert fused.kernel_launches["specblock_convpool_bf16"] == k[
        "specblock_convpool_bf16"]
    with torch.enable_grad():
        want = model(x).detach()
    assert fused.kernel_launches["specblock_convpool_bf16"] == k[
        "specblock_convpool_bf16"] + 2
    assert got.shape == want.shape == (2, 6)
    assert float((got.exp() - want.exp()).abs().max()) < 2e-2
    assert _rel(got, want) < 1e-2


def test_whole_block_counters(dev):
    """A traced bf16 forward on the card counts each of its two fused
    blocks in ``models.spec_block.fused`` and ``models.spec_block.whole``,
    and ``kernel_launches`` ticks under the whole block's own key; untraced,
    the counters stay."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    model = SpectrogramCNN(fused_blocks=2, dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, 4))
    model.to(dev).eval()
    x = torch.rand((1, 3, 64, 48), device=dev).to(torch.bfloat16)
    fused = cuda_specblock.fused_specblock_convpool
    before = dict(profiling.collect().counters)
    k0 = fused.kernel_launches[cuda_specblock.WHOLE_KERNEL]
    with torch.inference_mode():
        model(x)
        with profiling.traced():
            model(x)
    got = profiling.collect().counters
    for name in ("models.spec_block.fused", "models.spec_block.whole"):
        assert got.get(name, 0) - before.get(name, 0) == 2
    assert fused.kernel_launches[cuda_specblock.WHOLE_KERNEL] == k0 + 4


def test_preprocess_13_sections_matches_cpu(dev):
    """The finite route with ``denoise_bandpass_order=8`` is one 5 + 8 =
    13-section cascade, one more than a launch takes: on the card it runs
    as a 12-section ``sosfilt`` launch then a 1-section rolldec launch,
    and equals the CPU port (z-scored units, the 5e-3 bound of
    tests/test_torch_preprocess.py)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        hms_eeg_preprocess)
    cfg = C.HMSPreprocessConfig(denoise_bandpass_order=8)
    x = _signal((2, 20, 10_000), 40, seed=9)
    n0 = cuda_iir.sosfilt.launches
    r0 = cuda_iir.sosfilt_rolldec.launches
    got = hms_eeg_preprocess(x.to(dev), cfg, assume_finite=True)
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt.launches == n0 + 1
    assert cuda_iir.sosfilt_rolldec.launches == r0 + 1
    want = hms_eeg_preprocess(x, cfg, assume_finite=True)
    assert got.shape == want.shape == (2, 1, 37, 3000)
    assert float((got.cpu() - want).abs().max()) < 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_blocks", [3, 4])
def test_speccnn_fused_wide_blocks_match_unfused(dev, fused_blocks, dtype):
    """SpectrogramCNN with blocks 3-4 fused (Cout 64 on 16x12, 128 on 8x6)
    against the unfused model on a 64x48 input: float32 log-probs within
    1e-3, the GPU-vs-CPU bound of chip_smoke.py (sums in other orders);
    bf16 probabilities within 2e-2 (the JAX package's bf16 bound)."""
    serving = None if dtype == torch.float32 else dtype
    fused_m = SpectrogramCNN(fused_blocks=fused_blocks, dtype=serving)
    fused_m.load_state_dict(seeded_state_dict(fused_m, 4))
    plain_m = SpectrogramCNN(dtype=serving)
    plain_m.load_state_dict(fused_m.state_dict())
    fused_m.to(dev).eval()
    plain_m.to(dev).eval()
    x = _signal((2, 3, 64, 48), 1.0).to(dev)
    fused = cuda_specblock.fused_specblock_convpool
    name = cuda_specblock.kernel_name(64, dtype)
    n0 = fused.kernel_launches[name]
    with torch.no_grad():
        got, want = fused_m(x), plain_m(x)
    torch.cuda.synchronize()
    assert fused.kernel_launches[name] == n0 + fused_blocks - 2
    if dtype == torch.float32:
        assert float((got - want).abs().max()) < 1e-3
    else:
        assert float((got.exp() - want.exp()).abs().max()) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_forward_equals_eager(dev, dtype):
    """The serving forward captured as one CUDA graph gives the eager
    forward's log-probs (max abs 1e-6) on two different inputs replayed
    through the same graph."""
    fwd, (eeg, spec) = entry(device="cuda", batch=2, assume_finite=True,
                             serving_dtype=None if dtype == torch.float32
                             else dtype)
    graph = capture_forward(fwd, (eeg, spec))
    for shift in (0.0, 3.0):
        e, s = eeg + shift, spec * (1 + shift)
        got, want = graph(e, s), fwd(e, s)
        assert got.shape == (2, 6) and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-6


def test_captured_forward_times_its_layers(dev):
    """The spans of the served forward record timing events into its
    graph: each traced replay brings one ``graph=True`` record of every
    layer, and the top-level layers of a replay sum to at most the
    replay's device time (events around the request, on its stream)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    fwd, (eeg, spec) = entry(device="cuda", batch=2, assume_finite=True,
                             serving_dtype=torch.bfloat16)
    graph = capture_forward(fwd, (eeg, spec))
    layers = ("mbx.preprocess.eeg", "mbx.preprocess.spec",
              "mbx.model.eeg_branch", "mbx.model.spec_branch",
              "mbx.model.head")
    before = profiling.collect()
    times = []
    with profiling.traced():
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graph(eeg, spec)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
    got = profiling.collect()
    for name in layers:
        old = before.graph_sums.get(name, profiling.SpanSum())
        assert got.graph_sums[name].calls == old.calls + 3
    mine = got.spans[len(got.spans) - 3 * (len(layers) + 5):]
    requests = [r.request for r in mine if r.name == "mbx.entry.request"]
    assert len(requests) == 3
    assert all(r.device_ms is None for r in mine if not r.graph)
    for req, dev_ms in zip(requests, times):
        top = [r for r in mine if r.graph and r.request == req
               and r.parent is None]
        assert sorted(r.name for r in top) == sorted(layers)
        assert all(r.device_ms > 0 for r in top)
        assert sum(r.device_ms for r in top) <= dev_ms + 0.005


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_preset_forward_matches_cpu(dev, dtype):
    """The 200x150 preset's forward (both EEG routes) on the card against
    the CPU: log-probs within 1e-3 (float32) or probabilities within 2e-2
    (bf16); the fused block once a forward (block 2's 100x75 plane is odd),
    in bf16 as the whole block; captured equal to eager (1e-6)."""
    serving = None if dtype == torch.float32 else dtype
    name = (cuda_specblock.kernel_name(16, dtype) if serving is None
            else cuda_specblock.WHOLE_KERNEL)
    for finite in (True, False):
        fwd, (eeg, spec) = entry(device="cuda", batch=2, assume_finite=finite,
                                 serving_dtype=serving,
                                 signal=C.SPEC_RES_PRESET)
        cfwd, (ceeg, cspec) = entry(device="cpu", batch=2,
                                    assume_finite=finite,
                                    serving_dtype=serving,
                                    signal=C.SPEC_RES_PRESET)
        if not finite:
            for e, s in ((eeg, spec), (ceeg, cspec)):
                e[1, 5, 2000:2300] = float("nan")
                s[1, 200, :] = float("nan")
        k0 = cuda_specblock.fused_specblock_convpool.kernel_launches[name]
        got = fwd(eeg, spec)
        torch.cuda.synchronize()
        assert cuda_specblock.fused_specblock_convpool.kernel_launches[
            name] == k0 + 1
        want = cfwd(ceeg, cspec)
        assert got.shape == (2, 6) and bool(torch.isfinite(got).all())
        if serving is None:
            assert float((got.cpu() - want).abs().max()) < 1e-3
        else:
            assert float((got.cpu().exp() - want.exp()).abs().max()) < 2e-2
        graph = capture_forward(fwd, (eeg, spec))
        assert float((graph(eeg, spec) - fwd(eeg, spec)).abs().max()) <= 1e-6


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_duty_matches_plain(dev, co, k):
    rng = np.random.default_rng(co + k)
    w = torch.as_tensor(rng.standard_normal((co, k)),
                        dtype=torch.bfloat16).to(dev)
    p = torch.as_tensor(rng.standard_normal((k, 1024)) * 0.1,
                        dtype=torch.bfloat16).to(dev)
    n0 = cuda_duty.duty.launches
    got = cuda_duty.duty(w, p, 3)
    torch.cuda.synchronize()
    assert cuda_duty.duty.launches == n0 + 1
    assert got.shape == (co, 1024) and got.dtype == torch.float32
    assert _rel(got, cuda_duty._plain_duty(w, p, 3)) < 1e-4
    assert torch.equal(cuda_duty.duty(w, p, 0), torch.zeros_like(got))


@pytest.mark.parametrize("n", [128, 256, 16384])
@pytest.mark.parametrize("r", [0, 1, 3])
@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_duty_exact_on_integer_operands(dev, co, k, r, n):
    """bf16 integers in [-4, 4]: every product and sum is exact in float32
    (|sum| <= 3 * 16 * 384 < 2^24), so a layout, swizzle or descriptor
    mistake shows as an exact mismatch."""
    rng = np.random.default_rng(co * 7 + k + n + r)
    w = torch.as_tensor(rng.integers(-4, 5, (co, k)),
                        dtype=torch.bfloat16).to(dev)
    p = torch.as_tensor(rng.integers(-4, 5, (k, n)),
                        dtype=torch.bfloat16).to(dev)
    got = cuda_duty.duty(w, p, r)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_duty._plain_duty(w, p, r))


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_duty_layout_matches_wrapper(dev, co, k):
    assert cuda_duty.kernel_layout(co, k) == cuda_duty.smem_layout(co, k)


def test_duty_refuses_other_shapes(dev):
    w = torch.zeros((16, 144), dtype=torch.bfloat16, device=dev)
    n0 = cuda_duty.duty.launches
    with pytest.raises(ValueError):
        cuda_duty.duty(w, torch.zeros((144, 200), dtype=torch.bfloat16,
                                      device=dev), 1)
    with pytest.raises(ValueError):
        cuda_duty.duty(torch.zeros((32, 144), dtype=torch.bfloat16,
                                   device=dev), torch.zeros(
                           (144, 256), dtype=torch.bfloat16, device=dev), 1)
    assert cuda_duty.duty.launches == n0


# --- the training path -----------------------------------------------------------

def _train_pair(dev, batch=4):
    """The float32 training program on the card and on the CPU (same seeded
    weights), dropout off, and the batch the card preprocessed."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        preprocess_batch, train_entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        Dropout)
    step, st, raw = train_entry(device=dev, batch=batch, dtype=None)
    _, cst, _ = train_entry(device="cpu", batch=batch, dtype=None)
    for s in (st, cst):
        for m in s.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return step, st, cst, raw, preprocess_batch(*raw)


def test_train_step_matches_cpu(dev):
    """One float32 step (KLDiv + L2 1e-3, Adam) at full width, B=4, on the
    card against the CPU port on the same preprocessed batch, with
    chip_smoke's bounds (TRAIN_*, set above float32's own distance from
    float64 at this size): loss 1e-5 relative, gradient norm 1e-3, each
    gradient within 3e-2 of its tensor's max |g| plus 1e-6 of the model's
    largest (gradients zero in exact arithmetic are rounding noise on both
    sides), BatchNorm statistics 1e-4 of each tensor's max."""
    import copy

    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        make_train_step)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.steps import (
        loss_and_grads)
    _, st, cst, _, batch = _train_pair(dev)
    cbatch = {k: v.cpu() for k, v in batch.items()}
    _, _, g = loss_and_grads(copy.deepcopy(st.model), batch, None,
                             l2_lambda=1e-3)
    _, _, cg = loss_and_grads(copy.deepcopy(cst.model), cbatch, None,
                              l2_lambda=1e-3)
    top = max(float(w.abs().max()) for w in cg)
    for a, w in zip(g, cg):
        assert float((a.cpu() - w).abs().max()) <= \
            3e-2 * (float(w.abs().max()) + 1e-6 * top / 3e-2)
    inner = make_train_step(l2_lambda=1e-3)
    st, m = inner(st, batch)
    cst, cm = inner(cst, cbatch)
    assert not bool(m["nonfinite"])
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5 * abs(
        float(cm["loss"]))
    assert abs(float(m["grad_norm"]) - float(cm["grad_norm"])) <= 1e-3 * float(
        cm["grad_norm"])
    got = st.model.state_dict()
    for k, w in cst.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert float((got[k].cpu() - w).abs().max()) <= \
                1e-4 * float(w.abs().max()), k


def test_train_sentinel_on_card(dev):
    """A NaN window on the finite route: ``nonfinite``, the parameters,
    BatchNorm buffers and optimizer state bitwise unchanged, the step
    advanced; the IIR cascade launched once a step."""
    step, st, _, raw, _ = _train_pair(dev)
    st, m = step(st, *raw)
    assert not bool(m["nonfinite"])
    sd = {k: v.clone() for k, v in st.model.state_dict().items()}
    opt = {k: v.clone() for k, v in st.opt_state.items()}
    bad = raw[0].clone()
    bad[2, 11, 5000] = float("nan")
    n0 = cuda_iir.sosfilt_rolldec.launches
    st, m = step(st, bad, raw[1], raw[2])
    torch.cuda.synchronize()
    assert cuda_iir.sosfilt_rolldec.launches == n0 + 1
    assert bool(m["nonfinite"]) and st.step == 2
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in st.opt_state.items():
        assert torch.equal(v, opt[k]), k


@pytest.mark.parametrize("sync", [False, True])
def test_prefetch_to_device_pinned(dev, sync):
    """Batches staged through pinned buffers on a side stream arrive on the
    card, in order, equal to their sources; with ``sync_transfers`` the
    source may overwrite its buffer as soon as the next batch is asked
    for."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
        prefetch_to_device)
    buf = np.zeros((64, 20, 1000), np.float32)

    def source():
        for i in range(6):
            if sync:
                buf[...] = i
                yield {"x": buf, "i": i}
            else:
                yield {"x": np.full_like(buf, i), "i": i}

    seen = []
    for b in prefetch_to_device(source(), size=2, device=dev,
                                sync_transfers=sync):
        assert b["x"].device.type == "cuda"
        seen.append((b["i"], float(b["x"].float().mean())))
        torch.cuda.current_stream().synchronize()
    assert seen == [(i, float(i)) for i in range(6)]


def _mm_store(seed=0, u=5, b=6):
    rng = np.random.default_rng(seed)
    eeg = (rng.standard_normal((u, 20, 10_000)) * 40).astype(np.float32)
    lens = rng.integers(200, 400, u).astype(np.int64)
    buf = rng.random((int(lens.sum()), 400)).astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return eeg, buf, off, lens


def test_native_gather_into_pinned_buffers_feeds_prefetch(dev):
    """The host library gathers each batch into one of two pinned host
    buffers (numpy views of pinned tensors), and ``prefetch_to_device(
    sync_transfers=True)`` lands it on the card before the next gather
    overwrites the other slot: every batch on the card equals the numpy
    gather of its rows, bitwise."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
        prefetch_to_device)
    from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
        gather_multimodal, gather_multimodal_numpy)
    eeg, buf, off, lens = _mm_store()
    rng = np.random.default_rng(1)
    B = 6
    draws = [(rng.integers(0, 5, B), rng.integers(0, 5, B),
              rng.integers(0, 200, B)) for _ in range(5)]
    ring = [(torch.empty((B, 20, 10_000), pin_memory=True).numpy(),
             torch.empty((B, 400, 300), pin_memory=True).numpy())
            for _ in range(2)]

    def source():
        for k, (ei, si, crop) in enumerate(draws):
            e, s = gather_multimodal(eeg, ei, buf, off, lens, si, crop,
                                     out=ring[k % 2])
            yield {"eeg": e, "spec": s, "k": k}

    n = 0
    for b in prefetch_to_device(source(), device=dev, sync_transfers=True):
        ei, si, crop = draws[b["k"]]
        want = gather_multimodal_numpy(eeg, ei, buf, off, lens, si, crop)
        assert b["eeg"].device.type == "cuda"
        assert torch.equal(b["eeg"].cpu(), torch.from_numpy(want[0]))
        assert torch.equal(b["spec"].cpu(), torch.from_numpy(want[1]))
        n += 1
    assert n == len(draws)


def test_multimodal_source_ring_feeds_prefetch(dev, tmp_path):
    """``MultimodalSource.batches(reuse_buffers=True)`` (the host library
    into a two-slot ring) through ``prefetch_to_device(sync_transfers=
    True)``, the real-data training path's feed, from an in-memory window
    cache and ``.npy`` spectrograms (no pandas): every batch on the card
    equals the numpy gather's batch without reuse."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import data
    from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
        gather_multimodal_numpy)
    eeg, buf, off, lens = _mm_store(2)
    cache = data.EEGRecordCache("")
    for i in range(5):
        cache[100 + i] = eeg[i].T
        np.save(tmp_path / f"{200 + i}.npy", buf[off[i]:off[i] + lens[i]].T)
    rows = 14
    meta = data.ColumnTable({
        "eeg_id": 100 + np.arange(rows) % 5,
        "spectrogram_id": 200 + np.arange(rows) % 5,
        "spectrogram_label_offset_seconds": np.arange(rows) * 37.0,
        "expert_consensus": np.array([C.CLASSES[i % 6] for i in range(rows)],
                                     object)})
    src = data.MultimodalSource(meta, cache, data.SpectrogramStore(
        "", npy_dir=str(tmp_path)))
    kw = dict(shuffle=True, seed=3)
    want = list(src.batches(np.arange(rows), 4,
                            gather=gather_multimodal_numpy, **kw))
    got = list(data.prefetch_to_device(
        src.batches(np.arange(rows), 4, reuse_buffers=True, **kw),
        device=dev, sync_transfers=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("eeg", "spec", "y"):
            assert torch.equal(g[k].cpu(), torch.from_numpy(w[k])), k
