"""The float32 fused block at Cout 64/128/256, on the CPU.

On the card a float32 call at these widths runs ``specblock_wide_f32``
(``csrc/specblock.cu``): three launches of one 3xTF32 implicit-GEMM conv
on the tensor cores.  Its arithmetic is held here by a float64 mirror:
GEMM rows in window-major order (a 2×2 pool window is 4 consecutive rows),
conv1's Cin zero-padded to a multiple of 32 by the wrapper's ``_pad_cin``,
A gathered as im2col in the kernel's K-block order (one tap's 16 channels
a block) against the HWIO weights' rows, each operand split into tf32
hi = tf32(v) and lo = tf32(v − hi) with ``cvt.rna.tf32.f32`` emulated on
the float32 bits, the three products hi·hi + lo·hi + hi·lo (lo·lo left
out), bias + ReLU after every launch with t1, t2 stored as float32, and
the pool over 4 consecutive rows.  It is held against the port's plain
float32 chain ``_chain_convpool`` at rtol = atol = 1e-5, the bound of the
JAX package's f32 kernel tests; the same mirror without its lo terms (one
tf32 product, ~2^-11 relative) misses that bound, so the bound bites."""

import pytest
import torch
import torch.nn.functional as F

from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock as csb)
from test_torch_specblock_wide_bf16 import WIDE, _inputs, _window_major


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 → the tf32 value ``cvt.rna.tf32.f32`` gives: round to
    nearest, ties away from zero, on the float32 bits (the low 13 mantissa
    bits cleared)."""
    u = t.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32) \
        .view(torch.float32)


def _split(v: torch.Tensor):
    hi = _tf32(v)
    return hi.double(), _tf32(v - hi).double()


def _conv_launch(act, k, bias, pix, lo_terms=True):
    """One launch: act (B, H, W, Cin) float32 with Cin % 16 == 0 → GEMM
    rows (B·H·W, C) in window-major order, 3xTF32 products summed in
    float64, bias + ReLU, stored as float32."""
    b, h, w, cin = act.shape
    c = k.shape[-1]
    wmat = k.reshape(9 * cin, c)                    # row tap·Cin + ci
    planes = F.pad(act, (0, 0, 1, 1, 1, 1))
    bi, rest = pix // (h * w), pix % (h * w)
    y, xx = rest // w, rest % w
    blocks = []
    for kb in range(9 * cin // 16):                 # K-blocks of 16 channels
        tap, cb = divmod(kb, cin // 16)
        blocks.append(planes[bi, y + tap // 3, xx + tap % 3,
                             16 * cb:16 * cb + 16])
    ah, al = _split(torch.cat(blocks, 1))
    bh, bl = _split(wmat)
    acc = ah @ bh
    if lo_terms:
        acc = acc + (al @ bh + ah @ bl)
    return (acc + torch.as_tensor(bias).double()).clamp_min(0).float()


def _mirror(x, ks, bs, pool, lo_terms=True):
    """The three launches of ``specblock_wide_f32`` in float64."""
    b, h, w, _ = x.shape
    co = ks[0].shape[-1]
    pix = _window_major(b, h, w)
    act, k1 = csb._pad_cin(torch.as_tensor(x), torch.as_tensor(ks[0]))
    for k, bias in zip((k1, torch.as_tensor(ks[1])), bs[:2]):
        out = torch.empty((b * h * w, co))
        out[pix] = _conv_launch(act, k, bias, pix, lo_terms)
        act = out.reshape(b, h, w, co)
    v = _conv_launch(act, torch.as_tensor(ks[2]), bs[2], pix, lo_terms)
    v = v.reshape(-1, 4, co)                        # one window a row group
    v = v.amax(1) if pool == "max" else v.sum(1) * 0.25
    return v.reshape(b, h // 2, w // 2, co)


def _plain(x, ks, bs, pool):
    return csb._chain_convpool(
        torch.as_tensor(x), [torch.as_tensor(k) for k in ks],
        [torch.as_tensor(b) for b in bs], pool, torch.float32)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                          # one tf32 unit above 1
    v = torch.tensor([1.0 + 2.0 ** -11,             # a tie: away, up
                      -(1.0 + 2.0 ** -11),          # a tie: away, down
                      1.0 + 2.0 ** -11 - 2.0 ** -23,  # below the tie
                      3.0, 0.0])
    want = torch.tensor([one, -one, 1.0, 3.0, 0.0])
    assert torch.equal(_tf32(v), want)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 100
    t = _tf32(r)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - t).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("cin,cout,h,w,b", [s + (2,) for s in WIDE] + [
    (24, 64, 10, 6, 2), (5, 64, 4, 2, 2), (32, 64, 10, 6, 1)])
def test_mirror_matches_plain_f32_chain(cin, cout, h, w, b, pool):
    x, ks, bs = _inputs(cin, cout, h, w, b=b, seed=cin + cout + b)
    got = _mirror(x, ks, bs, pool)
    want = _plain(x, ks, bs, pool)
    assert got.shape == want.shape == (b, h // 2, w // 2, cout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout,h,w", WIDE)
def test_mirror_without_lo_terms_misses_the_bound(cin, cout, h, w):
    """One tf32 product (hi·hi alone) errs by ~2^-11 of each product: the
    f32 bound catches it at every width."""
    x, ks, bs = _inputs(cin, cout, h, w, seed=cin + cout + 2)
    got = _mirror(x, ks, bs, "max", lo_terms=False)
    want = _plain(x, ks, bs, "max")
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
