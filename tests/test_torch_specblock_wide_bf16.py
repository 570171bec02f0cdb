"""The bf16 fused block at Cout 64/128/256, on the CPU.

On the card a bf16 call at these widths runs ``specblock_wide_bf16``
(``csrc/specblock.cu``): three launches of one implicit-GEMM conv on the
tensor cores.  Its arithmetic is held here by a float64 mirror: GEMM rows
in window-major order (a 2×2 pool window is 4 consecutive rows), conv1's
Cin zero-padded to a multiple of 32 by the wrapper's ``_pad_cin``, A
gathered as im2col over channel-pair words in the kernel's K-block order
(one tap's 16 words a block) against ``_pack_bf16_pairs``' words, then
bias + ReLU + bf16 rounding after every launch and the pool over 4
consecutive rows.  It is held against the port's plain bf16 chain
``_chain_convpool`` (max 1e-2, mean 1e-4 of the chain's max: both sum
exact bf16 products, in other orders, so a stage's bf16 rounding can flip
by one unit).

The port's plain version at the three wide widths is also held against
the JAX package's ``fused_specblock_convpool`` in Pallas interpret mode,
with the configuration of ``choose_fused_config``: bf16 at the bounds of
``tests/test_torch_specblock.py::test_plain_fused_matches_pallas_bf16``
(0.03 max, 0.003 mean of the float32 truth's max), float32 at rtol = atol
= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu.ops import (
    pallas_specblock as psb)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock as csb)

BF16 = torch.bfloat16
WIDE = [(32, 64, 16, 12), (64, 128, 8, 6), (128, 256, 8, 6)]


def _inputs(cin, cout, h, w, b=2, seed=0):
    """x ~ N(0, 1), He-scale weights (activations stay O(1) through fan-ins
    up to 2304), biases ~ N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, ci, cout)) * np.sqrt(2 / (9 * ci)))
          .astype(np.float32) for ci in (cin, cout, cout)]
    bs = [(rng.standard_normal(cout) * 0.1).astype(np.float32)
          for _ in range(3)]
    return x, ks, bs


def _window_major(b, h, w):
    """(B·H·W,) NHWC pixel index of GEMM row m: m = ((b·H/2 + wy)·W/2 +
    wx)·4 + 2·dy + dx is pixel (b, 2wy + dy, 2wx + dx)."""
    m = torch.arange(b * h * w)
    win, r = m // 4, m % 4
    wx, rest = win % (w // 2), win // (w // 2)
    wy, bi = rest % (h // 2), rest // (h // 2)
    return (bi * h + 2 * wy + r // 2) * w + 2 * wx + r % 2


def _conv_launch(act, k, bias, pix):
    """One launch: act (B, H, W, Cin) bf16 with Cin % 32 == 0 → GEMM rows
    (B·H·W, C) in window-major order, bias + ReLU, rounded to bf16."""
    b, h, w, cin = act.shape
    words = csb._pack_bf16_pairs(k)                          # (9·cin/2, C)
    rows, c = words.shape
    assert rows == 9 * cin // 2
    wmat = (words.view(BF16).reshape(rows, c, 2).permute(0, 2, 1)
            .reshape(2 * rows, c).double())                  # K in word order
    planes = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1)) \
        .contiguous().view(torch.int32)                      # pair words
    bi, rest = pix // (h * w), pix % (h * w)
    y, xx = rest // w, rest % w
    blocks = []
    for kb in range(9 * cin // 32):                          # K-blocks
        tap, cb = divmod(kb, cin // 32)
        blocks.append(planes[bi, y + tap // 3, xx + tap % 3,
                             16 * cb:16 * cb + 16])
    a = torch.cat(blocks, 1).contiguous().view(BF16).double()
    acc = a @ wmat + torch.as_tensor(bias).double()
    return acc.clamp_min(0).float().to(BF16)


def _mirror(x, ks, bs, pool):
    """The three launches of ``specblock_wide_bf16`` in float64."""
    b, h, w, _ = x.shape
    co = ks[0].shape[-1]
    pix = _window_major(b, h, w)
    xp, k1 = csb._pad_cin(torch.as_tensor(x).to(BF16), torch.as_tensor(ks[0]))
    act = xp
    for k, bias in zip((k1, ks[1]), bs[:2]):
        out = torch.empty((b * h * w, co), dtype=BF16)
        out[pix] = _conv_launch(act, torch.as_tensor(k), bias, pix)
        act = out.reshape(b, h, w, co)
    v = _conv_launch(act, torch.as_tensor(ks[2]), bs[2], pix).float()
    v = v.reshape(-1, 4, co)                       # one window a row group
    v = v.amax(1) if pool == "max" else v.sum(1) * 0.25
    return v.to(BF16).reshape(b, h // 2, w // 2, co)


@pytest.mark.parametrize("b,h,w", [(2, 16, 12), (1, 10, 6), (3, 4, 2)])
def test_window_major_order_visits_every_pixel_once(b, h, w):
    pix = _window_major(b, h, w)
    assert torch.equal(pix.sort().values, torch.arange(b * h * w))
    # four consecutive rows are one 2x2 window, and window m/4 is pooled
    # pixel m/4 in NHWC order
    y, x = (pix % (h * w)) // w, pix % w
    win = torch.arange(b * h * w) // 4
    assert torch.equal(((pix // (h * w)) * (h // 2) + y // 2) * (w // 2)
                       + x // 2, win)


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("cin,cout,h,w", WIDE + [(24, 64, 10, 6),
                                                 (5, 64, 4, 2)])
def test_mirror_matches_plain_bf16_chain(cin, cout, h, w, pool):
    x, ks, bs = _inputs(cin, cout, h, w, seed=cin + cout)
    got = _mirror(x, ks, bs, pool).float()
    want = csb._chain_convpool(
        torch.as_tensor(x), [torch.as_tensor(k) for k in ks],
        [torch.as_tensor(b) for b in bs], pool, BF16).float()
    assert got.shape == want.shape == (2, h // 2, w // 2, cout)
    err = (got - want).abs() / want.abs().max()
    assert float(err.max()) <= 1e-2, float(err.max())
    assert float(err.mean()) <= 1e-4, float(err.mean())


def test_pad_cin_keeps_conv1():
    """The zero channels _pad_cin adds meet zero weights: conv1 on the
    padded operands equals conv1 on the originals."""
    x, ks, _ = _inputs(5, 64, 4, 6)
    xp, k1 = csb._pad_cin(torch.as_tensor(x), torch.as_tensor(ks[0]))
    assert xp.shape[-1] == k1.shape[2] == 32
    conv = lambda a, k: torch.nn.functional.conv2d(
        a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(conv(xp, k1), conv(torch.as_tensor(x),
                                                  torch.as_tensor(ks[0])),
                               rtol=1e-6, atol=1e-6)
    same = torch.zeros(1, 2, 2, 64)
    assert csb._pad_cin(same, torch.as_tensor(ks[1]))[0] is same


def _jax(x, ks, bs, pool, dtype):
    h, w, co = x.shape[1], x.shape[2], ks[0].shape[-1]
    pack_w, hb = psb.choose_fused_config(h, w, co)
    out = psb.fused_specblock_convpool(
        jnp.asarray(x), [jnp.asarray(k) for k in ks],
        [jnp.asarray(b) for b in bs], pool=pool, pack_w=pack_w,
        strip_rows=hb, dtype=dtype, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, ks, bs, pool, dtype):
    return csb.fused_specblock_convpool(
        torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(b) for b in bs], pool=pool, dtype=dtype
    ).float().numpy()


@pytest.mark.parametrize("cin,cout,h,w,pool",
                         [s + (p,) for s, p in zip(WIDE,
                                                   ("max", "avg", "max"))])
def test_plain_wide_matches_pallas_bf16(cin, cout, h, w, pool):
    x, ks, bs = _inputs(cin, cout, h, w, seed=7)
    got = _port(x, ks, bs, pool, BF16)
    want = _jax(x, ks, bs, pool, jnp.bfloat16)
    truth = _jax(x, ks, bs, pool, jnp.float32)
    assert got.shape == want.shape == (2, h // 2, w // 2, cout)
    scale = float(np.abs(truth).max())
    for ref in (want, truth):
        err = np.abs(got - ref) / scale
        assert float(err.max()) < 0.03, float(err.max())
        assert float(err.mean()) < 0.003, float(err.mean())


def test_plain_wide_matches_pallas_f32():
    x, ks, bs = _inputs(32, 64, 16, 12, seed=8)
    got = _port(x, ks, bs, "max", torch.float32)
    want = _jax(x, ks, bs, "max", jnp.float32)
    assert got.shape == want.shape == (2, 8, 6, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
