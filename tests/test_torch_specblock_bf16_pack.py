"""The bf16 fused block's packed operands, on the CPU.

``ops/cuda_specblock._pack_bf16_pairs`` packs an HWIO kernel into the
bf16x2 weight words that ``specblock_bf16_tc_kernel`` (``csrc/
specblock.cu``) stages in shared memory: row j = tap·cp + p, channel 2p in
the low half, 2p + 1 in the high half.  The kernel gathers its A fragments
from planes of channel-pair words, a pair row at an offset of
``(j % cp)·pitch + (tap // 3)·row + tap % 3`` words from an output
position (``pair_off`` and conv1's table there).  These tests hold the
packing against the HWIO kernel rounded to bf16, and an im2col product over
the packed words in that K order against ``F.conv2d`` on the same
bf16-rounded operands in float32 (1e-5: the product is exact in float64,
so only conv2d's float32 sums differ)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock as csb)

SHAPES = [(cin, c) for cin in (3, 5, 8, 16, 32) for c in (8, 16, 32)]


def _kernel(cin, c, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((3, 3, cin, c)) * 0.2,
                           dtype=torch.float32)


def _rows(cin):
    """Pair rows of a stage: 9 taps × ⌈cin/2⌉, padded to a multiple of 4
    (``bf16_rows`` in csrc/specblock.cu)."""
    return (9 * ((cin + 1) // 2) + 3) // 4 * 4


@pytest.mark.parametrize("cin,c", SHAPES)
def test_pack_round_trips_to_bf16_kernel(cin, c):
    k = _kernel(cin, c)
    words = csb._pack_bf16_pairs(k)
    cp, rows = (cin + 1) // 2, _rows(cin)
    assert words.dtype == torch.int32 and words.shape == (rows, c)
    assert words.is_contiguous()
    halves = words.view(torch.bfloat16).reshape(rows, c, 2)   # [j, co, half]
    got = (halves[:9 * cp].reshape(9, cp, c, 2).permute(0, 1, 3, 2)
           .reshape(9, 2 * cp, c))                           # [tap, ci, co]
    assert torch.equal(got[:, :cin], k.to(torch.bfloat16).reshape(9, cin, c))
    assert bool((got[:, cin:].view(torch.int16) == 0).all())  # pad channel
    assert bool((words[9 * cp:] == 0).all())                  # pad rows


@pytest.mark.parametrize("cin,c", SHAPES)
def test_packed_im2col_matches_conv2d(cin, c):
    """y[m] = Σ_j A[m, j] · W[j] over the packed words, with A gathered as
    the kernel gathers it: from SAME-padded planes of channel-pair words
    (plane pitch above the plane's size, as in shared memory), at the
    position's word plus the pair row's offset; pad rows read offset 0 and
    meet zero weights."""
    b, h, w = 2, 7, 9
    rng = np.random.default_rng(cin * 100 + c)
    x = torch.as_tensor(rng.standard_normal((b, h, w, cin)),
                        dtype=torch.float32).to(torch.bfloat16)
    k = _kernel(cin, c, seed=1)
    cp, rows = (cin + 1) // 2, _rows(cin)
    row = w + 2
    pitch = (h + 2) * row + 3
    xp = F.pad(x, (0, 2 * cp - cin, 1, 1, 1, 1))   # zero channel, SAME halo
    planes = (xp.reshape(b, h + 2, w + 2, cp, 2).contiguous()
              .view(torch.int32).reshape(b, (h + 2) * row, cp)
              .permute(0, 2, 1))
    flat = F.pad(planes, (0, pitch - (h + 2) * row)).reshape(b, cp * pitch)
    j = torch.arange(rows)
    tap = j // cp
    off = torch.where(j < 9 * cp, (j % cp) * pitch + (tap // 3) * row
                      + tap % 3, 0)
    oy, ox = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    pos = (oy * row + ox).reshape(-1)
    a_words = flat[:, pos[:, None] + off[None, :]]           # (b, M, rows)
    a = a_words.contiguous().view(torch.bfloat16).double().reshape(
        b, h * w, 2 * rows)
    wm = (csb._pack_bf16_pairs(k).view(torch.bfloat16).reshape(rows, c, 2)
          .permute(0, 2, 1).reshape(2 * rows, c).double())
    got = (a @ wm).reshape(b, h, w, c).float()
    want = F.conv2d(x.float().permute(0, 3, 1, 2),
                    k.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
