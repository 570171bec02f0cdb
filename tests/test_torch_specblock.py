"""Fused spec-block parity: the port's plain PyTorch version (what a CPU
tensor takes in ``ops/cuda_specblock.py``) against the JAX package's
``fused_specblock_convpool`` in Pallas interpret mode, over the shapes of
tests/test_pallas_specblock.py, at its bounds."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from multimodal_brain_pattern_identification_xai_tpu.ops import (
    pallas_specblock as psb)
from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_specblock as csb)

SHAPES = [
    (4, "max", 3, 16, 16, 24, 2),     # block1 shape family, 4 strips
    (4, "max", 3, 16, 12, 16, 3),     # single pad-col block col count
    (2, "avg", 16, 8, 16, 12, 4),     # block2 shape family, 2 strips
    (2, "max", 5, 8, 8, 8, 2),        # odd cin, minimal dims
    (4, "avg", 3, 8, 8, 16, 4),       # one strip
    (4, "max", 3, 8, 8, 20, 2),       # W % (2·pack_w) ≠ 0 (like W=300)
]


def _inputs(seed, cin, cout, h, w):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, ci, cout)) * 0.2).astype(np.float32)
          for ci in (cin, cout, cout)]
    bs = [(rng.standard_normal(cout) * 0.1).astype(np.float32)
          for _ in range(3)]
    return x, ks, bs


def _both(x, ks, bs, pool, pack_w, hb, jdt, tdt):
    want = psb.fused_specblock_convpool(
        jnp.asarray(x), [jnp.asarray(k) for k in ks],
        [jnp.asarray(b) for b in bs], pool=pool, pack_w=pack_w,
        strip_rows=hb, dtype=jdt, interpret=True)
    got = csb.fused_specblock_convpool(
        torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(b) for b in bs], pool=pool, dtype=tdt)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("pack_w,pool,cin,cout,h,w,hb", SHAPES)
def test_plain_fused_matches_pallas_f32(pack_w, pool, cin, cout, h, w, hb):
    x, ks, bs = _inputs(42, cin, cout, h, w)
    want, got = _both(x, ks, bs, pool, pack_w, hb, jnp.float32,
                      torch.float32)
    assert got.shape == want.shape == (2, h // 2, w // 2, cout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pack_w,pool,cin,cout,h,w,hb",
                         [SHAPES[0], SHAPES[2]])
def test_plain_fused_matches_pallas_bf16(pack_w, pool, cin, cout, h, w, hb):
    """bf16 storage + f32 accumulation, compared at tensor scale (an
    element's relative error is unbounded where rounding flips a ReLU)."""
    x, ks, bs = _inputs(7, cin, cout, h, w)
    want, got = _both(x, ks, bs, pool, pack_w, hb, jnp.bfloat16,
                      torch.bfloat16)
    truth, _ = _both(x, ks, bs, pool, pack_w, hb, jnp.float32, torch.float32)
    scale = float(np.abs(truth).max())
    for ref in (want, truth):
        err = np.abs(got - ref) / scale
        assert float(err.max()) < 0.03, float(err.max())
        assert float(err.mean()) < 0.003, float(err.mean())


@pytest.mark.parametrize("cout", [8, 16, 32, 64])
def test_fused_applies_matches_choose_fused_config(cout):
    for h in range(1, 41):
        for w in range(1, 41):
            assert csb.fused_applies(h, w) == (
                psb.choose_fused_config(h, w, cout) is not None), (h, w)


def test_fused_backward_not_implemented():
    x, ks, bs = _inputs(0, 3, 8, 8, 8)
    xt = torch.from_numpy(x).requires_grad_()
    out = csb.fused_specblock_convpool(
        xt, [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(b) for b in bs], pool="max", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
