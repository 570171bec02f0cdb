"""Fused spec-block parity: the port's plain PyTorch version (what a CPU
tensor takes in ``ops/cuda_specblock.py``) against the JAX package's
``fused_specblock_convpool`` in Pallas interpret mode, over the shapes of
tests/test_pallas_specblock.py, at its bounds; and the fused block's
backward against the JAX package's custom VJP (gradients 2e-4, the bound
of tests/test_pallas_specblock.py:110)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import xai as jxai
from multimodal_brain_pattern_identification_xai_tpu.ops import (
    pallas_specblock as psb)
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import xai as txai
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


def _grads_port(x, ks, bs, g, pool, dtype):
    args = [torch.from_numpy(a).requires_grad_() for a in (x, *ks, *bs)]
    out = csb.fused_specblock_convpool(args[0], args[1:4], args[4:7],
                                       pool=pool, dtype=dtype)
    return torch.autograd.grad(out, args, torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_fused_backward_matches_pallas_vjp(pool):
    """Gradients w.r.t. x, the three HWIO kernels and the three biases
    against ``fused_specblock_convpool_vjp`` (interpret, f32)."""
    x, ks, bs = _inputs(11, 3, 8, 8, 16)
    g = np.random.default_rng(12).standard_normal(
        (2, 4, 8, 8)).astype(np.float32)

    def loss(xx, kk, bb):
        out = psb.fused_specblock_convpool_vjp(
            xx, kk, bb, pool=pool, pack_w=4, strip_rows=2,
            dtype=jnp.float32, interpret=True)
        return jnp.sum(out * g)

    jx, jk, jb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), tuple(map(jnp.asarray, ks)),
        tuple(map(jnp.asarray, bs)))
    got = _grads_port(x, ks, bs, g, pool, torch.float32)
    for a, w in zip(got, (jx, *jk, *jb)):
        assert tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_fused_backward_bf16_equals_chain_autograd(pool):
    """In bf16 the backward is exactly autograd of ``_chain_convpool`` at
    the saved primals (the JAX design: the VJP of the unfused chain)."""
    x, ks, bs = _inputs(13, 16, 8, 8, 12)
    g = np.random.default_rng(14).standard_normal(
        (2, 4, 6, 8)).astype(np.float32)
    n0 = csb.fused_specblock_convpool.backward_calls
    got = _grads_port(x, ks, bs, g, pool, torch.bfloat16)
    assert csb.fused_specblock_convpool.backward_calls == n0 + 1
    args = [torch.from_numpy(a).requires_grad_() for a in (x, *ks, *bs)]
    out = csb._chain_convpool(args[0], args[1:4], args[4:7], pool,
                              torch.bfloat16)
    want = torch.autograd.grad(out, args,
                               torch.from_numpy(g).to(torch.bfloat16))
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, w)


def test_fused_backward_skips_frozen_inputs():
    """Only the inputs that require a gradient get one (frozen weights,
    as in attribution, cost no weight gradients)."""
    x, ks, bs = _inputs(15, 3, 8, 8, 8)
    xt = torch.from_numpy(x).requires_grad_()
    out = csb.fused_specblock_convpool(
        xt, [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(b) for b in bs], pool="max", dtype=torch.float32)
    gx, = torch.autograd.grad(out.sum(), xt)
    assert gx.shape == xt.shape and float(gx.abs().max()) > 0


def _speccnn_variables(seed):
    """Flax variables of the port's seeded weights (N(0, 1/fan_in): an
    unsaturated log-softmax, so input gradients are not vanishingly
    small)."""
    sd = tm.seeded_state_dict(tm.SpectrogramCNN(), seed)
    model = jm.SpectrogramCNN()
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 48)))
    v = jm.load_torch_speccnn_state_dict(sd, v)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _port_speccnn(variables, fused_blocks):
    m = tm.SpectrogramCNN(fused_blocks=fused_blocks)
    m.load_state_dict(tm.jax_variables_to_state_dict(variables))
    return m.eval()


def test_fused_model_input_gradient_matches_unfused():
    """Saliency-style input gradients through the port's fused-serving
    SpectrogramCNN equal the unfused model's (f32; the port's counterpart
    of tests/test_pallas_specblock.py:113-132)."""
    v = _speccnn_variables(21)
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 64, 48)).astype(np.float32)

    def sal(model):
        xt = torch.from_numpy(x).requires_grad_()
        g, = torch.autograd.grad(model(xt)[:, 1].sum(), xt)
        return g.numpy()

    fused = _port_speccnn(v, 2)
    n0 = csb.fused_specblock_convpool.backward_calls
    got = sal(fused)
    assert csb.fused_specblock_convpool.backward_calls == n0 + 2
    np.testing.assert_allclose(got, sal(_port_speccnn(v, 0)), rtol=2e-4,
                               atol=2e-4)


def test_fused_saliency_matches_jax_fused():
    """The port's fused-model saliency against the JAX package's
    fused-model saliency (Pallas interpret, custom VJP) at 64×48.  Bound:
    rtol 1e-3 (tests/test_xai.py:229) with an absolute floor of 1e-5 of
    the map's maximum for elements near zero."""
    v = _speccnn_variables(22)
    x = np.random.default_rng(6).standard_normal(
        (2, 3, 64, 48)).astype(np.float32)
    jmodel = jm.SpectrogramCNN(fused_blocks=2, fused_interpret=True)
    want = np.asarray(jxai.saliency_maps(
        lambda xx: jmodel.apply(v, xx), jnp.asarray(x)))
    got = txai.saliency_maps(_port_speccnn(v, 2), torch.from_numpy(x))
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-5 * float(np.abs(want).max()))
