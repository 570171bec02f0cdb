"""The conv probe's duty function: the port's plain version (what a CPU
tensor takes in ``ops/cuda_duty.py``) against the expression the JAX
bench's ``duty_kernel`` computes (bench.py:1114-1121: ``acc += jnp.dot(W,
P, preferred_element_type=f32)`` R times in a ``fori_loop``), written out
here because ``make_duty`` is a closure inside ``bench_convprobe``.  Bound:
rtol 1e-5 — bf16 products are exact in float32, so only the order of the
float32 sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
    cuda_duty)

N, R = 256, 3


def _jax_duty(w, p, r):
    def body(_, acc):
        return acc + jnp.dot(w, p, preferred_element_type=jnp.float32)
    return jax.lax.fori_loop(0, r, body,
                             jnp.zeros((w.shape[0], p.shape[1]), jnp.float32))


def _operands(co, k, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((co, k)).astype(np.float32)
    p = (rng.standard_normal((k, N)) * 0.1).astype(np.float32)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    return to_bf16(w), to_bf16(p)


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_plain_duty_matches_jax_duty_kernel(co, k):
    w, p = _operands(co, k)
    want = np.asarray(_jax_duty(_jnp(w), _jnp(p), R))
    got = cuda_duty._plain_duty(w, p, R)
    assert got.dtype == torch.float32 and got.shape == (co, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_cpu_wrapper_takes_plain_version(co, k):
    w, p = _operands(co, k, seed=1)
    n0 = cuda_duty.duty.launches
    assert torch.equal(cuda_duty.duty(w, p, R), cuda_duty._plain_duty(w, p, R))
    assert torch.equal(cuda_duty.duty(w, p, 0), torch.zeros((co, N)))
    assert cuda_duty.duty.launches == n0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Argument checks of the CUDA path, run on meta tensors (no card)."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                     device="meta")
    for w, p, r, err in [
            (meta(16, 144), meta(144, 256), 2, None),
            (meta(16, 144, dt=torch.float32), meta(144, 256), 2, TypeError),
            (meta(32, 144), meta(144, 256), 2, ValueError),     # co
            (meta(16, 144), meta(144, 200), 2, ValueError),     # N % 128
            (meta(16, 144), meta(128, 256), 2, ValueError),     # k mismatch
            (meta(16, 144), meta(144, 256), -1, ValueError)]:
        with pytest.raises(err or ValueError, match=None if err else "CUDA"):
            cuda_duty._check_cuda_args(w, p, r)
