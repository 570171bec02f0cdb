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


# --- the kernel's shared-memory layout, rehearsed with numpy ---------------

def _swizzle(addr, width):
    """The wgmma swizzle of ``width`` bytes on absolute shared addresses:
    bits [4, 4+b) XOR bits [7, 7+b), b = log2(width / 16)."""
    b = {0: 0, 32: 1, 64: 2, 128: 3}[width]
    return addr ^ ((addr >> 3) & (((1 << b) - 1) << 4))


def _stage(lay, w, p_tile):
    """Shared memory as the kernel stages it (``csrc/duty.cu``), from a
    1024-aligned base: P's 16-byte chunk c of row kr into warpgroup c // 8's
    tile, chunk (c % 8) ^ (kr % 8); W's chunk q of row ch into slab q // 2,
    half (q % 2) ^ ((ch // 4) % 2).  bf16 values as uint16."""
    mem = np.zeros(lay["smem_bytes"], np.uint8)
    k, n_tile = p_tile.shape
    for kr in range(k):
        for c in range(n_tile // 8):
            off = (c // 8) * lay["a_tile"] + kr * lay["a_pitch"] + (
                ((c % 8) ^ (kr % 8)) << 4)
            mem[off:off + 16] = p_tile[kr, 8 * c:8 * c + 8].view(np.uint8)
    co = w.shape[0]
    for ch in range(co):
        for q in range(k // 8):
            off = (lay["b_offset"] + (q // 2) * lay["b_kstep"]
                   + (ch // 8) * lay["b_sbo"] + ch % 8 * (lay["b_pitch"]
                                                          + lay["b_pad"])
                   + (((q % 2) ^ ((ch // 4) % 2)) << 4))
            mem[off:off + 16] = w[ch, 8 * q:8 * q + 8].view(np.uint8)
    return mem


def _read_mn_major(mem, start, lbo, sbo, width, rows):
    """An MN-major operand (rows × 16 k) through its descriptor: ``width``
    bytes of consecutive rows a line, 8 lines of k an atom, SBO between
    8-deep k groups, LBO between groups of width / 2 rows."""
    m, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    per = width // 2
    addr = (start + (m // per) * lbo + (kk // 8) * sbo + (kk % 8) * width
            + (m % per) * 2)
    return _gather(mem, _swizzle(addr, width))


def _read_k_major(mem, start, sbo, width, rows):
    """A K-major operand (rows × 16 k) through its descriptor: rows of
    ``width`` bytes, 8 rows an atom, SBO between 8-row groups; one k16 step
    is 32 contiguous bytes of a row (LBO is not read)."""
    n, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    addr = start + (n // 8) * sbo + (n % 8) * width + kk * 2
    return _gather(mem, _swizzle(addr, width))


def _gather(mem, addr):
    assert int(addr.max()) + 2 <= mem.size and not (addr % 2).any()
    return mem[addr] | (mem[addr + 1].astype(np.uint16) << 8)


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_smem_layout_staging_reads_back_through_descriptors(co, k):
    """Stage W and one CTA's P tile by :func:`cuda_duty.smem_layout`, then
    read every k16 step back through the wgmma canonical layouts at the
    descriptors' addresses, offsets and swizzles: warpgroup g's A is Pᵀ's
    rows 64g..64g+63, B is Wᵀ (as co × 16 rows), exactly."""
    lay = cuda_duty.smem_layout(co, k)
    assert lay["b_pad"] == 0 and lay["a_swizzle"] == 128
    assert lay["a_pitch"] == lay["a_swizzle"]          # 64 columns a line
    assert lay["b_pitch"] == lay["b_swizzle"] == 32    # one k16 slab a line
    rng = np.random.default_rng(co * 1000 + k)
    n_tile = lay["n_tile"]
    p_tile = rng.integers(0, 2 ** 16, (k, n_tile), dtype=np.uint16)
    w = rng.integers(0, 2 ** 16, (co, k), dtype=np.uint16)
    mem = _stage(lay, w, p_tile)
    # every staged byte lies in its region, tiles on the swizzles' repeats
    assert lay["b_offset"] + co * k * 2 + 1024 == lay["smem_bytes"] <= 232448
    assert lay["a_tile"] % 1024 == 0 and lay["b_offset"] % 1024 == 0
    assert lay["b_kstep"] % 256 == 0 and lay["a_kstep"] % 1024 == 0
    for g in range(lay["warpgroups"]):
        for s in range(k // 16):
            a = _read_mn_major(mem, g * lay["a_tile"] + s * lay["a_kstep"],
                               lay["a_lbo"], lay["a_sbo"], 128, 64)
            np.testing.assert_array_equal(
                a, p_tile[16 * s:16 * s + 16, 64 * g:64 * g + 64].T)
    for s in range(k // 16):
        b = _read_k_major(mem, lay["b_offset"] + s * lay["b_kstep"],
                          lay["b_sbo"], 32, co)
        np.testing.assert_array_equal(b, w[:, 16 * s:16 * s + 16])


@pytest.mark.parametrize("co,k", cuda_duty.SHAPES)
def test_smem_layout_descriptor_fields(co, k):
    """The descriptors' constant bits hold LBO and SBO >> 4 in 14 bits and
    the swizzle codes (1: 128-byte, 3: 32-byte); every start address a
    k16 step reaches stays 16-byte aligned inside the allocation."""
    lay = cuda_duty.smem_layout(co, k)
    for op, code in (("a", 1), ("b", 3)):
        d = lay[f"{op}_desc"]
        assert d & 0x3FFF == 0 and d >> 62 == code
        assert (d >> 16) & 0x3FFF == lay[f"{op}_lbo"] >> 4
        assert (d >> 32) & 0x3FFF == lay[f"{op}_sbo"] >> 4
        assert lay[f"{op}_lbo"] >> 4 < 2 ** 14 and lay[f"{op}_sbo"] % 16 == 0
    last = (lay["b_offset"] + (k // 16 - 1) * lay["b_kstep"]) >> 4
    assert last < 2 ** 14 and lay["smem_bytes"] >> 4 < 2 ** 14
    with pytest.raises(ValueError):
        cuda_duty.smem_layout(co + 1, k)
