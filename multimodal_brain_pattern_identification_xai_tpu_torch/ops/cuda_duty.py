"""Conv-probe duty kernel (counterpart of ``make_duty`` in the JAX
package's ``bench.py`` conv probe) with its plain PyTorch version.

:func:`duty` computes ``out (co, N) f32 = Σ_{r<R} W (co, k) @ P (k, N)``
over bf16 operands with float32 accumulation, all R passes from on-chip
memory: the ceiling a fused spectrogram block could reach at that GEMM
shape, with no device-memory traffic inside the loop.  A CUDA tensor
launches ``duty_bf16`` (``csrc/duty.cu``: a ``wgmma`` loop over
shared-memory descriptors, computing ``outᵀ = Pᵀ · Wᵀ`` so that 64
columns of P fill wgmma's M); a CPU tensor takes :func:`_plain_duty`.
:func:`smem_layout` states the kernel's shared-memory layout, which the
kernel exports too (``duty_layout``), so that the CPU tests can rehearse
its staging and its descriptors' reads.  Launches are counted in
``duty.launches``.  Used by the conv probe only (``scripts/
torch_convprobe.py``), not by the serving or XAI paths.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: the probe's (co, k) shapes the kernel is instantiated for: the im2col
#: block-2 GEMM, the 2×2 and 2×4 phase-packed GEMMs, block 1's 2×2 pack
SHAPES = ((16, 144), (64, 256), (128, 384), (64, 48))
#: columns of P per CTA (two warpgroups of 64); N must be a multiple
N_TILE = 128
#: the fields of :func:`smem_layout`, in the order ``duty_layout`` writes them
LAYOUT_KEYS = ("warpgroups", "n_tile", "a_swizzle", "a_pitch", "a_tile",
               "a_lbo", "a_sbo", "a_kstep", "a_desc", "b_offset", "b_swizzle",
               "b_pitch", "b_pad", "b_lbo", "b_sbo", "b_kstep", "b_desc",
               "smem_bytes")
#: swizzle width in bytes → the descriptor's layout code (bits 62-63)
_SWIZZLE_CODE = {0: 0, 128: 1, 64: 2, 32: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/duty.cu``."""
    lib = _build.load("duty")
    lib.duty_bf16.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.duty_bf16.restype = _I
    lib.duty_layout.argtypes = [_I, _I, _P, _I]
    lib.duty_layout.restype = _I
    return lib


def descriptor_bits(lbo: int, sbo: int, swizzle: int) -> int:
    """A wgmma shared-memory descriptor's bits besides the start address:
    LBO >> 4 at bit 16, SBO >> 4 at bit 32 (14 bits each), the swizzle's
    code (``swizzle`` in bytes, 0 for none) at bit 62."""
    return ((((lbo >> 4) & 0x3FFF) << 16) | (((sbo >> 4) & 0x3FFF) << 32)
            | (_SWIZZLE_CODE[swizzle] << 62))


def smem_layout(co: int, k: int) -> dict:
    """The duty kernel's shared-memory layout for ``(co, k)``, in bytes.

    ``a_*``: each warpgroup's P tile (k rows of 64 columns; MN-major,
    128-byte swizzle, tiles ``a_tile`` apart from offset 0); ``b_*``: W,
    K-major in the 32-byte swizzle, one slab of ``co`` rows × 16 k per k16
    step from ``b_offset``, ``b_pad`` bytes of padding per row (none).
    ``*_lbo`` / ``*_sbo`` are the descriptors' leading and stride byte
    offsets, ``*_kstep`` what a k16 step adds to a descriptor's address,
    ``*_desc`` the descriptors' bits besides the address, ``smem_bytes`` the
    dynamic allocation (1024 bytes of it to align the base).
    """
    if (co, k) not in SHAPES:
        raise ValueError(f"the duty kernel takes (co, k) in {SHAPES}, got "
                         f"{(co, k)}")
    wg, a_pitch, b_pitch = N_TILE // 64, 128, 32
    a_tile = k * a_pitch
    lay = dict(warpgroups=wg, n_tile=N_TILE, a_swizzle=128, a_pitch=a_pitch,
               a_tile=a_tile, a_lbo=a_tile, a_sbo=8 * a_pitch,
               a_kstep=16 * a_pitch, b_offset=wg * a_tile, b_swizzle=32,
               b_pitch=b_pitch, b_pad=0, b_lbo=16, b_sbo=8 * b_pitch,
               b_kstep=co * b_pitch)
    lay["a_desc"] = descriptor_bits(lay["a_lbo"], lay["a_sbo"], 128)
    lay["b_desc"] = descriptor_bits(lay["b_lbo"], lay["b_sbo"], 32)
    lay["smem_bytes"] = lay["b_offset"] + co * k * 2 + 1024
    return {key: lay[key] for key in LAYOUT_KEYS}


def kernel_layout(co: int, k: int) -> dict:
    """The layout the built kernel reports (``duty_layout``), keyed as
    :func:`smem_layout`; builds the kernel at first use."""
    vals = (ctypes.c_ulonglong * len(LAYOUT_KEYS))()
    got = _lib().duty_layout(co, k, ctypes.addressof(vals), len(vals))
    if got != len(LAYOUT_KEYS):
        raise RuntimeError(f"duty_layout({co}, {k}) returned {got} fields, "
                           f"expected {len(LAYOUT_KEYS)}")
    return dict(zip(LAYOUT_KEYS, (int(v) for v in vals)))


def _plain_duty(w: torch.Tensor, p: torch.Tensor, r: int) -> torch.Tensor:
    """The plain PyTorch version: ``R · (W @ P)`` in float32."""
    return r * (w.float() @ p.float())


def _check_cuda_args(w: torch.Tensor, p: torch.Tensor, r: int) -> None:
    if w.dtype != torch.bfloat16 or p.dtype != torch.bfloat16:
        raise TypeError(f"the duty kernel takes bf16, got {w.dtype}, {p.dtype}")
    if w.dim() != 2 or p.dim() != 2 or w.shape[1] != p.shape[0]:
        raise ValueError(f"need W (co, k) and P (k, N), got {tuple(w.shape)} "
                         f"and {tuple(p.shape)}")
    if tuple(w.shape) not in SHAPES:
        raise ValueError(f"the duty kernel takes (co, k) in {SHAPES}, got "
                         f"{tuple(w.shape)}")
    n = p.shape[1]
    if n < N_TILE or n % N_TILE or not 0 <= r < 2 ** 31:
        raise ValueError(f"need N a multiple of {N_TILE} and 0 <= R < 2^31, "
                         f"got N={n}, R={r}")
    if not (w.is_cuda and p.is_cuda) or w.device != p.device:
        raise ValueError(f"expected W and P on one CPU or CUDA device, got "
                         f"{w.device} and {p.device}")


def duty(w: torch.Tensor, p: torch.Tensor, r: int) -> torch.Tensor:
    """``Σ_{r<R} W @ P``: W (co, k) and P (k, N) bf16 → (co, N) float32."""
    if w.device.type == "cpu" and p.device.type == "cpu":
        return _plain_duty(w, p, r)
    _check_cuda_args(w, p, r)
    # the kernel copies 16 bytes at a time: contiguous, 16-byte aligned
    w, p = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (w, p))
    co, k = w.shape
    n = p.shape[1]
    out = torch.empty((co, n), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        rc = _lib().duty_bf16(w.data_ptr(), p.data_ptr(), out.data_ptr(), co,
                              k, n, r,
                              torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "duty_bf16")
    duty.launches += 1
    return out


duty.launches = 0
