"""Conv-probe duty kernel (counterpart of ``make_duty`` in the JAX
package's ``bench.py`` conv probe) with its plain PyTorch version.

:func:`duty` computes ``out (co, N) f32 = Σ_{r<R} W (co, k) @ P (k, N)``
over bf16 operands with float32 accumulation, all R passes from on-chip
memory: the ceiling a fused spectrogram block could reach at that GEMM
shape, with no device-memory traffic inside the loop.  A CUDA tensor
launches ``duty_bf16`` (``csrc/duty.cu``, ``mma.sync`` on the tensor
cores); a CPU tensor takes :func:`_plain_duty`.  Launches are counted in
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
#: columns of P per CTA; N must be a multiple
N_TILE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/duty.cu``."""
    lib = _build.load("duty")
    lib.duty_bf16.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.duty_bf16.restype = _I
    lib.duty_smem_bytes.argtypes = [_I, _I]
    lib.duty_smem_bytes.restype = ctypes.c_longlong
    return lib


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
