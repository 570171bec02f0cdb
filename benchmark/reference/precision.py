"""The precisions the reference runs in: float32 with TF32 off (the
reference); the precision a configuration states for each part (``at``);
and the control, one step below what a configuration states for each
part (``below``): for bfloat16, scaled fp8 (e4m3) rounding; for a float32
matmul or convolution, TF32 (the backends' setting, :func:`tf32`, and
operands rounded to TF32's 10-bit mantissa); for other float32 work
(the IIR chain, the z-score), bfloat16 rounding of its results."""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

FP8_MAX = 448.0                      # largest finite float8_e4m3fn


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(r: Callable[[torch.Tensor], torch.Tensor]):
    """The rounding ``r`` in the forward pass, the identity in the
    backward pass (the control's attributions differentiate through
    it)."""
    def q(x: torch.Tensor) -> torch.Tensor:
        if not x.requires_grad:
            return r(x)
        return x + (r(x.detach()) - x).detach()
    return q


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude maps to 448), returned in x's type."""
    if x.numel() == 0:
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def at(dtype_name: str, dense: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of a part computed in the precision stated for it:
    bfloat16 rounding for bfloat16; for float32, nothing for a matmul or
    convolution (the reference's own float32, TF32 off), float32 rounding
    of the float64 results elsewhere."""
    if dtype_name == "bfloat16":
        return _straight_through(bf16)
    return ident if dense else _straight_through(lambda x: x.float().to(x.dtype))


def below(dtype_name: str, dense: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The control's rounding for a part stated in ``dtype_name``: fp8 for
    bfloat16; for float32, TF32 where the part is a matmul or convolution
    (``dense``), bfloat16 elsewhere."""
    if dtype_name == "bfloat16":
        return _straight_through(fp8)
    return _straight_through(tf32_round if dense else bf16)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
