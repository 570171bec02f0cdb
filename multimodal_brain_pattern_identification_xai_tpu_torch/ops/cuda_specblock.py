"""Fused spectrogram-block kernel (counterpart of the JAX package's
``ops/pallas_specblock.py``) with its plain PyTorch version.

:func:`fused_specblock_convpool` computes, on NHWC input, three 3×3 SAME
convs with bias and ReLU (Cin→C, C→C, C→C) and then a 2×2 stride-2 VALID
max or avg pool, each stage stored in ``dtype`` (float32, or bf16 with
float32 accumulation).  A CUDA tensor launches a kernel of
``csrc/specblock.cu``; a CPU tensor takes :func:`_plain_convpool`
(``F.conv2d`` ×3 + pool).  For Cout 8/16/32 both types run
``specblock_convpool`` on the tensor cores, intermediates in shared
memory: float32 as a 3xTF32 implicit GEMM, bf16 as a bf16 implicit GEMM
whose weights :func:`_pack_bf16_pairs` packs into channel-pair words.  For
Cout 64/128/256 a call is three device launches of one implicit-GEMM conv
on the tensor cores, the two intermediates in device scratch, the pool in
the third launch, with Cin zero-padded to a multiple of 32 by
:func:`_pad_cin`: bf16 runs ``specblock_wide_bf16`` (the same packed
words), float32 ``specblock_wide_f32`` (3xTF32 over the HWIO weights as
they are).  Launches are counted per call in
``fused_specblock_convpool.launches``, and by kernel (:func:`kernel_name`)
in ``fused_specblock_convpool.kernel_launches``.

The function is differentiable, with the JAX package's custom VJP
(``_fused_vjp_bwd``): the forward saves its primals, and the backward
recomputes :func:`_chain_convpool` (the same function as unfused stock ops,
cuDNN on the card) from them and returns that chain's autograd.  As in the
JAX package, no backward kernel is written: the Pallas kernel had none.
Backward calls are counted in ``fused_specblock_convpool.backward_calls``.

:func:`whole_block_bf16` serves a whole bf16 ``SpectrogramBlock`` in eval
mode at Cout 8/16/32 in one launch of the bf16 kernel: conv×3 + pool,
then the block's eval BatchNorm, its 2×2 skip (the bilinear resize by ½,
the 1×1 conv) and the residual add in the kernel's epilogue, with x read
in whatever layout it has.  It is CUDA-only and not differentiable: the
module takes it only where autograd does not record (its plain version is
the module's own stock ops).  Counted in ``fused_specblock_convpool
.launches`` and under :data:`WHOLE_KERNEL` in ``kernel_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _build

#: output widths with a kernel instantiation: 8/16/32 on the 16×16-tile
#: kernels, :data:`WIDE_COUTS` on the wide kernel
KERNEL_COUTS = (8, 16, 32, 64, 128, 256)
WIDE_COUTS = (64, 128, 256)
#: output widths :func:`whole_block_bf16` takes
WHOLE_COUTS = (8, 16, 32)
#: ``kernel_launches`` key of :func:`whole_block_bf16`
WHOLE_KERNEL = "specblock_convpool_whole_bf16"
#: conv1's Cin of a wide call is padded to a multiple of this: the bf16
#: wide conv's K-block (one tap's 16 pair words), twice the f32 one's 16
WIDE_K_CHANNELS = 32
#: the wide convs' GEMM rows B·H·W stay below 2³¹ − 128 (int indices);
#: the 16×16-tile kernels take any batch (above 65,535 in slices)
MAX_WIDE_PIXELS = 2 ** 31 - 129

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/specblock.cu``."""
    lib = _build.load("specblock")
    lib.specblock_convpool.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.specblock_convpool.restype = _I
    lib.specblock_whole_bf16.argtypes = ([_P] + [ctypes.c_longlong] * 4
                                         + [_P] * 11 + [_I] * 6 + [_P])
    lib.specblock_whole_bf16.restype = _I
    for name in ("specblock_wide_bf16", "specblock_wide_f32"):
        getattr(lib, name).argtypes = [_P] * 8 + [_I] * 6 + [_P]
        getattr(lib, name).restype = _I
    lib.specblock_smem_bytes.argtypes = [_I, _I, _I]
    lib.specblock_smem_bytes.restype = ctypes.c_longlong
    return lib


def fused_applies(h: int, w: int) -> bool:
    """Whether the fused block takes an (h, w) plane: the applicability
    rule of the JAX package's ``choose_fused_config`` (2×2 pool windows
    must tile the plane: h and w even)."""
    return h >= 2 and h % 2 == 0 and w % 2 == 0


def kernel_name(cout: int, dtype: torch.dtype) -> str:
    """The kernel a (Cout, storage type) launches: ``specblock_convpool``
    (float32, the 3xTF32 tensor-core kernel), ``specblock_convpool_bf16``
    (bf16, the bf16 tensor-core kernel), ``specblock_convpool_wide`` and
    ``specblock_convpool_wide_bf16`` (Cout in :data:`WIDE_COUTS`: the
    3xTF32 and the bf16 wide conv, each counted once a call, for its three
    device launches)."""
    name = "specblock_convpool_wide" if cout in WIDE_COUTS \
        else "specblock_convpool"
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


KERNEL_NAMES = tuple(kernel_name(c, dt) for c in (32, 64)
                     for dt in (torch.float32, torch.bfloat16)
                     ) + (WHOLE_KERNEL,)


def _chain_convpool(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], pool: str,
                    dtype: torch.dtype) -> torch.Tensor:
    """The fused block's function as unfused, differentiable stock ops
    (the JAX package's ``_xla_chain_convpool``): conv (float32
    accumulation over ``dtype``-rounded inputs and weights) + bias + ReLU,
    rounded to ``dtype`` after each stage, then the pool (avg sums in
    float32, as the kernel does)."""
    # contiguous NCHW with the bias inside conv2d: cuDNN's fast f32 path
    h = x.to(dtype).float().permute(0, 3, 1, 2).contiguous()
    for k, b in zip(kernels, biases):
        w = k.to(dtype).float().permute(3, 2, 0, 1)         # HWIO → OIHW
        h = torch.relu(F.conv2d(h, w, b.float(), padding=1))
        h = h.to(dtype).float()
    h = F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return h.to(dtype).permute(0, 2, 3, 1)


#: the kernel's plain PyTorch version is the chain itself
_plain_convpool = _chain_convpool


def _check_cuda_args(x, kernels, biases, pool, dtype) -> None:
    if not x.is_cuda:
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    b, h, w, cin = x.shape
    co = kernels[0].shape[-1]
    if co not in KERNEL_COUTS:
        raise ValueError(f"fused block kernel takes Cout in {KERNEL_COUTS}, "
                         f"got {co}")
    if not fused_applies(h, w) or (co in WIDE_COUTS
                                   and b * h * w > MAX_WIDE_PIXELS):
        raise ValueError(f"fused block does not take (B, H, W) = {(b, h, w)}")
    _check_params(kernels, biases, pool, cin, co, x.device)


def _check_params(kernels, biases, pool, cin, co, device) -> None:
    want = [(3, 3, cin, co), (3, 3, co, co), (3, 3, co, co)]
    if [tuple(k.shape) for k in kernels] != want:
        raise ValueError(f"kernels must be HWIO {want}")
    if any(tuple(bi.shape) != (co,) for bi in biases):
        raise ValueError(f"biases must be ({co},)")
    if pool not in ("max", "avg"):
        raise ValueError(f"pool must be 'max' or 'avg', got {pool!r}")
    if any(t.device != device for t in (*kernels, *biases)):
        raise ValueError("x, kernels and biases must share one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the tensor-core kernels read x and the weights 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_cin(x: torch.Tensor, k1: torch.Tensor):
    """x (B, H, W, Cin) and conv1's HWIO kernel (3, 3, Cin, C) with Cin
    zero-padded to a multiple of :data:`WIDE_K_CHANNELS` (the bf16 wide
    conv's K-blocks); unchanged where it already is one.  The zero channels
    meet zero weights, so conv1 computes the same function."""
    pad = -x.shape[-1] % WIDE_K_CHANNELS
    if pad:
        x, k1 = F.pad(x, (0, pad)), F.pad(k1, (0, 0, 0, pad))
    return x, k1


def _pack_bf16_pairs(k: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel (3, 3, Cin, C) as the bf16 kernel's weight words:
    int32 (rows, C).  Row j = tap·cp + p (tap = 3·ky + kx, channel pair
    p < cp = ⌈Cin/2⌉) holds, for each output channel, bf16(k[ky, kx, 2p])
    in its low half and bf16(k[ky, kx, 2p + 1]) in its high half, zero for
    the pad channel of an odd Cin; zero rows pad 9·cp to a multiple of 4
    (``bf16_rows`` in ``csrc/specblock.cu``).  K of the kernel's implicit
    GEMM runs over these rows in order, two channels a word."""
    kh, kw, cin, c = k.shape
    cp = (cin + 1) // 2
    kb = k.to(torch.bfloat16).reshape(kh * kw, cin, c)
    if cin % 2:
        kb = F.pad(kb, (0, 0, 0, 1))
    words = (kb.reshape(kh * kw, cp, 2, c).transpose(2, 3).contiguous()
             .view(torch.int32).reshape(kh * kw * cp, c))
    rows = (kh * kw * cp + 3) // 4 * 4
    return F.pad(words, (0, 0, 0, rows - kh * kw * cp))


def _launch(x, kernels, biases, pool, dtype) -> torch.Tensor:
    _check_cuda_args(x, kernels, biases, pool, dtype)
    x = _aligned(x.to(dtype))
    b, h, w, cin = x.shape
    co = kernels[0].shape[-1]
    bf16 = dtype == torch.bfloat16
    wide = co in WIDE_COUTS
    if wide:
        x, k1 = _pad_cin(x, kernels[0])
        kernels = (k1, *kernels[1:])
    if bf16:
        ws = [_aligned(_pack_bf16_pairs(k)) for k in kernels]
    else:
        ws = [_aligned(k.to(dtype).float().contiguous()) for k in kernels]
    bias = torch.stack([bi.float() for bi in biases]).contiguous()
    out = torch.empty((b, h // 2, w // 2, co), dtype=dtype, device=x.device)
    pool_max = int(pool == "max")
    entry = ("specblock_wide_" + ("bf16" if bf16 else "f32") if wide
             else "specblock_convpool")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wide:
            # conv1 and conv2 outputs; torch.empty is safe under capture
            t1, t2 = (torch.empty((b, h, w, co), dtype=dtype,
                                  device=x.device) for _ in range(2))
            rc = getattr(_lib(), entry)(
                x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                ws[2].data_ptr(), bias.data_ptr(), t1.data_ptr(),
                t2.data_ptr(), out.data_ptr(), b, h, w, x.shape[-1], co,
                pool_max, stream)
        else:
            rc = _lib().specblock_convpool(
                x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                ws[2].data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                cin, co, pool_max, int(bf16), stream)
    _build.check(rc, entry)
    fused_specblock_convpool.launches += 1
    fused_specblock_convpool.kernel_launches[kernel_name(co, dtype)] += 1
    return out


class _FusedConvPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, k2, k3, b1, b2, b3, pool, dtype):
        ctx.save_for_backward(x, k1, k2, k3, b1, b2, b3)
        ctx.pool, ctx.dtype = pool, dtype
        ks, bs = (k1, k2, k3), (b1, b2, b3)
        if x.device.type == "cpu":
            return _plain_convpool(x, ks, bs, pool, dtype)
        return _launch(x, ks, bs, pool, dtype)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            prim = [t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            out = _chain_convpool(prim[0], prim[1:4], prim[4:7], ctx.pool,
                                  ctx.dtype)
            grads = iter(torch.autograd.grad(
                out, [p for p, n in zip(prim, need) if n], g.to(ctx.dtype)))
        fused_specblock_convpool.backward_calls += 1
        return (*(next(grads) if n else None for n in need), None, None)


def fused_specblock_convpool(x: torch.Tensor,
                             kernels: Sequence[torch.Tensor],
                             biases: Sequence[torch.Tensor],
                             pool: str = "max",
                             dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """conv3x3+bias+ReLU ×3 → 2×2 pool (stride 2, VALID).  ``x`` NHWC
    (B, H, W, Cin); ``kernels`` three HWIO (3, 3, ·, C); ``biases`` three
    (C,).  Returns NHWC (B, H/2, W/2, C) in ``dtype``."""
    return _FusedConvPool.apply(x, *kernels, *biases, pool, dtype)


def whole_block_bf16(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], pool: str,
                     bn: Sequence[torch.Tensor],
                     skip: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole bf16 spectrogram block in eval mode, on the card:
    ``bn(pool(relu(conv3(relu(conv2(relu(conv1(x))))))))`` plus
    ``conv1x1(bilinear_resize(x, (H/2, W/2)))``, rounded to bf16 at each of
    the module's rounding points (the skip's 1×1 conv rounds once with its
    bias, as on the CPU; the card's stock path rounds its sum, then adds
    the bias in bf16: one bf16 unit of the skip at most between the two).
    ``x`` (B, Cin, H, W) bf16 in any layout (its strides are passed on:
    block 1's expanded plane, block 2's channels-last map); ``kernels``
    three HWIO (3, 3, ·, C), ``biases`` three (C,); ``bn`` the BatchNorm's
    (weight, bias, running_mean, running_var); ``skip`` the 1×1 conv's
    (weight (C, Cin, 1, 1), bias).
    Returns NHWC (B, H/2, W/2, C) bf16."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError("x must be a 4-D bf16 CUDA tensor")
    b, cin, h, w = x.shape
    co = kernels[0].shape[-1]
    if co not in WHOLE_COUTS or not fused_applies(h, w):
        raise ValueError(f"the whole block takes Cout in {WHOLE_COUTS} on an "
                         f"even plane, got Cout {co} on {(h, w)}")
    _check_params(kernels, biases, pool, cin, co, x.device)
    wt, bt, mean, var, sb = (_aligned(t.float().contiguous())
                             for t in (*bn, skip[1]))
    if tuple(skip[0].shape) != (co, cin, 1, 1) or any(
            tuple(t.shape) != (co,) for t in (wt, bt, mean, var, sb)):
        raise ValueError(f"the skip must be a 1x1 conv ({co}, {cin}) and the "
                         f"BatchNorm's tensors ({co},)")
    skip_w = _aligned(skip[0].float().reshape(co, cin).contiguous())
    if any(t.device != x.device for t in (wt, bt, mean, var, sb, skip_w)):
        raise ValueError("x and the block's parameters must share one device")
    ws = [_aligned(_pack_bf16_pairs(k)) for k in kernels]
    bias = torch.stack([bi.float() for bi in biases]).contiguous()
    out = torch.empty((b, h // 2, w // 2, co), dtype=x.dtype, device=x.device)
    sn, sc, sh, sw = x.stride()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().specblock_whole_bf16(
            x.data_ptr(), sn, sh, sw, sc, ws[0].data_ptr(), ws[1].data_ptr(),
            ws[2].data_ptr(), bias.data_ptr(), wt.data_ptr(), bt.data_ptr(),
            mean.data_ptr(), var.data_ptr(), skip_w.data_ptr(),
            sb.data_ptr(), out.data_ptr(), b, h, w, cin, co,
            int(pool == "max"), stream)
    _build.check(rc, "specblock_whole_bf16")
    fused_specblock_convpool.launches += 1
    fused_specblock_convpool.kernel_launches[WHOLE_KERNEL] += 1
    return out


fused_specblock_convpool.launches = 0
fused_specblock_convpool.kernel_launches = dict.fromkeys(KERNEL_NAMES, 0)
fused_specblock_convpool.backward_calls = 0
