"""Shared building blocks (counterpart of the JAX package's
``models/layers.py``), NCHW, with the reference torch module names so a
reference checkpoint loads with ``load_state_dict``."""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import profiling
from ..ops import cuda_specblock


class BatchNorm(nn.Module):
    """BatchNorm over dim 1, eps 1e-5 (torch's default, which the JAX
    package matches).  Holds exactly the reference's keys (``weight``,
    ``bias``, ``running_mean``, ``running_var``).

    Eval mode (serving) normalises with the running statistics and never
    updates them.  Training mode is flax's ``BatchNorm(use_running_average
    =False, momentum=0.9)``: it normalises with the batch statistics over
    every axis but 1 and updates ``r ← 0.9·r + 0.1·s``, where the variance
    is flax's biased E[x²] − E[x]² (clipped at 0), not the unbiased
    n/(n−1) estimate that torch's own training-mode BatchNorm stores.

    A bf16 input is normalised in float32 against the float32 statistics
    and affine, then stored in bf16: flax's ``BatchNorm(dtype=bf16)``
    promotes x to the parameters' float32 and casts the result.  A float64
    model (a reference) normalises in float64."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=1e-5).to(x.dtype)
        dims = [d for d in range(xf.dim()) if d != 1]
        mean = xf.mean(dims)
        var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            for r, s in ((self.running_mean, mean), (self.running_var, var)):
                r.mul_(self.MOMENTUM).add_(s, alpha=1 - self.MOMENTUM)
        shape = [1, -1] + [1] * (xf.dim() - 2)
        scale = (torch.rsqrt(var + 1e-5) * self.weight).view(shape)
        y = (xf - mean.view(shape)) * scale + self.bias.view(shape)
        return y.to(x.dtype)


class Dropout(nn.Dropout):
    """Inverted dropout whose mask is drawn from an explicit generator.

    In training mode with p > 0 an element is kept where ``torch.rand(x.
    shape, generator=self.generator) >= p`` and scaled by 1/(1 − p);
    ``self.generator`` is set for each training step by
    :func:`dropout_generator` (the trainer's generator folded with the
    step), so the same seed gives the same masks.  With no generator set
    the mask draws from torch's default generator.  Eval mode and p = 0
    return x unchanged.  ``per_sample``: one draw a sample, broadcast over
    its other axes (flax's ``broadcast_dims`` over every axis but the
    batch)."""

    generator: Optional[torch.Generator] = None

    def __init__(self, p: float = 0.5, per_sample: bool = False):
        super().__init__(p)
        self.per_sample = per_sample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = ((x.shape[0],) + (1,) * (x.dim() - 1) if self.per_sample
                 else x.shape)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


@contextlib.contextmanager
def dropout_generator(model: nn.Module,
                      generator: torch.Generator) -> Iterator[None]:
    """Every :class:`Dropout` of ``model`` draws from ``generator`` inside
    the block (one generator, consumed in forward order)."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


@functools.lru_cache(maxsize=64)
def _lerp_adjoint_taps(n_in: int, n_out: int, device: torch.device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transpose of bilinear resizing (``align_corners=False``) along
    one axis, n_in → n_out, in gather form: ``(idx, w)`` of shape (K, n_in)
    with grad_in[i] = Σ_k w[k, i]·grad_out[idx[k, i]] (unused taps carry
    weight 0).  The forward taps are torch's, in float32 as torch computes
    them for float32 and bf16: source = (n_in/n_out)·(j + ½) − ½ clamped at
    0, i0 = ⌊source⌋, i1 = min(i0 + 1, n_in − 1), weights 1 − λ and λ =
    source − i0."""
    f32 = np.float32
    scale = f32(n_in) / f32(n_out)
    src = np.maximum(scale * (np.arange(n_out, dtype=f32) + f32(0.5))
                     - f32(0.5), f32(0.0))
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    lam = src - i0.astype(f32)
    taps = [[] for _ in range(n_in)]
    for jj in range(n_out):
        taps[i0[jj]].append((jj, f32(1.0) - lam[jj]))
        taps[i1[jj]].append((jj, lam[jj]))
    k = max(len(t) for t in taps)
    idx = np.zeros((k, n_in), np.int64)
    w = np.zeros((k, n_in), np.float64)
    for i, t in enumerate(taps):
        for kk, (jj, wt) in enumerate(t):
            idx[kk, i], w[kk, i] = jj, wt
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


def _lerp_adjoint(g: torch.Tensor, dim: int, n_in: int) -> torch.Tensor:
    """Apply the transpose of one axis's bilinear resize to ``g`` (at least
    float32 accumulation), gathering instead of scattering."""
    idx, w = _lerp_adjoint_taps(n_in, g.shape[dim], g.device)
    acc = torch.promote_types(g.dtype, torch.float32)
    shape = [1] * g.dim()
    shape[dim] = n_in
    gf, w = g.to(acc), w.to(acc)
    out = None
    for k in range(idx.shape[0]):
        term = gf.index_select(dim, idx[k]) * w[k].view(shape)
        out = term if out is None else out + term
    return out.to(g.dtype)


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear", align_corners=False)``
    with a deterministic backward: torch's own scatters with atomic adds
    on CUDA, so two runs of one training step could differ in their last
    bits; this one gathers each input's taps (:func:`_lerp_adjoint`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        ctx.in_hw = x.shape[-2:]
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w = ctx.in_hw
        return _lerp_adjoint(_lerp_adjoint(g, -1, w), -2, h), None


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes (torch's ``align_corners=
    False`` taps, no anti-aliasing), deterministic in its backward."""
    return _BilinearResize.apply(x, tuple(size))


class Attention(nn.Module):
    """Single-head scaled-dot attention over a token axis:
    (B, L, D_in) → (output (B, L, D), weights (B, L, L))."""

    def __init__(self, in_dim: int, attention_dim: int):
        super().__init__()
        self.attention_dim = attention_dim
        self.query = nn.Linear(in_dim, attention_dim)
        self.key = nn.Linear(in_dim, attention_dim)
        self.value = nn.Linear(in_dim, attention_dim)

    def forward(self, x: torch.Tensor):
        q, k, v = self.query(x), self.key(x), self.value(x)
        scores = q @ k.transpose(-2, -1) * self.attention_dim ** -0.5
        weights = torch.softmax(scores, dim=-1)
        return weights @ v, weights


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x``'s type: a bf16 ``x`` meets bf16-rounded weights
    and bias (float32 accumulation in cuDNN and oneDNN), stored in bf16;
    the float32 parameters stay as they are."""
    if x.dtype == conv.weight.dtype:
        return conv(x)
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    conv.stride, conv.padding)


def block_path(fused: bool, training: bool, pool_size: Tuple[int, int],
               plane: Tuple[int, int], dtype: torch.dtype, cout: int,
               recording: bool, cuda: bool) -> str:
    """How a :class:`SpectrogramBlock` call runs: ``"stock"`` (stock ops
    throughout), ``"fused"`` (conv×3 + pool through the fused block, the
    rest in stock ops: a fused module in eval mode with a 2×2 pool on an
    even plane) or ``"whole"`` (a fused call on the card in bf16 at Cout
    8/16/32 while autograd does not record: the whole block in one launch,
    :func:`..ops.cuda_specblock.whole_block_bf16`)."""
    if not (fused and not training and tuple(pool_size) == (2, 2)
            and cuda_specblock.fused_applies(*plane)):
        return "stock"
    if (cuda and dtype == torch.bfloat16 and not recording
            and cout in cuda_specblock.WHOLE_COUTS):
        return "whole"
    return "fused"


class SpectrogramBlock(nn.Module):
    """3× conv3x3+ReLU → 2×2 pool → BN → dropout, plus a bilinear-resized
    1×1-conv skip connection.

    ``fused=True`` serves the conv×3+pool chain through the fused block of
    :mod:`..ops.cuda_specblock` when the module is in eval mode and the
    plane's sides are even (the JAX package's conditions); parameters are
    the same either way.  Gradients flow through the fused path by the
    fused block's VJP (the unfused chain's autograd).  A fused bf16 call on
    the card at Cout 8/16/32 that autograd does not record (no grad mode,
    or nothing requires grad) runs the whole block, BatchNorm, skip and
    add included, in one launch (:func:`block_path`).  Traced calls count
    ``models.spec_block.fused`` and ``models.spec_block.whole``.

    ``dtype=torch.bfloat16`` is the JAX block's bf16 mode: x is cast on
    entry, the convs (the skip's 1×1 too) take bf16 operands with float32
    accumulation and store bf16, the fused block runs its bf16 kernel and
    BatchNorm stores bf16; the parameters stay float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 pool_type: str = "max", fused: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 pool_size: Tuple[int, int] = (2, 2),
                 dropout_p: float = 0.5):
        super().__init__()
        self.pool_type = pool_type
        self.pool_size = tuple(pool_size)
        self.fused = fused
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv3 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn = BatchNorm(out_channels)
        self.dropout = Dropout(dropout_p)
        self.conv1x1 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        identity = x
        convs = (self.conv1, self.conv2, self.conv3)
        recording = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        path = block_path(self.fused, self.training, self.pool_size,
                          x.shape[2:], x.dtype, self.conv1.out_channels,
                          recording, x.is_cuda)
        if path != "stock":
            profiling.count("models.spec_block.fused")
        if path == "whole":
            profiling.count("models.spec_block.whole")
            bn = self.bn
            y = cuda_specblock.whole_block_bf16(
                x, [c.weight.permute(2, 3, 1, 0) for c in convs],
                [c.bias for c in convs], self.pool_type,
                (bn.weight, bn.bias, bn.running_mean, bn.running_var),
                (self.conv1x1.weight, self.conv1x1.bias))
            return y.permute(0, 3, 1, 2)
        if path == "fused":
            y = cuda_specblock.fused_specblock_convpool(
                x.permute(0, 2, 3, 1).contiguous(),
                [c.weight.permute(2, 3, 1, 0) for c in convs],
                [c.bias for c in convs], pool=self.pool_type, dtype=x.dtype)
            x = y.permute(0, 3, 1, 2)
        else:
            for conv in convs:
                x = F.relu(_conv(conv, x))
            pool = F.max_pool2d if self.pool_type == "max" else F.avg_pool2d
            x = pool(x, self.pool_size)
        x = self.dropout(self.bn(x))
        if identity.shape != x.shape:
            identity = bilinear_resize(identity, x.shape[2:])
            identity = _conv(self.conv1x1, identity)
        return x + identity


class MultiheadSelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s keys
    (``in_proj_weight`` (3D, D) packing q, k, v; ``in_proj_bias``;
    ``out_proj``), batch-first, the counterpart of flax's
    ``MultiHeadDotProductAttention(qkv_features=D)``: softmax(q·kᵀ/√d_h)
    per head, made explicitly so the per-head weights (B, H, L, L) come
    back beside the output (attention rollout reads them).  In training
    mode the weights pass a :class:`Dropout` of rate ``dropout``.
    Returns ``(output (B, L, D), weights (B, H, L, L))``."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"width {dim} is not a multiple of {n_heads} "
                             "heads")
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.dropout = Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def l2_extra(self) -> list:
        """The packed q/k/v kernel, which the L2 term covers as flax's
        ``query``/``key``/``value`` kernels."""
        return [self.in_proj_weight]

    def forward(self, x: torch.Tensor):
        b, n, dim = x.shape
        h = self.n_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(b, n, 3, h, dim // h).permute(2, 0, 3, 1, 4)
        scores = (q * (dim // h) ** -0.5) @ k.transpose(-2, -1)
        weights = torch.softmax(scores, dim=-1)               # (B, H, L, L)
        out = self.dropout(weights) @ v                       # (B, H, L, d_h)
        out = self.out_proj(out.transpose(1, 2).reshape(b, n, dim))
        return out, weights


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer with torch's defaults and key
    names (``self_attn``, ``linear1``, ``linear2``, ``norm1``, ``norm2``):
    ReLU feed-forward of ``dim_feedforward``, LayerNorm eps 1e-5,
    batch-first (B, L, D), dropout on the attention weights, the two
    residual branches and the feed-forward's hidden layer."""

    def __init__(self, d_model: int, n_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.5):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, n_heads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, _ = self.self_attn(x)
        x = self.norm1(x + self.dropout(a))
        h = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout(h))


class LSTM(nn.LSTM):
    """One-layer ``nn.LSTM(batch_first=True)`` over (B, T, D) from a zero
    state, returning the whole sequence (B, T, H·dirs): the counterpart of
    flax's ``nn.RNN(OptimizedLSTMCell)`` (gates i, f, g, o; flax's one
    bias a gate sits in ``bias_hh``, and ``bias_ih`` is zero when the
    weights come from flax).  :class:`BiLSTM` is its bidirectional form,
    the two directions' states (each in input order) concatenated."""

    def __init__(self, input_size: int, hidden: int,
                 bidirectional: bool = False):
        super().__init__(input_size, hidden, batch_first=True,
                         bidirectional=bidirectional)

    def l2_extra(self) -> list:
        """The input and hidden kernels (flax's ``ii``…``ho`` kernels)."""
        return [p for n, p in self.named_parameters()
                if n.startswith("weight_")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class BiLSTM(LSTM):
    """Bidirectional :class:`LSTM`, (B, T, 2H)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, bidirectional=True)
