"""Sequence parallelism for long multi-hour EEG (counterpart of the JAX
package's ``parallel/seqparallel.py``).

The time axis is split over the ``seq`` axis of the mesh, each rank
holding one contiguous part, in seq-rank order:

* :func:`halo_conv1d` — a 'SAME' convolution of the local part with K//2
  halo samples taken from the ring neighbours (``batch_isend_irecv``),
  zeros at the global edges; its backward sends the halos' gradients back
  the other way;
* :func:`sequence_parallel_attention` — local queries against the keys
  and values all-gathered along the token axis (exact attention); the
  backward reduce-scatters the key and value gradients to their owners;
* :class:`LongEEGEncoder` + :func:`long_eeg_forward` — patch embedding,
  pre-LN transformer and a mean pool summed over the ``seq`` group, with
  the attention weights for :func:`long_eeg_rollout`.

The collectives are the identity over a group of one, and ``group=None``
runs the single-device program.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .tp import reduce_out

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def _ring(group: dist.ProcessGroup) -> Tuple[int, int, int, int]:
    """(index, size, left neighbour's global rank, right neighbour's)."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    return i, n, ranks[(i - 1) % n], ranks[(i + 1) % n]


def _exchange(left_edge: torch.Tensor, right_edge: torch.Tensor,
              group: dist.ProcessGroup
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``right_edge`` to the right neighbour and ``left_edge`` to the
    left one; returns (what the left neighbour sent right, what the right
    neighbour sent left), zeros at the global edges."""
    i, n, left, right = _ring(group)
    right_edge, left_edge = right_edge.contiguous(), left_edge.contiguous()
    from_left = torch.zeros_like(right_edge)
    from_right = torch.zeros_like(left_edge)
    if n > 1:
        ops = [dist.P2POp(dist.isend, right_edge, right, group, tag=0),
               dist.P2POp(dist.irecv, from_left, left, group, tag=0),
               dist.P2POp(dist.isend, left_edge, left, group, tag=1),
               dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if i == 0:
            from_left.zero_()
        if i == n - 1:
            from_right.zero_()
    return from_left, from_right


class _Halo(torch.autograd.Function):
    """(B, T_local, C) → (B, h + T_local + h, C) with the neighbours'
    edge samples; the backward returns the halo gradients to their
    owners."""

    @staticmethod
    def forward(ctx, x, h, group):
        ctx.h, ctx.group = h, group
        from_left, from_right = _exchange(x[:, :h], x[:, -h:], group)
        return torch.cat([from_left, x, from_right], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.h
        g_x = g[:, h:-h].clone()
        i, n, _, _ = _ring(ctx.group)
        g_left, g_right = g[:, :h].clone(), g[:, -h:].clone()
        if i == 0:
            g_left.zero_()            # the zero pad at the global start
        if i == n - 1:
            g_right.zero_()
        from_left, from_right = _exchange(g_left, g_right, ctx.group)
        g_x[:, :h] += from_left
        g_x[:, -h:] += from_right
        return g_x, None, None


def halo_conv1d(x_local: torch.Tensor, kernel: torch.Tensor,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """'SAME' 1-D convolution over a time axis split over ``group``.

    ``x_local``: (B, T_local, C_in); ``kernel``: (K, C_in, C_out), K odd
    (the JAX layouts, channels last).  The local part is padded with K//2
    samples from each neighbour (zeros at the global edges) and convolved
    'VALID': the global 'SAME' convolution's part."""
    K = kernel.shape[0]
    h = K // 2
    if group is None:
        xp = F.pad(x_local, (0, 0, h, h))
    else:
        xp = _Halo.apply(x_local, h, group)
    y = F.conv1d(xp.transpose(1, 2), kernel.permute(2, 1, 0))
    return y.transpose(1, 2)


class _GatherTokens(torch.autograd.Function):
    """All-gather along the token axis (dim 1) in group order; the
    backward reduce-scatters the gradient back to the owners."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        chunks = torch.stack(g.chunk(n, dim=1)).contiguous()
        out = torch.empty_like(chunks[0])
        scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
        scatter(out, chunks.flatten(0, 1), group=ctx.group)
        return out, None


def gather_tokens(x: torch.Tensor, group: Optional[dist.ProcessGroup]
                  ) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherTokens.apply(x, group)


def _attend(qh, kh, vh, B, Ll, D, return_weights):
    hd = qh.shape[-1]
    scores = torch.einsum("blhd,bmhd->bhlm", qh, kh) / np.sqrt(hd)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", weights, vh).reshape(B, Ll, D)
    return (out, weights) if return_weights else out


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, n_heads: int,
                                group: Optional[dist.ProcessGroup] = None,
                                return_weights: bool = False):
    """Exact multi-head attention with the token axis split over
    ``group``: q/k/v (B, L_local, D); keys and values all-gathered in
    group order, queries local.  Weights: (B, H, L_local, L)."""
    B, Ll, D = q.shape
    hd = D // n_heads
    kf, vf = gather_tokens(k, group), gather_tokens(v, group)
    split = lambda t: t.reshape(t.shape[0], t.shape[1], n_heads, hd)
    return _attend(split(q), split(kf), split(vf), B, Ll, D, return_weights)


def _local_attention(q, k, v, n_heads, return_weights: bool = False):
    return sequence_parallel_attention(q, k, v, n_heads, None,
                                       return_weights)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` for an (in, out) kernel: a normal truncated
    at ±2 with variance 1/fan_in after the truncation."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t


class _EncoderLayer(nn.Module):
    def __init__(self, d: int, m: int):
        super().__init__()
        z = lambda *s: nn.Parameter(torch.zeros(*s))
        self.qkv, self.proj = z(d, 3 * d), z(d, d)
        self.ln1_scale, self.ln1_bias = nn.Parameter(torch.ones(d)), z(d)
        self.ln2_scale, self.ln2_bias = nn.Parameter(torch.ones(d)), z(d)
        self.fc1, self.fc1_b = z(d, m), z(m)
        self.fc2, self.fc2_b = z(m, d), z(d)


class LongEEGEncoder(nn.Module):
    """Patch embedding + pre-LN transformer + mean-pool classifier over a
    time axis split over the ``seq`` group.

    Parameters as the JAX encoder's explicit pytree, kernels (in, out):
    ``embed`` (patch·C, D), ``embed_b``, ``head`` (D, n_classes),
    ``head_b``, and per layer ``qkv`` (D, 3D), ``proj`` (D, D) (no
    biases), LayerNorm ``ln1_*``/``ln2_*`` (ε 1e-6), ``fc1`` (D, M) +
    ``fc1_b``, ``fc2`` (M, D) + ``fc2_b``, GELU in its tanh form (JAX's
    ``jax.nn.gelu``).  :func:`jax_params_to_state_dict` carries the JAX
    encoder's parameters over.  Initialised from ``generator`` (default
    seed 0): kernels lecun-normal, biases 0, LayerNorm scales 1."""

    def __init__(self, n_channels: int = 20, patch: int = 200,
                 d_model: int = 128, depth: int = 4, n_heads: int = 4,
                 mlp_ratio: int = 4, n_classes: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_channels, self.patch, self.d_model = n_channels, patch, d_model
        self.depth, self.n_heads, self.n_classes = depth, n_heads, n_classes
        self.mlp = d_model * mlp_ratio
        D = d_model
        self.embed = nn.Parameter(torch.zeros(patch * n_channels, D))
        self.embed_b = nn.Parameter(torch.zeros(D))
        self.head = nn.Parameter(torch.zeros(D, n_classes))
        self.head_b = nn.Parameter(torch.zeros(n_classes))
        self.layers = nn.ModuleList(_EncoderLayer(D, self.mlp)
                                    for _ in range(depth))
        self.init(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LongEEGEncoder":
        for name, p in self.named_parameters():
            if p.dim() == 2:
                p.copy_(lecun_normal(tuple(p.shape), generator))
            elif "scale" in name:
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, x_local: torch.Tensor,
                group: Optional[dist.ProcessGroup] = None,
                return_attn: bool = False):
        return self.local_forward(x_local, group, return_attn)

    def local_forward(self, x_local: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None,
                      return_attn: bool = False):
        """x_local: (B, C, T_local), T_local a multiple of ``patch``;
        ``group`` the ``seq`` group (None: one device holds the whole
        sequence).  Returns logits (B, n_classes), with ``return_attn``
        also the attention weights stacked (depth, B, H, L_local, L)."""
        B, Cc, Tl = x_local.shape
        L = Tl // self.patch
        tokens = x_local.reshape(B, Cc, L, self.patch).permute(0, 2, 3, 1)
        h = tokens.reshape(B, L, self.patch * Cc) @ self.embed + self.embed_b
        attns = []
        D = self.d_model
        for lyr in self.layers:
            a_in = F.layer_norm(h, (D,), lyr.ln1_scale, lyr.ln1_bias, 1e-6)
            q, k, v = (a_in @ lyr.qkv).chunk(3, dim=-1)
            a, w = sequence_parallel_attention(q, k, v, self.n_heads, group,
                                               return_weights=True)
            if return_attn:
                attns.append(w)
            h = h + a @ lyr.proj
            m_in = F.layer_norm(h, (D,), lyr.ln2_scale, lyr.ln2_bias, 1e-6)
            m = F.gelu(m_in @ lyr.fc1 + lyr.fc1_b, approximate="tanh")
            h = h + m @ lyr.fc2 + lyr.fc2_b
        n = 1 if group is None else dist.get_world_size(group)
        pooled = reduce_out(h.sum(dim=1), group) / (L * n)
        logits = pooled @ self.head + self.head_b
        if return_attn:
            return logits, torch.stack(attns)
        return logits


def jax_params_to_state_dict(params: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX encoder's parameter pytree (``LongEEGEncoder.init``, as
    numpy or JAX arrays) → this encoder's ``state_dict`` (same layouts)."""
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32))
    sd = {k: t(params[k]) for k in ("embed", "embed_b", "head", "head_b")}
    for i, lyr in enumerate(params["layers"]):
        for k in ("qkv", "proj", "fc1", "fc1_b", "fc2", "fc2_b"):
            sd[f"layers.{i}.{k}"] = t(lyr[k])
        for ln in ("ln1", "ln2"):
            sd[f"layers.{i}.{ln}_scale"] = t(lyr[ln][0])
            sd[f"layers.{i}.{ln}_bias"] = t(lyr[ln][1])
    return sd


def _seq_part(encoder: LongEEGEncoder, x: torch.Tensor, mesh: DeviceMesh):
    """(seq group, this rank's contiguous part of x's time axis)."""
    group = mesh.get_group("seq")
    n = dist.get_world_size(group)
    s = mesh.get_local_rank("seq")
    T = x.shape[-1]
    if T % (n * encoder.patch):
        raise ValueError(f"T={T} must divide into {n} seq parts of whole "
                         f"{encoder.patch}-sample patches")
    Tl = T // n
    return group, x[..., s * Tl:(s + 1) * Tl]


def _call(encoder, params, x_local, group, return_attn=False):
    if params is None:
        return encoder(x_local, group, return_attn)
    return torch.func.functional_call(encoder, params, (x_local,),
                                      {"group": group,
                                       "return_attn": return_attn})


def long_eeg_forward(encoder: LongEEGEncoder,
                     params: Optional[Dict[str, torch.Tensor]],
                     x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sequence-parallel forward of x (B, C, T), the whole input on every
    rank: each rank runs its part of the time axis; the logits (B,
    n_classes) come out alike on every rank.  ``params``: None for the
    encoder's own, or a ``{name: tensor}`` dict (``functional_call``)."""
    group, xl = _seq_part(encoder, x, mesh)
    return _call(encoder, params, xl, group)


@torch.no_grad()
def long_eeg_rollout(encoder: LongEEGEncoder,
                     params: Optional[Dict[str, torch.Tensor]],
                     x: torch.Tensor, mesh: DeviceMesh):
    """Sequence-parallel forward and attention rollout over the whole
    token axis: the per-layer weights (depth, B, H, L_local, L) are
    all-gathered over ``seq`` along the query axis and composed by
    ``xai.rollout.attention_rollout``.  Returns (logits, rollout (B, L,
    L)), alike on every rank."""
    from ..xai.rollout import attention_rollout
    group, xl = _seq_part(encoder, x, mesh)
    logits, attn = _call(encoder, params, xl, group, return_attn=True)
    n = dist.get_world_size(group)
    if n > 1:
        parts = [torch.empty_like(attn) for _ in range(n)]
        dist.all_gather(parts, attn.contiguous(), group=group)
        attn = torch.cat(parts, dim=3)
    return logits, attention_rollout(list(attn))
