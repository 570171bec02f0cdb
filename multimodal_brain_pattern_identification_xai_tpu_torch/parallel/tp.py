"""Explicit tensor-parallel dense layers (counterpart of the JAX package's
``parallel/tp.py``).

The Megatron pair: a column-parallel dense (kernel split on its output
features) followed by a row-parallel dense (kernel split on its input
features, one all-reduce out).  Kernels keep the JAX layout, (in, out).
The two collectives are the port's own autograd functions:

* :func:`copy_in` — identity forward, all-reduce backward, in front of
  the column-parallel kernel: each rank's input gradient covers only its
  output columns, and the sum over the ``model`` group completes it;
* :func:`reduce_out` — all-reduce forward, identity backward, the
  row-parallel ``psum``: the loss after it is the same on every rank, so
  each rank's gradient of the sum is already the whole one.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which counts a gradient once a rank when every rank
backpropagates the same replicated loss.  Without a group (None) both
are the identity: the single-device program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, group: Optional[dist.ProcessGroup]
            ) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group: Optional[dist.ProcessGroup]
               ) -> torch.Tensor:
    """The sum over ``group``; the backward passes the gradient as is."""
    return x if group is None else _ReduceOut.apply(x, group)


def column_parallel_dense(x: torch.Tensor, kernel_shard: torch.Tensor,
                          bias_shard: Optional[torch.Tensor] = None,
                          group: Optional[dist.ProcessGroup] = None
                          ) -> torch.Tensor:
    """x: (..., D_in) replicated; kernel_shard: (D_in, D_out/P) local.
    Returns this rank's (..., D_out/P) activations; no collective forward
    (:func:`copy_in` sums x's gradient over ``group`` backward)."""
    y = copy_in(x, group) @ kernel_shard
    if bias_shard is not None:
        y = y + bias_shard
    return y


def row_parallel_dense(x_shard: torch.Tensor, kernel_shard: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> torch.Tensor:
    """x_shard: (..., D_in/P) local; kernel_shard: (D_in/P, D_out) local.
    The sum over ``group`` completes the contraction; bias added once."""
    y = reduce_out(x_shard @ kernel_shard, group)
    if bias is not None:
        y = y + bias
    return y


def tp_mlp(x: torch.Tensor, k1_shard: torch.Tensor, b1_shard: torch.Tensor,
           k2_shard: torch.Tensor, b2: torch.Tensor,
           activation: Callable = F.relu,
           group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Column → activation → row: the fusion head FC128 → ReLU → FC6 with
    the hidden axis sharded over ``group``, one all-reduce forward."""
    h = activation(column_parallel_dense(x, k1_shard, b1_shard, group))
    return row_parallel_dense(h, k2_shard, b2, group)


def shard_kernel_columns(kernel: torch.Tensor, index: int,
                         n_shards: int) -> torch.Tensor:
    """Shard ``index`` of ``n_shards`` of the output-feature columns."""
    size = kernel.shape[-1] // n_shards
    return kernel[..., index * size:(index + 1) * size]


def shard_kernel_rows(kernel: torch.Tensor, index: int,
                      n_shards: int) -> torch.Tensor:
    size = kernel.shape[0] // n_shards
    return kernel[index * size:(index + 1) * size]
