"""Data-parallel training step (counterpart of the JAX package's
``parallel/train.py``).

Every rank runs the single-device step's arithmetic (:mod:`..train.steps`)
on its rows of the host batch (:func:`shard_batch`), then one all-reduce
over the ``data`` group averages the loss, the flat gradient vector and
the BatchNorm running statistics the forward updated (the JAX step's
``pmean`` of the loss, the gradients and the batch statistics).  The NaN
sentinel then decides on the averaged values, which every rank holds
alike, so the ranks stay in lockstep; the optimizer update runs on every
rank on the same gradients.

The dropout generator of rank ``d`` at step ``t`` is
``fold_in(fold_in(rng, d), t)``: ranks draw different masks, as DDP's ranks
do.  The model is not wrapped in ``DistributedDataParallel``: its
``broadcast_buffers`` copies rank 0's BatchNorm buffers where the JAX step
averages them, and its bucketed hooks would add nothing to a step that
reduces one flat vector.
"""

from __future__ import annotations

import dataclasses
import copy
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..train.losses import kldiv_with_logits, l2_regularization
from ..train.state import TrainState, apply_gradients, assign_flat, flat
from ..train.steps import (apply_model, fold_in, global_norm,
                           loss_and_grads)
from ..models.layers import dropout_generator
from . import mesh as mesh_lib

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Placement


def shard_batch(mesh: DeviceMesh, batch: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch: the leading axis split into
    ``data``-axis-size equal parts, part ``axis_index("data")``.  The
    leading size must divide."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = v[mesh_lib.data_slice(mesh, v.shape[0], f"batch of {k!r}")]
    return out


def state_shardings(mesh: DeviceMesh, state: TrainState,
                    tp_patterns=mesh_lib._TP_PATTERNS
                    ) -> Dict[str, list[Placement]]:
    """Placements of the state's parameters (tensor-parallel on the dense
    kernels a pattern matches, replicated otherwise) and of its buffers
    (replicated)."""
    out = mesh_lib.param_shardings(mesh, state.model, tp_patterns)
    for name, _ in state.model.named_buffers():
        out[name] = mesh_lib.replicate(mesh)
    return out


def _float_buffers(model: torch.nn.Module):
    return [b for b in model.buffers() if b.is_floating_point()]


def make_parallel_train_step(mesh: DeviceMesh, state: TrainState,
                             loss_fn: Callable = kldiv_with_logits,
                             l2_lambda: float = 0.0,
                             donate: bool = True,
                             nan_sentinel: bool = True) -> Callable:
    """Build ``step(state, batch, rng=None) -> (state, metrics)`` for this
    rank: ``batch`` holds the rank's rows (:func:`shard_batch`), ``rng``
    defaults to ``state.rng``; the state is updated in place.  The
    metrics (``loss``, ``grad_norm``, ``nonfinite``; 0-d device tensors)
    are the averaged ones, alike on every rank.  With ``nan_sentinel`` a
    non-finite loss or gradient keeps the parameters, the optimizer state
    and the BatchNorm statistics bitwise, and the step counter still
    advances.  ``donate`` is the JAX signature's and changes nothing."""
    del donate
    group = mesh.get_group("data")
    n = mesh_lib.axis_size(mesh, "data")
    index = mesh_lib.axis_index(mesh, "data")
    n_bufs = sum(b.numel() for b in _float_buffers(state.model))

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None):
        model, dev = state.model, state.device
        bufs = _float_buffers(model)
        before = flat(bufs) if bufs else None
        gen = fold_in(fold_in(state.rng if rng is None else rng, index, dev),
                      state.step, dev)
        loss, _, grads = loss_and_grads(model, batch, gen, loss_fn, l2_lambda)
        # one all-reduce: [loss, gradients, updated running statistics]
        parts = [loss.reshape(1).float(), flat(grads).float()]
        if bufs:
            parts.append(flat(bufs).float())
        vec = torch.cat(parts)
        dist.all_reduce(vec, group=group)
        vec = vec / n
        loss = vec[0].to(loss.dtype)
        g_flat = vec[1:vec.numel() - n_bufs]
        off, grads_avg = 0, []
        for g in grads:
            grads_avg.append(g_flat[off:off + g.numel()].view_as(g).to(g.dtype))
            off += g.numel()
        grad_norm = global_norm(grads_avg)
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        if not nan_sentinel:
            finite = torch.ones((), dtype=torch.bool, device=dev)
        apply_gradients(state, grads_avg, finite if nan_sentinel else None)
        if bufs:
            avg = vec[vec.numel() - n_bufs:].to(before.dtype)
            assign_flat(bufs, torch.where(finite, avg, before))
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "nonfinite": ~finite}

    return step


def replay_dp_loss_single_device(state: TrainState, batch: Dict[str, Any],
                                 rng: torch.Generator, dp: int,
                                 loss_fn: Callable = kldiv_with_logits,
                                 l2_lambda: float = 0.0) -> torch.Tensor:
    """On one device, the loss that :func:`make_parallel_train_step`
    reports for a ``dp``-way data mesh: the batch split into ``dp``
    shards, shard ``i``'s training-mode forward with the step's own
    generator ``fold_in(fold_in(rng, i), step)`` and its own BatchNorm
    batch statistics, the loss the mean of the shard losses.  The model
    and its running statistics are left as they were."""
    model = state.model
    dev = state.device
    B = int(torch.as_tensor(batch["y"]).shape[0])
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    shard = B // dp
    bufs = _float_buffers(model)
    saved = flat(bufs).clone() if bufs else None
    losses = []
    model.train()
    with torch.no_grad():
        for i in range(dp):
            sl = {k: torch.as_tensor(v)[i * shard:(i + 1) * shard].to(dev)
                  for k, v in batch.items()}
            gen = fold_in(fold_in(rng, i, dev), state.step, dev)
            with dropout_generator(model, gen):
                logits = apply_model(model, sl)
            loss = loss_fn(logits, sl["y"])
            if l2_lambda:
                loss = loss + l2_regularization(model, l2_lambda)
            losses.append(loss)
            if bufs:
                assign_flat(bufs, saved)
    return torch.stack(losses).mean()


def copy_state(state: TrainState) -> TrainState:
    """A copy of ``state`` whose model, optimizer state and step a train
    step may change without touching the original (the generator is
    shared)."""
    return dataclasses.replace(
        state, model=copy.deepcopy(state.model),
        opt_state={k: v.clone() for k, v in state.opt_state.items()},
        ema=None if state.ema is None else state.ema.clone())
