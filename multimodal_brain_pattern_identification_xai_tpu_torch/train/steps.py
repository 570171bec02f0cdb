"""Train and eval steps (counterpart of the JAX package's
``train/steps.py``).

One training step: the forward in training mode (BatchNorm on batch
statistics, dropout drawing from the trainer's generator folded with the
step) → loss with soft KLDiv targets (+ the manual L2 term) → backward →
global gradient norm → ``finite`` → the optimizer update.  The NaN
sentinel decides on the device: on a non-finite loss or gradient the
parameters, the optimizer state, the BatchNorm running statistics and the
EMA stay bitwise as they were (``torch.where(finite, new, old)``), the step
counter still advances, and nothing waits for the host.  The metrics come
back as device tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import dropout_generator
from .losses import kldiv_with_logits, l2_regularization
from .state import TrainState, apply_gradients, assign_flat, flat


def fold_in(rng: torch.Generator, step: int,
            device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``rng``'s seed and ``step``
    (``jax.random.fold_in``'s role): the same pair gives the same draws."""
    seed = np.random.SeedSequence([rng.initial_seed(), int(step)])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed.generate_state(2, np.uint32).view(np.uint64)[0]))
    return g


def apply_model(model: nn.Module, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """The model on a batch: ``eeg`` + ``spec`` (multimodal) or ``x``."""
    if "eeg" in batch:
        return model(batch["eeg"], batch["spec"])
    return model(batch["x"])


def loss_and_grads(model: nn.Module, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   loss_fn: Callable = kldiv_with_logits,
                   l2_lambda: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """The forward in training mode (updating the BatchNorm running
    statistics) and the backward: (loss, logits, one gradient a parameter
    in ``model.parameters()`` order; zeros for an unused one)."""
    model.train()
    with dropout_generator(model, generator):
        logits = apply_model(model, batch)
    loss = loss_fn(logits, batch["y"])
    if l2_lambda:
        loss = loss + l2_regularization(model, l2_lambda)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), logits.detach(), [
        torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """√Σ‖g‖² over every gradient (optax ``global_norm``)."""
    g = flat(grads)
    return torch.sqrt(torch.dot(g, g))


def make_train_step(loss_fn: Callable = kldiv_with_logits,
                    l2_lambda: float = 0.0,
                    ema_decay: Optional[float] = None,
                    nan_sentinel: bool = True) -> Callable:
    """Build ``train_step(state, batch, rng=None) -> (state, metrics)``;
    ``rng`` defaults to ``state.rng``.  The state is updated in place and
    returned.  ``metrics``: ``loss``, ``grad_norm`` and ``nonfinite``, 0-d
    device tensors.  With ``nan_sentinel`` a non-finite loss or gradient
    skips the update (see the module docstring); without it every step
    applies its update, non-finite or not."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   rng: Optional[torch.Generator] = None):
        model = state.model
        dev = state.device
        bufs = [b for b in model.buffers() if b.is_floating_point()]
        before = flat(bufs) if bufs and nan_sentinel else None
        gen = fold_in(state.rng if rng is None else rng, state.step, dev)
        loss, _, grads = loss_and_grads(model, batch, gen, loss_fn, l2_lambda)
        grad_norm = global_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)

        apply_gradients(state, grads, finite if nan_sentinel else None)
        if before is not None:
            assign_flat(bufs, torch.where(finite, flat(bufs), before))
        if ema_decay is not None and state.ema is not None:
            params = flat([p.detach() for p in model.parameters()])
            ema = state.ema * ema_decay + params * (1.0 - ema_decay)
            state.ema = torch.where(finite, ema, state.ema) \
                if nan_sentinel else ema
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "nonfinite": ~finite}

    return train_step


def make_eval_step(loss_fn: Callable = kldiv_with_logits,
                   use_ema: bool = False) -> Callable:
    """Build ``eval_step(state, batch) -> (logits, loss)``: eval mode, no
    gradients; ``use_ema`` evaluates with the EMA parameters."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.eval()
        if use_ema and state.ema is not None:
            args = ((batch["eeg"], batch["spec"]) if "eeg" in batch
                    else (batch["x"],))
            logits = torch.func.functional_call(model, state.ema_params(),
                                                args)
        else:
            logits = apply_model(model, batch)
        return logits, loss_fn(logits, batch["y"])

    return eval_step
