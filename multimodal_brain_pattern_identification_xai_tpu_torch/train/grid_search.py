"""Hyperparameter grid search (counterpart of the JAX package's
``train/grid_search.py``).

Every candidate of the grid trains on the same batches: the parameters
and Adam states of the G candidates are stacked on a leading axis, and one
step runs the candidates one after another (``functional_call`` forward on
candidate g's slice → loss → gradients → Adam with the candidate's
learning rate), writing each result back into the stacks.  The Adam
arithmetic is :class:`.state.Optimizer`'s; the learning rate column of the
grid is injected into each candidate's state before its update, as optax's
``inject_hyperparams`` does.  (A ``torch.func.vmap`` of the same step
turns every convolution into a grouped one, which cuDNN runs 3× slower on
the H100 than the loop.)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..models.weights import seeded_state_dict
from .state import Optimizer, assign_flat, flat

#: the grid's optimizer: Adam at the injected learning rate
ADAM = Optimizer("adam", lr=1e-3)


def init_candidates(model: nn.Module, n: int, seed: int = 42,
                    tx: Optimizer = ADAM
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """(params, opt_state) of ``n`` candidates stacked on a leading axis,
    on the model's device: candidate g's parameters drawn by
    ``seeded_state_dict(model, seed + g)``, its Adam state fresh."""
    dev = next(model.parameters()).device
    names = [name for name, _ in model.named_parameters()]
    draws = [seeded_state_dict(model, seed + g) for g in range(n)]
    params = {name: torch.stack([d[name] for d in draws]).to(dev)
              for name in names}
    one = tx.init([p.detach() for p in model.parameters()])
    opt = {k: torch.stack([v] * n) for k, v in one.items()}
    return params, opt


def make_grid_step(model: nn.Module, loss_fn: Callable,
                   lr_col: Optional[int], tx: Optimizer = ADAM) -> Callable:
    """``grid_step(params, opt_state, hp, x, y) -> (params, opt_state,
    losses)``: one step of every candidate on the batch ``(x, y)``.
    ``params`` and ``opt_state`` are stacked as :func:`init_candidates`
    makes them, ``hp`` (G, P) the candidates' grid values, whose column
    ``lr_col`` (when not None) is each candidate's learning rate; returns
    new stacks (the inputs are left as they are) and each candidate's loss
    before its update (G,)."""
    names = [name for name, _ in model.named_parameters()]

    def grid_step(params, opt_state, hp, x, y):
        params = {n: v.detach().clone() for n, v in params.items()}
        opt_state = {k: v.clone() for k, v in opt_state.items()}
        losses = []
        for g in range(len(hp)):
            p = {n: params[n][g].detach().requires_grad_(True)
                 for n in names}
            loss = loss_fn(functional_call(model, p, (x,)), y)
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            opt = {k: v[g] for k, v in opt_state.items()}
            if lr_col is not None:
                opt["lr"] = hp[g, lr_col]
            new, opt = tx.update(flat(grads),
                                 flat([p[n].detach() for n in names]), opt)
            assign_flat([params[n][g] for n in names], new)
            with torch.no_grad():
                for k, v in opt.items():
                    opt_state[k][g] = v
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return grid_step


def parallel_grid_search(model: nn.Module, sample_input: Tuple,
                         data_iter_factory: Callable[[], Any],
                         grid: Dict[str, Sequence[float]],
                         loss_fn: Callable,
                         epochs: int = 1,
                         seed: int = 42
                         ) -> Tuple[Dict[str, float], List[Dict]]:
    """Train one ``model`` a point of the grid's cartesian product, all
    candidates through one step over the stacks (:func:`make_grid_step`).

    Args:
        model: a module called as ``model(x)``; it moves to the device of
            ``sample_input[0]``, where the candidates train.
        sample_input: an example ``(x,)`` on the training device.
        data_iter_factory: zero-argument callable giving an epoch's
            iterator of ``{"x", "y"}`` batches (numpy or tensors).
        grid: ``{name: values}``, e.g. ``{"lr": [1e-3, 3e-3, 1e-2]}``; only
            ``lr`` steers the optimizer, other axes are carried through.
        loss_fn: ``(logits, targets) -> scalar``.

    Returns:
        (best, results): each candidate's grid values and final loss (the
        loss of its last step), ranked by that loss, and the best one.
    """
    keys = list(grid)
    mesh = np.meshgrid(*[np.asarray(grid[k], np.float32) for k in keys],
                       indexing="ij")
    combos = np.stack([m.reshape(-1) for m in mesh], axis=1)   # (G, P)
    lr_col = keys.index("lr") if "lr" in keys else None
    dev = torch.as_tensor(sample_input[0]).device
    model.to(dev)
    params, opt = init_candidates(model, len(combos), seed)
    step = make_grid_step(model, loss_fn, lr_col)
    hp = torch.as_tensor(combos, device=dev)
    losses = None
    for _ in range(epochs):
        for batch in data_iter_factory():
            params, opt, losses = step(
                params, opt, hp, torch.as_tensor(batch["x"]).to(dev),
                torch.as_tensor(batch["y"]).to(dev))
    if losses is None:
        raise ValueError("the data iterator yielded no batches")
    final = losses.detach().cpu().numpy()
    results = [{**{k: float(combos[g, i]) for i, k in enumerate(keys)},
                "loss": float(final[g])} for g in range(len(combos))]
    results.sort(key=lambda r: r["loss"])
    return results[0], results
