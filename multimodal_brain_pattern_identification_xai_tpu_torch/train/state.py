"""Train state and optimizers (counterpart of the JAX package's
``train/state.py``).

:class:`Optimizer` reproduces the optax chains of the JAX package's
``make_optimizer``: ``adam``, ``adamw`` and ``sgd`` under
``inject_hyperparams`` (the learning rate is a state tensor that
:func:`set_learning_rate` and ``ReduceLROnPlateau`` steer), ``MultiSteps``
gradient accumulation, and :func:`freeze_except`'s ``set_to_zero`` for
frozen parameters.  It is functional over one flat float32 vector of the
trainable parameters: :meth:`Optimizer.update` returns new tensors and
leaves its inputs alone, so a training step can keep the old state on the
device with ``torch.where`` (the NaN sentinel) without asking the host.

:class:`TrainState` holds the model (parameters and BatchNorm buffers), the
optimizer and its state, the step counter, the optional EMA of the
parameters and the trainer's generator: everything a bitwise resume needs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

OPTIMIZERS = ("adam", "adamw", "sgd")
#: optax ``adam``'s decay rates and ε (outside the square root)
B1, B2, EPS = 0.9, 0.999, 1e-8


def flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' values as one new flat vector."""
    return torch.cat([t.reshape(-1) for t in ts])


@torch.no_grad()
def assign_flat(ts: Sequence[torch.Tensor], v: torch.Tensor) -> None:
    """Copy consecutive pieces of the flat vector ``v`` into ``ts``."""
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(v[off:off + n].view_as(t))
        off += n


@dataclass(frozen=True)
class Optimizer:
    """One optax chain of ``make_optimizer``, as a functional update over
    flat float32 vectors.

    * ``adam``: μ ← B1·μ + (1−B1)·g, ν ← B2·ν + (1−B2)·g², step
      −lr·μ̂/(√ν̂ + EPS) with μ̂ = μ/(1 − B1^t), ν̂ = ν/(1 − B2^t);
      ``adamw`` (or ``adam`` with ``weight_decay``) adds wd·p to the
      Adam direction before the −lr scale;
    * ``sgd``: −lr·g;
    * ``grad_accum_steps`` = k > 1: optax ``MultiSteps``, the running mean
      of k gradients, the inner update applied on every k-th call only;
    * ``train_names``: only parameters whose name contains one of these
      substrings are updated; the rest get a zero update (``set_to_zero``).
    """
    name: str = "adam"
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_accum_steps: int = 1
    train_names: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.name!r}")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be at least 1")

    def trainable(self, names: Sequence[str]) -> List[bool]:
        """Which of the named parameters the optimizer updates."""
        if self.train_names is None:
            return [True] * len(names)
        return [any(n in name for n in self.train_names) for name in names]

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """State for the trainable ``params`` (flat, float32, on their
        device): ``lr``, the Adam ``count`` and moments, and under
        ``MultiSteps`` the gradient mean ``acc`` and ``mini_step``."""
        dev = params[0].device if params else torch.device("cpu")
        n = sum(p.numel() for p in params)
        zeros = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
        st = {"lr": torch.tensor(self.lr, dtype=torch.float32, device=dev),
              "count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.name != "sgd":
            st["mu"], st["nu"] = zeros(), zeros()
        if self.grad_accum_steps > 1:
            st["acc"] = zeros()
            st["mini_step"] = torch.zeros((), dtype=torch.int32, device=dev)
        return st

    def update(self, g: torch.Tensor, p: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step on the flat gradient ``g`` of the flat trainable
        parameters ``p``: returns (new parameters, new state)."""
        k = self.grad_accum_steps
        if k == 1:
            return self._inner(g, p, state)
        mini = state["mini_step"]
        acc = state["acc"] + (g - state["acc"]) / (mini + 1)
        emit = mini == k - 1
        new_p, inner = self._inner(acc, p, state)
        out = {key: torch.where(emit, v, state[key])
               for key, v in inner.items()}
        out["acc"] = torch.where(emit, 0.0, acc)
        out["mini_step"] = torch.remainder(mini + 1, k)
        return torch.where(emit, new_p, p), out

    def _inner(self, g, p, state):
        out = dict(state)
        out["count"] = state["count"] + 1
        if self.name == "sgd":
            u = g
        else:
            t = out["count"].to(g.dtype)     # float64 moments: exact
            mu = (1 - B1) * g + B1 * state["mu"]
            nu = (1 - B2) * g ** 2 + B2 * state["nu"]
            mu_hat = mu / (1 - torch.pow(B1, t))
            nu_hat = nu / (1 - torch.pow(B2, t))
            u = mu_hat / (torch.sqrt(nu_hat) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            out["mu"], out["nu"] = mu, nu
        return p + (-state["lr"]) * u, out


def make_optimizer(lr: float, weight_decay: float = 0.0,
                   grad_accum_steps: int = 1,
                   optimizer: str = "adam") -> Optimizer:
    """Adam(W) or SGD with a steerable learning rate and optional gradient
    accumulation (the JAX package's ``make_optimizer``)."""
    return Optimizer(name=optimizer, lr=float(lr), weight_decay=weight_decay,
                     grad_accum_steps=grad_accum_steps)


def freeze_except(tx: Optimizer, names_to_train: Sequence[str]) -> Optimizer:
    """Fine-tuning gate: only parameters whose name (``named_parameters``,
    e.g. ``fc1.weight``) contains one of ``names_to_train`` are updated;
    the rest stay bitwise frozen (a zero update, not a pass-through of
    the gradient)."""
    return dataclasses.replace(tx, train_names=tuple(names_to_train))


@dataclass
class TrainState:
    """The model with its BatchNorm buffers, the optimizer and its state,
    the step counter (a host integer: it advances on every step, skipped
    or not), the EMA of the parameters (flat, or None) and the trainer's
    generator (dropout draws are folded from it and the step)."""
    model: nn.Module
    tx: Optimizer
    opt_state: Dict[str, torch.Tensor]
    step: int = 0
    ema: Optional[torch.Tensor] = None
    rng: torch.Generator = field(
        default_factory=lambda: torch.Generator().manual_seed(0))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def trainable_mask(self) -> List[bool]:
        return self.tx.trainable([n for n, _ in self.model.named_parameters()])

    def ema_params(self) -> Dict[str, torch.Tensor]:
        """The EMA as a ``{name: tensor}`` dict of the parameters' shapes."""
        out, off = {}, 0
        for name, p in self.model.named_parameters():
            out[name] = self.ema[off:off + p.numel()].view_as(p)
            off += p.numel()
        return out

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "opt_state": self.opt_state,
                "step": self.step, "ema": self.ema,
                "rng": self.rng.get_state()}

    def load_state_dict(self, d: dict) -> "TrainState":
        """Load a :meth:`state_dict` (tensors on any device) in place."""
        dev = self.device
        self.model.load_state_dict(d["model"])
        self.opt_state = {k: v.to(dev) for k, v in d["opt_state"].items()}
        self.step = int(d["step"])
        self.ema = None if d["ema"] is None else d["ema"].to(dev)
        self.rng.set_state(d["rng"].cpu())
        return self


def create_train_state(model: nn.Module, tx: Optimizer, seed: int = 0,
                       with_ema: bool = False) -> TrainState:
    """Wrap a built model (parameters on their device) with the optimizer
    state of its trainable parameters, a generator seeded with ``seed``,
    and an EMA starting at the parameters when ``with_ema``."""
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    trainable = [p.detach() for p, t in zip(params, tx.trainable(names)) if t]
    return TrainState(
        model=model, tx=tx, opt_state=tx.init(trainable),
        ema=flat([p.detach() for p in params]).float() if with_ema else None,
        rng=torch.Generator().manual_seed(seed))


def apply_gradients(state: TrainState, grads: Sequence[torch.Tensor],
                    finite: Optional[torch.Tensor] = None) -> TrainState:
    """One optimizer step on the model's parameters in place, ``grads`` in
    ``model.parameters()`` order.  With ``finite`` (a 0-d bool tensor),
    the parameters and the optimizer state stay bitwise as they were where
    it is False, decided on the device.  The step counter is left alone."""
    params = list(state.model.parameters())
    mask = state.trainable_mask()
    train_p = [p for p, m in zip(params, mask) if m]
    p_old = flat([p.detach() for p in train_p])
    p_new, opt_new = state.tx.update(
        flat([g for g, m in zip(grads, mask) if m]), p_old, state.opt_state)
    if finite is not None:
        p_new = torch.where(finite, p_new, p_old)
        opt_new = {k: torch.where(finite, v, state.opt_state[k])
                   for k, v in opt_new.items()}
    assign_flat(train_p, p_new)
    state.opt_state = opt_new
    return state


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the injected learning rate (host-side schedules, plateau)."""
    state.opt_state["lr"].fill_(lr)
    return state
