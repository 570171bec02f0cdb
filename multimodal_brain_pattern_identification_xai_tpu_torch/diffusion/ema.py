"""Parameter EMA (counterpart of the JAX package's ``diffusion/ema.py``):
an exponential moving average with warm-up.  Before ``step_start_ema``
the EMA is reset to the parameters; after it, it is blended on every
``update_every``-th step and kept as it is otherwise.

The parameters are one tensor (the trainer's flat vector); the step is the
host's step counter (the optimizer's step after its increment), so the
choice between reset, blend and keep never waits for the device."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class EMA:
    params: torch.Tensor
    beta: float = 0.995
    step_start_ema: int = 20
    update_every: int = 10

    @staticmethod
    def create(params: torch.Tensor, beta: float = 0.995,
               step_start_ema: int = 20, update_every: int = 10) -> "EMA":
        """An EMA starting at a detached copy of ``params``."""
        return EMA(params.detach().clone(), beta, step_start_ema,
                   update_every)


def ema_update(ema: EMA, params: torch.Tensor, step: int) -> EMA:
    """One conditional EMA step at optimizer step ``step``: reset while
    ``step < step_start_ema``, blend ``old·β + new·(1−β)`` when ``step``
    is a multiple of ``update_every``, else keep."""
    if step < ema.step_start_ema:
        new = params.detach().clone()
    elif step % ema.update_every == 0:
        new = ema.params * ema.beta + params.detach() * (1.0 - ema.beta)
    else:
        return ema
    return replace(ema, params=new)
