"""Plain input-gradient attributions by autograd over the reference
models.

* :func:`saliency`: |∂ logit_t / ∂x| of both inputs of the fused model,
  one backward.
* :func:`integrated_gradients`: (x − 0)·mean over α = (k + ½)/steps of
  ∂ logit_t(α·x) / ∂x, for the EEG branch alone, ``chunk`` values of α a
  backward.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def saliency(forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
             eeg: torch.Tensor, spec: torch.Tensor, target: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    e = eeg.detach().clone().requires_grad_(True)
    s = spec.detach().clone().requires_grad_(True)
    out = forward(e, s).gather(-1, target[:, None]).sum()
    ge, gs = torch.autograd.grad(out, (e, s))
    return ge.abs(), gs.abs()


def integrated_gradients(forward: Callable[[torch.Tensor], torch.Tensor],
                         x: torch.Tensor, target: torch.Tensor,
                         steps: int = 32, chunk: int = 4) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for k0 in range(0, steps, chunk):
        alphas = [(k + 0.5) / steps for k in range(k0, min(steps, k0 + chunk))]
        pts = torch.cat([a * x for a in alphas]).detach().requires_grad_(True)
        tgt = target.repeat(len(alphas))
        g, = torch.autograd.grad(forward(pts).gather(-1, tgt[:, None]).sum(),
                                 pts)
        acc += g.view(len(alphas), *x.shape).sum(0)
    return x * (acc / steps)
