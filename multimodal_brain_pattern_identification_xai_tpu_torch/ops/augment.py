"""Train-time spectrogram augmentation (counterpart of the JAX package's
``ops/augment.py``): MixUp against a reference pool, then one time and one
frequency CoarseDropout stripe, for a whole batch at once on its device.

The reference augments per sample on the host with albumentations: MixUp
(p=0.5, image and label mixed by λ ~ Beta(α, α)) and two CoarseDropout
passes, one full-height stripe 6-10 % wide (time) and one full-width
stripe 6-10 % tall (frequency), each p=0.5, zero-filled.

The work is split in two: :func:`draw_augment` makes every random draw
from a ``torch.Generator`` (which cannot reproduce ``jax.random``'s
streams), and :func:`apply_augment` is deterministic given the draws, so
it can be held against the JAX function fed the JAX draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .. import config as C


@dataclass
class StripeDraws:
    """One stripe family: per sample its width and start (pixels, float32)
    and whether it is applied."""
    width: torch.Tensor
    start: torch.Tensor
    gate: torch.Tensor


@dataclass
class AugmentDraws:
    """Per-sample MixUp weight λ, MixUp gate, reference-pool pick, and the
    time (along W) and frequency (along H) stripes."""
    lam: torch.Tensor
    gate: torch.Tensor
    pick: torch.Tensor
    time: StripeDraws
    freq: StripeDraws


def _draw_stripes(g: torch.Generator, batch: int, size: int,
                  frac: Tuple[float, float], prob: float) -> StripeDraws:
    """Width U[frac]·size, start uniform over [0, size − width), gate
    Bernoulli(prob) (CoarseDropout's hole geometry)."""
    dev = g.device
    u = torch.rand(batch, generator=g, device=dev)
    width = (frac[0] + (frac[1] - frac[0]) * u) * size
    start = torch.rand(batch, generator=g, device=dev) * (size - width)
    gate = torch.rand(batch, generator=g, device=dev) < prob
    return StripeDraws(width, start, gate)


def draw_augment(g: torch.Generator, batch: int, n_ref: int,
                 hw: Tuple[int, int],
                 cfg: C.SpecAugmentConfig = C.SpecAugmentConfig()
                 ) -> AugmentDraws:
    """Every draw of one augmentation of ``batch`` (H, W) = ``hw`` planes
    against a pool of ``n_ref``, on the generator's device.  λ ~ Beta(α, α)
    as G₁/(G₁ + G₂) of two Gamma(α) draws, in float64."""
    dev = g.device
    alpha = torch.full((batch,), cfg.mixup_alpha, dtype=torch.float64,
                       device=dev)
    g1 = torch._standard_gamma(alpha, generator=g)
    g2 = torch._standard_gamma(alpha, generator=g)
    lam = (g1 / (g1 + g2)).float()
    gate = torch.rand(batch, generator=g, device=dev) < cfg.mixup_prob
    pick = torch.randint(0, n_ref, (batch,), generator=g, device=dev)
    h, w = hw
    return AugmentDraws(
        lam, gate, pick,
        time=_draw_stripes(g, batch, w, cfg.stripe_frac, cfg.dropout_prob),
        freq=_draw_stripes(g, batch, h, cfg.stripe_frac, cfg.dropout_prob))


def _stripe_mask(s: StripeDraws, size: int) -> torch.Tensor:
    """(B, size) boolean: inside the stripe, where it is applied."""
    pos = torch.arange(size, dtype=torch.float32, device=s.start.device)
    inside = ((pos[None, :] >= s.start[:, None])
              & (pos[None, :] < (s.start + s.width)[:, None]))
    return inside & s.gate[:, None]


def apply_augment(d: AugmentDraws, spec: torch.Tensor, y: torch.Tensor,
                  ref_spec: torch.Tensor, ref_y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MixUp then the two stripes, given the draws.  ``spec`` (B, 3, H, W)
    in [0, 1], ``y`` (B, n_classes) soft targets, the pool ``ref_spec`` /
    ``ref_y``.  Returns augmented ``(spec, y)``; λ is cast to spec's type,
    as the JAX function does."""
    lam = torch.where(d.gate, d.lam, 1.0).to(spec.dtype)
    lam4 = lam[:, None, None, None]
    spec = lam4 * spec + (1.0 - lam4) * ref_spec[d.pick]
    y = lam[:, None] * y + (1.0 - lam[:, None]) * ref_y[d.pick]
    h, w = spec.shape[-2:]
    t_mask = _stripe_mask(d.time, w)
    f_mask = _stripe_mask(d.freq, h)
    keep = (~t_mask[:, None, None, :]) & (~f_mask[:, None, :, None])
    return spec * keep.to(spec.dtype), y


def spectrogram_augment(g: torch.Generator, spec: torch.Tensor,
                        y: torch.Tensor, ref_spec: torch.Tensor,
                        ref_y: torch.Tensor,
                        cfg: C.SpecAugmentConfig = C.SpecAugmentConfig()
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MixUp + time/frequency CoarseDropout with draws from ``g``
    (on the batch's device).  Passing the batch itself as the pool is the
    in-batch variant."""
    d = draw_augment(g, spec.shape[0], ref_spec.shape[0],
                     tuple(spec.shape[-2:]), cfg)
    return apply_augment(d, spec, y, ref_spec, ref_y)
