"""Forward and reverse diffusion (counterpart of the JAX package's
``diffusion/process.py``).

The reverse samplers are a host loop over t = T−1 … 0, one denoiser call
a step, that never waits for the device: the step's constants are 0-d
views of the schedule's tensors, and the NaN freeze guard is a
``torch.where`` on a device boolean.

Draws come from an explicit ``torch.Generator`` on the device.  Every
sampler also takes the draws themselves in its place, ``(x_T, noise)``
with ``noise(i)`` the re-noising draw of the i-th step (t = T−1−i, asked
for t > 0 only): that is how tests feed the JAX package's draws in.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .schedule import DiffusionSchedule

#: the draws of one reverse trajectory: x_T and the per-step noise
Draws = Tuple[torch.Tensor, Callable[[int], torch.Tensor]]
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor], torch.Tensor]


def q_sample(schedule: DiffusionSchedule,
             rng: Union[torch.Generator, torch.Tensor], x0: torch.Tensor,
             t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward diffusion ``x_t = √ᾱ_t x₀ + √(1−ᾱ_t) ε``; ``t``: (B,) int
    steps; ``rng``: a generator on x0's device, or ε itself.  Returns
    ``(x_t, ε)``."""
    noise = rng if isinstance(rng, torch.Tensor) else torch.randn(
        x0.shape, generator=rng, device=x0.device, dtype=x0.dtype)
    a = schedule.alpha_bar[t].reshape((-1,) + (1,) * (x0.ndim - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise, noise


def draws(rng: Union[torch.Generator, Draws],
          shape: Tuple[int, ...]) -> Draws:
    """``rng``'s draws for one trajectory of ``shape``: x_T drawn now and
    each step's noise when asked for, from the generator's device; or
    ``rng`` itself when it already holds them."""
    if not isinstance(rng, torch.Generator):
        return rng

    def normal(_i: int) -> torch.Tensor:
        return torch.randn(shape, generator=rng, device=rng.device)
    return normal(-1), normal


@torch.no_grad()
def reverse_diffusion(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
                      rng: Union[torch.Generator, Draws], batch_size: int,
                      class_labels: torch.Tensor, spectrogram: torch.Tensor,
                      shape: Tuple[int, int],
                      nan_guard: bool = True) -> torch.Tensor:
    """The reference's reverse sampler.

    The update is kept as the reference has it: ``x ← x − β_t ε̂``, plus
    ``√β_t ε`` for t > 0.  With ``nan_guard`` a step whose result is not
    all finite keeps the previous x, and the loop goes on from it.

    ``denoise_fn(x, y_onehot, t_float, spec) → ε̂``; ``shape`` is
    (n_channels, T) of the generated EEG."""
    x, noise = draws(rng, (batch_size,) + tuple(shape))
    T = schedule.timesteps
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_vec = torch.full((batch_size,), float(t), device=x.device)
        eps = denoise_fn(x, class_labels, t_vec, spectrogram)
        x_new = x - schedule.beta[t] * eps
        if t > 0:
            x_new = x_new + schedule.noise_scale[t] * noise(i)
        if nan_guard:
            x_new = torch.where(torch.isfinite(x_new).all(), x_new, x)
        x = x_new
    return x


@torch.no_grad()
def ddpm_sample(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
                rng: Union[torch.Generator, Draws], batch_size: int,
                class_labels: torch.Tensor, spectrogram: torch.Tensor,
                shape: Tuple[int, int]) -> torch.Tensor:
    """Textbook DDPM ancestral sampler over the linear-β schedule:
    ``x ← (x − β/√(1−ᾱ) ε̂)/√α + √β ε`` (no noise at t = 0)."""
    beta = schedule.beta
    alpha = 1.0 - beta
    alpha_bar = torch.cumprod(alpha, 0)
    x, noise = draws(rng, (batch_size,) + tuple(shape))
    T = schedule.timesteps
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_vec = torch.full((batch_size,), float(t), device=x.device)
        eps = denoise_fn(x, class_labels, t_vec, spectrogram)
        coef = beta[t] / torch.sqrt(1.0 - alpha_bar[t])
        x = (x - coef * eps) / torch.sqrt(alpha[t])
        if t > 0:
            x = x + torch.sqrt(beta[t]) * noise(i)
    return x
