"""Noise schedules (counterpart of the JAX package's
``diffusion/schedule.py``).

Two schedules side by side, as the reference keeps them: a linear β in
[1e-4, 0.02] for the reverse sampler's step size and re-noising scale, and
a cosine ᾱ for the forward q-sample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """β_t, a linear ramp, float32."""
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)


def cosine_alpha_schedule(timesteps: int, s: float = 0.008):
    """Cosine ᾱ_t and the reference's β (float32).

    The reference's ``beta = 1 - alpha/alpha[0]`` is a cumulative
    quantity, not a per-step β; it is kept as it is, since the forward
    process reads only ᾱ."""
    f_t = np.cos((np.linspace(0, 1, timesteps) + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bar = f_t / f_t[0]
    beta = 1.0 - alpha_bar / alpha_bar[0]
    return alpha_bar.astype(np.float32), beta.astype(np.float32)


class DiffusionSchedule(NamedTuple):
    """Every per-step constant, as float32 tensors on one device."""
    alpha_bar: torch.Tensor    # (T,) cosine ᾱ for q-sample
    beta: torch.Tensor         # (T,) linear β for the reverse update
    noise_scale: torch.Tensor  # (T,) √β re-noising scale
    timesteps: int

    @property
    def num_timesteps(self) -> int:
        return self.timesteps


def make_schedule(timesteps: int = 1000,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> DiffusionSchedule:
    """The schedule on ``device`` (the CPU when None)."""
    alpha_bar, _ = cosine_alpha_schedule(timesteps)
    beta = torch.as_tensor(linear_beta_schedule(timesteps), device=device)
    return DiffusionSchedule(
        alpha_bar=torch.as_tensor(alpha_bar, device=device), beta=beta,
        noise_scale=torch.sqrt(beta), timesteps=timesteps)
