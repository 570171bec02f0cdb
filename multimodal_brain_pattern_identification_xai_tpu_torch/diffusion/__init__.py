"""DiffEEG diffusion engine (counterpart of the JAX package's
``diffusion/``): schedules, forward and reverse processes, EMA,
generation-quality metrics, class-conditional generation and dataset
rebalancing."""

from .schedule import (cosine_alpha_schedule, linear_beta_schedule,  # noqa: F401
                       DiffusionSchedule, make_schedule)
from .process import (q_sample, reverse_diffusion,  # noqa: F401
                      ddpm_sample)
from .ema import EMA, ema_update  # noqa: F401
from .metrics import (compute_mmd, compute_frechet_distance,  # noqa: F401
                      pearson_correlation)
from .generate import (generate_for_class, generate_for_class_cached,  # noqa: F401
                       augment_dataset_balanced)
