"""Seeding (counterpart of the JAX package's ``utils/seed.py``).

Seeds the host's ``random`` and numpy generators and ``PYTHONHASHSEED``,
and returns a ``torch.Generator`` seeded with the seed where the JAX
version returns a ``PRNGKey``.  torch's global generator is left alone:
the port draws from explicit generators.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)
