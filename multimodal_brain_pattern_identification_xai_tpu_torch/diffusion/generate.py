"""Class-conditional generation and dataset rebalancing (counterpart of
the JAX package's ``diffusion/generate.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .process import DenoiseFn, Draws, reverse_diffusion
from .schedule import DiffusionSchedule


def _prior(class_id: int, n_samples: int, n_channels: int, n_classes: int,
           spec_shape: Tuple[int, int], device: torch.device):
    """One-hot labels of ``class_id`` and the zeros spectrogram prior."""
    y = F.one_hot(torch.full((n_samples,), class_id, device=device),
                  n_classes).float()
    spec = torch.zeros((n_samples, n_channels) + tuple(spec_shape),
                       device=device)
    return y, spec


def generate_for_class(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
                       rng: Union[torch.Generator, Draws], class_id: int,
                       n_samples: int, n_channels: int = 19,
                       length: int = 2000, n_classes: int = 6,
                       spec_shape: Tuple[int, int] = (50, 50)) -> np.ndarray:
    """``n_samples`` EEG windows of one class from a zeros spectrogram
    prior, on the schedule's device; host numpy (n, C, length)."""
    dev = schedule.beta.device
    y, spec = _prior(class_id, n_samples, n_channels, n_classes, spec_shape,
                     dev)
    x = reverse_diffusion(schedule, denoise_fn, rng, n_samples, y, spec,
                          (n_channels, length))
    return x.cpu().numpy()


def generate_for_class_cached(schedule: DiffusionSchedule, model,
                              rng: Union[torch.Generator, Draws],
                              class_id: int, n_samples: int,
                              n_channels: int = 19, length: int = 2000,
                              n_classes: int = 6,
                              spec_shape: Tuple[int, int] = (50, 50)
                              ) -> np.ndarray:
    """:func:`generate_for_class` with ``model``'s (a ``DiffEEG`` in eval
    mode, with the weights to sample with) class and spectrogram
    conditioning computed once before the reverse loop."""
    from ..models.diffeeg import make_cached_denoiser
    dev = schedule.beta.device
    y, spec = _prior(class_id, n_samples, n_channels, n_classes, spec_shape,
                     dev)
    den = make_cached_denoiser(model, y, spec, length)
    x = reverse_diffusion(schedule, den, rng, n_samples, y, spec,
                          (n_channels, length))
    return x.cpu().numpy()


def augment_dataset_balanced(x_real: np.ndarray, y_real: np.ndarray,
                             generated: Dict[int, np.ndarray],
                             seed: int = 42,
                             target_per_class: Optional[int] = None,
                             groups: Optional[np.ndarray] = None,
                             synthetic_group_start: int = 100_000):
    """Merge real data with per-class synthetic EEG so every class reaches
    the majority-class count (or ``target_per_class``), then shuffle with
    ``default_rng(seed)``.

    ``y_real``: (N, n_classes) soft labels or (N,) int labels;
    ``generated``: class id → (M_c, ...) synthetic windows; ``groups``:
    optional (N,) CV group ids, the synthetic samples getting fresh ids
    counting from ``synthetic_group_start``.  Returns ``(x, y)``, or
    ``(x, y, groups)`` when ``groups`` is given."""
    if y_real.ndim == 1:
        n_classes = int(y_real.max()) + 1
        y_soft = np.eye(n_classes, dtype=np.float32)[y_real]
    else:
        y_soft = y_real.astype(np.float32)
        n_classes = y_soft.shape[1]
    hard = y_soft.argmax(1)
    counts = np.bincount(hard, minlength=n_classes)
    target = int(target_per_class or counts.max())

    xs, ys = [x_real], [y_soft]
    gs = [np.asarray(groups)] if groups is not None else None
    next_group = int(max(synthetic_group_start,
                         (np.asarray(groups).max() + 1)
                         if groups is not None and len(x_real) else 0))
    for c in range(n_classes):
        need = target - counts[c]
        pool = generated.get(c)
        if need <= 0 or pool is None or len(pool) == 0:
            continue
        take = min(need, len(pool))
        xs.append(pool[:take].astype(x_real.dtype))
        ys.append(np.eye(n_classes, dtype=np.float32)[np.full(take, c)])
        if gs is not None:
            gs.append(np.arange(next_group, next_group + take,
                                dtype=np.asarray(groups).dtype))
            next_group += take
    x_all = np.concatenate(xs, axis=0)
    y_all = np.concatenate(ys, axis=0)
    perm = np.random.default_rng(seed).permutation(len(x_all))
    if gs is not None:
        return x_all[perm], y_all[perm], np.concatenate(gs)[perm]
    return x_all[perm], y_all[perm]
