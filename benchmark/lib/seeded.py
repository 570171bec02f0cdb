"""Weights and inputs made on the device from ``--seed``, in a few large
calls of one ``torch.Generator``.

Weights (float32, the type the program keeps its parameters in): conv and
linear weights ~ N(0, GAIN/fan_in), biases and BatchNorm running means ~
N(0, 0.1²), BatchNorm scales ~ 1 + N(0, 0.1²), running variances ~
U(0.5, 1.5).  At GAIN 1 the EfficientNetV2-B2 branch's output moves by
~4e-5 from one window to the next (the running statistics do not match
its activations, which shrink block by block), so a fault in its input
would not show; at 2 it diverges; 1.4 keeps both branches finite and
moved by their input.

Windows: raw EEG (pool, batch, 20, T) µV, white noise of 20 µV plus one
oscillation a window of 40 µV at 1-25 Hz and a random phase; raw
spectrograms (pool, batch, H, W), U(0, 10) with a 1/f-like decay down the
rows, plus BLOBS events a window: Gaussian bumps of random place, extent
(5-45 rows, 10-90 columns) and height (0-30), so that windows differ at
the scale that the networks' global pooling keeps.  Every seed gives the
same sizes; only the values change.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

GAIN = 1.4
BLOBS = 3


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def weights(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator,
            device: torch.device) -> Dict[str, torch.Tensor]:
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        z, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if name.endswith("running_var"):
            v = 0.5 + u
        elif name.endswith(("running_mean", "bias")):
            v = 0.1 * z
        elif len(shape) == 1:                           # BatchNorm scale
            v = 1.0 + 0.1 * z
        else:
            v = z * math.sqrt(GAIN / math.prod(shape[1:]))
        out[name] = v.clone()
    return out


def windows(gen: torch.Generator, device: torch.device, pool: int, batch: int,
            n_points: int, plane: Sequence[int], fs: float = 200.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw EEG (pool, batch, 20, n_points), raw spectrograms (pool, batch,
    H, W)), float32 on ``device``."""
    eeg = torch.randn((pool, batch, 20, n_points), generator=gen,
                      device=device).mul_(20.0)
    f = 1.0 + 24.0 * torch.rand((pool, batch, 1, 1), generator=gen,
                                device=device)
    phase = 2 * math.pi * torch.rand((pool, batch, 1, 1), generator=gen,
                                     device=device)
    t = torch.arange(n_points, device=device, dtype=torch.float32) / fs
    eeg.add_(40.0 * torch.sin(2 * math.pi * f * t + phase))
    h, w = plane
    spec = torch.rand((pool, batch, h, w), generator=gen, device=device)
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    spec.mul_(10.0 / (1.0 + rows / 20.0))
    for _ in range(BLOBS):
        r0, c0, sr, sc, a = torch.rand((5, pool, batch, 1, 1), generator=gen,
                                       device=device)
        spec.add_(30.0 * a
                  * torch.exp(-0.5 * ((rows - r0 * h) / (5 + 40 * sr)) ** 2)
                  * torch.exp(-0.5 * ((cols - c0 * w) / (10 + 80 * sc)) ** 2))
    return eeg, spec


def cell_inputs(cfg: dict, traffic: dict, seed: int, device: torch.device):
    """A cell's weights (the reference's names and shapes for the
    configuration's model) and its pool of windows, from one generator."""
    from ..reference.models import fusion_shapes
    gen = generator(seed, device)
    w = weights(fusion_shapes(cfg), gen, device)
    return (w, *windows(gen, device, traffic["pool"], traffic["batch"],
                        traffic["n_points"], traffic["plane"]))
