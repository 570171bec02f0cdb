"""The card: its name, count, power limit and memory peak, and the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W)."""

from __future__ import annotations

import functools
import subprocess
from typing import Optional

import torch

#: operations per second by precision, and HBM bytes per second
PEAKS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in W by ``nvidia-smi``, None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(dev: torch.device, count: int) -> dict:
    """The result line's ``device``: platform, kind, cards used, the
    allocator's peak on the fullest of them, and the card's power limit
    (the peaks above hold at 700 W)."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0, "power_limit_w": None}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w(dev.index or 0)}
