"""Device time by kernel on one card, read with ``torch.profiler``.

:func:`profile_kernels` runs a callable under the profiler (CUPTI
tracing) and sums the device time of every kernel by name, per call; it
counts the kernels a call launches, the launches inside a replayed CUDA
graph included.  :func:`fft_conv_ms` picks out cuDNN's FFT convolution
(its transforms, pointwise complex products and complex GEMMs).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Callable, Dict

import torch

#: kernel names of cuDNN's FFT convolution
FFT_CONV = re.compile(r"fft|complex|region_transform|cgemm", re.IGNORECASE)


@dataclass
class KernelProfile:
    wall_ms: float             # host clock per call, profiler on
    kernel_ms: Dict[str, float]  # device ms per call, by kernel name
    kernels: float             # kernels launched per call
    copies: float              # memcpy / memset operations per call
    kernel_calls: Dict[str, float]  # launches per call, by kernel name

    @property
    def busy_ms(self) -> float:
        return sum(self.kernel_ms.values())


def profile_kernels(fn: Callable[[], object], reps: int = 3,
                    warmup: int = 2) -> KernelProfile:
    """``fn()`` ``warmup`` times, then ``reps`` times under the profiler;
    every number is per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernel_ms: Dict[str, float] = {}
    kernel_calls: Dict[str, float] = {}
    kernels = copies = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.name.startswith(("Memcpy", "Memset")):
            copies += 1
            continue
        kernels += 1
        kernel_ms[ev.name] = (kernel_ms.get(ev.name, 0.0)
                              + ev.time_range.elapsed_us() / 1e3 / reps)
        kernel_calls[ev.name] = kernel_calls.get(ev.name, 0.0) + 1.0 / reps
    return KernelProfile(wall_ms, kernel_ms, kernels / reps, copies / reps,
                         kernel_calls)


def fft_conv_ms(prof: KernelProfile) -> float:
    """Device ms per call in cuDNN's FFT convolution kernels."""
    return sum(ms for name, ms in prof.kernel_ms.items()
               if FFT_CONV.search(name))
