"""Tracing and timing helpers (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace around a block,
written as a Chrome trace with the program's ``mbx.*`` spans beside the
kernels, and the wall-clock timing of a callable with the device
synchronised after every call.  The port's top-level ``profiling`` module
holds the spans and sums a trace's device time by kernel."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block (CPU activity, and CUDA activity where a card is
    present) with the program's tracing on, so its ``mbx.*`` spans are ops
    of the trace, and write ``<log_dir>/trace.json`` (a Chrome trace) at
    its end.  ``log_dir`` defaults to a new directory under the system's
    temporary directory.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from .. import profiling

    log_dir = log_dir or tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profiling.traced(), profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark_fn(fn: Callable[[], Any], warmup: int = 2,
                 iters: int = 10) -> Dict[str, float]:
    """Wall-clock ``fn()``: ``warmup`` calls excluded (they build kernels
    and warm caches), the device synchronised after every call (on CUDA;
    ``block_until_ready`` in the JAX version).  Returns ``mean_s``,
    ``median_s``, ``min_s``, ``max_s`` and ``iters``."""
    for _ in range(warmup):
        fn()
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_s": sum(times) / len(times),
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "iters": iters,
    }
