"""Device time read with ``torch.profiler`` (CUPTI tracing), the
benchmark's own reader.

:func:`trace_segment` reads what the program's
``profiling.profile_kernels`` reads (the device time of every kernel by
name, per call, the launches inside a replayed CUDA graph included) over
``n`` calls of a request inside one ``bench.segment`` span, and adds what
the metrics need besides: the busy time (the union of every kernel, copy
and set on the device) over the segment's length, each ``bench.*`` span's
device seconds (the kernels launched while it was open, from any thread:
autograd launches a backward from its own), and the longest idle gaps
with the host operation under each.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

SEGMENT = "bench.segment"


@dataclass
class Segment:
    calls: int
    window_s: float                       # the segment's length
    busy_s: float                         # union of device activity in it
    device_s: Dict[str, float]            # by operation name, whole segment
    span_s: Dict[str, float] = field(default_factory=dict)  # per call
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_s(self, pattern: str) -> float:
        """Device seconds per call of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.device_s.items()
                   if rx.search(n)) / self.calls

    def top_ops(self, n: int = 10) -> List[List]:
        return [[name[:200], s] for name, s in sorted(
            self.device_s.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def trace_segment(fn: Callable[[int], object], calls: int,
                  gaps: int = 10) -> Segment:
    """``fn(i)`` for i < ``calls`` under the profiler, in one span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(SEGMENT):
            for i in range(calls):
                fn(i)
            sync()
    events = prof.events()
    seg = [e for e in events if e.name == SEGMENT
           and e.device_type == torch.autograd.DeviceType.CPU]
    if not seg:
        raise RuntimeError("the profiler recorded no segment span")
    lo, hi = seg[0].time_range.start, seg[0].time_range.end
    device_s: Dict[str, float] = {}
    busy: List[Tuple[float, float]] = []
    cpu: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    launches: List[Tuple[float, float]] = []      # (host time, device µs)
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("bench."):              # the spans' own
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.name != SEGMENT:
                spans.append((a, b, ev.name))
                cpu.append((a, b, ev.name))
            continue                                  # device annotations
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_s[ev.name] = device_s.get(ev.name, 0.0) + (b - a) / 1e6
            busy.append((max(a, lo), min(b, hi)))
        else:
            cpu.append((a, b, ev.name))
            if ev.kernels:
                launches.append((a, sum(k.duration for k in ev.kernels)))
    # a span's device time: the kernels launched while it was open, from
    # any thread (autograd's backward launches from its own)
    span_us: Dict[str, float] = {}
    for t, us in launches:
        for a, b, name in spans:
            if a <= t <= b:
                span_us[name] = span_us.get(name, 0.0) + us
                break
    merged = _union([(a, b) for a, b in busy if b > a])
    busy_us = sum(b - a for a, b in merged)
    holes, at = [], lo
    for a, b in merged:
        if a > at:
            holes.append((at, a))
        at = max(at, b)
    if hi > at:
        holes.append((at, hi))
    named = []
    for a, b in sorted(holes, key=lambda h: h[0] - h[1])[:gaps]:
        mid = (a + b) / 2
        over = [c for c in cpu if c[0] <= mid <= c[1]]
        label = max(over, key=lambda c: c[0])[2] if over else "host (no op)"
        named.append((label, (b - a) / 1e6))
    return Segment(calls=calls, window_s=(hi - lo) / 1e6,
                   busy_s=busy_us / 1e6, device_s=device_s,
                   span_s={k: v / 1e6 / calls for k, v in span_us.items()},
                   idle_gaps=named)
