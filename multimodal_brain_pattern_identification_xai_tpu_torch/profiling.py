"""The port's tracing: spans and counters at its layer boundaries, and
device time by kernel read with ``torch.profiler``.

**Spans.** ``with span("mbx.<layer>.<part>"):`` marks one layer's work.
Tracing is on while a ``torch.profiler`` session records, or inside
:func:`traced`; off, a span costs one flag read and records nothing, and
:func:`count` adds nothing.
On, a span opens a ``RecordFunctionFast`` range (a CPU op of that name on
the profiler's clock, not a user annotation, so it makes no device-side
range) and keeps a :class:`SpanRecord`: its name, its parent (the span
open around it on the same thread), a request id (a span opened with none
around it starts a request, its children share it), host start and end
(``time.perf_counter_ns``), and for a span opened with ``device=True``
where CUDA is initialised, two timing events on the current stream, read
later without a sync inside the span; a read pair serves a later span.  Self
time is a span's time less the part its child spans cover.  Spans
named ``mbx.setup.*`` are recorded whether tracing is on or not: they run
once a process, on no request's path.

**Spans inside a captured CUDA graph.** While :func:`capturing` is open
(``entry.capture_forward`` opens it around the capture), every span
records its two timing events into the graph (``external=True``: event
record nodes), so the graph measures its own layers on every replay.
:class:`GraphSpans` turns a replay's events into ``graph=True`` records
of a request; ``capture_forward``'s replay reads the previous traced
replay's before it launches the next one.  A graph's layers are timed on
the device whether or not their spans ask for it.

**Reading.** :func:`collect` synchronises once, resolves what is pending
and returns :class:`Collected`: the last :data:`MAX_SPANS` records and the
sums by name (calls, host ms, device ms, self times), eager and graph apart,
and the counters.  :func:`reset` clears them.

:func:`profile_kernels` runs a callable under the profiler (CUPTI
tracing) and sums the device time of every kernel by name, per call; it
counts the kernels a call launches, the launches inside a replayed CUDA
graph included.  :func:`fft_conv_ms` picks out cuDNN's FFT convolution
(its transforms, pointwise complex products and complex GEMMs).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: kernel names of cuDNN's FFT convolution
FFT_CONV = re.compile(r"fft|complex|region_transform|cgemm", re.IGNORECASE)
#: raw span records kept for :func:`collect` (the sums keep everything)
MAX_SPANS = 4096
#: spans recorded with tracing off too
SETUP = "mbx.setup."
#: a graph's replays read before their records are made
KEEP_READS = 64

_enabled = False
_capture: Optional["GraphSpans"] = None
_local = threading.local()
_lock = threading.Lock()
_requests = itertools.count(1)
_records: Deque["SpanRecord"] = collections.deque(maxlen=MAX_SPANS)
_sums: Dict[str, "SpanSum"] = {}
_graph_sums: Dict[str, "SpanSum"] = {}
_counters: Dict[str, float] = {}
_pending: Deque["_Span"] = collections.deque()      # device times unread
_pending_graphs: Dict[int, "GraphSpans"] = {}       # replays unread
_free_events: Dict[int, List[torch.cuda.Event]] = {}   # by device, read


def tracing() -> bool:
    """Whether spans and counters record: a profiler session records, or
    inside :func:`traced`."""
    return _enabled or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def traced() -> Iterator[None]:
    """Tracing on inside the block, as it was after it."""
    global _enabled
    was, _enabled = _enabled, True
    try:
        yield
    finally:
        _enabled = was


@dataclass
class SpanRecord:
    name: str
    parent: Optional[str]
    request: int
    graph: bool = False                 # timed by event nodes of a graph
    start_ns: int = 0                   # host clock; 0 for graph spans
    end_ns: int = 0
    device_ms: Optional[float] = None   # None: no device events
    self_host_ms: float = 0.0
    self_device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class SpanSum:
    calls: int = 0
    timed: int = 0                      # calls with device times
    host_ms: float = 0.0
    device_ms: float = 0.0
    self_host_ms: float = 0.0
    self_device_ms: float = 0.0

    def add(self, r: SpanRecord) -> None:
        self.calls += 1
        self.host_ms += r.host_ms
        self.self_host_ms += r.self_host_ms
        if r.device_ms is not None:
            self.timed += 1
            self.device_ms += r.device_ms
            self.self_device_ms += r.self_device_ms


@dataclass
class Collected:
    spans: List[SpanRecord]
    sums: Dict[str, SpanSum]            # eager spans, by name
    graph_sums: Dict[str, SpanSum]      # graph=True spans, by name
    counters: Dict[str, float]


def _stack() -> List["_Span"]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _store(rec: SpanRecord) -> None:
    with _lock:
        _records.append(rec)
        sums = _graph_sums if rec.graph else _sums
        s = sums.get(rec.name)
        if s is None:
            s = sums[rec.name] = SpanSum()
        s.add(rec)


class _Span:
    """One open span on this thread (tracing on)."""

    __slots__ = ("rec", "up", "rf", "ev", "dev", "timed", "child_ns",
                 "child_dev")

    def __init__(self, name: str, timed: bool):
        self.rec = SpanRecord(name, None, 0)
        self.timed = timed
        self.child_ns = 0
        self.child_dev = 0.0
        self.ev = None

    @property
    def request(self) -> int:
        return self.rec.request

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.up = stack[-1] if stack else None
        rec = self.rec
        rec.parent = self.up.rec.name if self.up else None
        rec.request = self.up.rec.request if self.up else next(_requests)
        self.rf = torch._C._profiler._RecordFunctionFast(rec.name)
        self.rf.__enter__()
        if self.timed and torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            self.dev = stream.device_index
            free = _free_events.get(self.dev)
            self.ev = ((free.pop(), free.pop()) if free else
                       (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)))
            self.ev[0].record(stream)
        stack.append(self)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        if self.ev is not None:
            self.ev[1].record()
        self.rf.__exit__(*exc)
        _stack().pop()
        dur = rec.end_ns - rec.start_ns
        rec.self_host_ms = (dur - self.child_ns) / 1e6
        if self.up is not None:
            self.up.child_ns += dur
        if self.ev is None:
            _store(rec)
            return
        with _lock:
            _pending.append(self)
            full = len(_pending) > MAX_SPANS
        if full:
            _resolve(1)

    def resolve(self) -> None:
        """Read the device time (waits for the end event)."""
        self.ev[1].synchronize()
        dev = self.ev[0].elapsed_time(self.ev[1])
        self.rec.device_ms = dev
        self.rec.self_device_ms = dev - self.child_dev
        if self.up is not None:
            self.up.child_dev += dev
        # read: the pair serves another span (creating and destroying
        # events costs two runtime calls each, CUPTI-traced when profiled)
        _free_events.setdefault(self.dev, []).extend(self.ev)
        self.ev = None
        _store(self.rec)


def _resolve(n: Optional[int] = None) -> None:
    """Read the device times of the ``n`` oldest pending spans (all)."""
    while True:
        with _lock:
            if not _pending or n == 0:
                return
            sp = _pending.popleft()
        sp.resolve()
        if n is not None:
            n -= 1


class _GraphSpan:
    """A span opened while a graph is captured: two timing events recorded
    into the graph."""

    __slots__ = ("cap", "name", "index")

    def __init__(self, cap: "GraphSpans", name: str):
        self.cap, self.name = cap, name

    def __enter__(self) -> "_GraphSpan":
        self.index = self.cap._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self.cap._close(self.index)


class GraphSpans:
    """The spans recorded into one captured graph: each one's name, the
    index of its parent and two timing events.  ``pending(request)`` marks
    the replay just launched as ``request``'s; ``flush`` reads its times
    (before the next replay overwrites the events) and keeps them until
    :func:`collect` (or :data:`KEEP_READS` of them) turns them into
    ``graph=True`` records."""

    def __init__(self):
        self.names: List[str] = []
        self.parents: List[Optional[int]] = []
        self.events: List[tuple] = []
        self.thread = threading.get_ident()
        self._open_at: List[int] = []
        self._last: Optional[int] = None     # its end event completes last
        self._request: Optional[int] = None  # a replay marked unread
        self._reads: List[tuple] = []        # (request, ms of each span)

    def __len__(self) -> int:
        return len(self.names)

    def _open(self, name: str) -> int:
        i = len(self.names)
        self.names.append(name)
        self.parents.append(self._open_at[-1] if self._open_at else None)
        ev = (torch.cuda.Event(enable_timing=True, external=True),
              torch.cuda.Event(enable_timing=True, external=True))
        ev[0].record()
        self.events.append(ev)
        self._open_at.append(i)
        return i

    def _close(self, i: int) -> None:
        self.events[i][1].record()
        self._open_at.pop()
        self._last = i

    def times(self) -> List[float]:
        """Device ms of each span in the last replay (waits for it: the
        events are nodes of one stream, so the last recorded completes
        last)."""
        self.events[self._last][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def pending(self, request: int) -> None:
        with _lock:
            _pending_graphs[id(self)] = self
        self._request = request

    def flush(self) -> None:
        if self._request is None:
            return
        request, self._request = self._request, None
        self._reads.append((request, self.times()))
        if len(self._reads) >= KEEP_READS:
            self._store()

    def _store(self) -> None:
        reads, self._reads = self._reads, []
        for request, ms in reads:
            child = [0.0] * len(ms)
            for i, p in enumerate(self.parents):
                if p is not None:
                    child[p] += ms[i]
            for i, name in enumerate(self.names):
                p = self.parents[i]
                _store(SpanRecord(name, None if p is None else self.names[p],
                                  request, graph=True, device_ms=ms[i],
                                  self_device_ms=ms[i] - child[i]))


@contextlib.contextmanager
def capturing() -> Iterator[GraphSpans]:
    """Open around a CUDA graph's capture: spans opened inside record
    their timing events into the graph; yields the :class:`GraphSpans`."""
    global _capture
    cap = GraphSpans()
    _capture = cap
    try:
        yield cap
    finally:
        _capture = None


_NULL = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context manager timing one layer's work (see the module's
    docstring) on the host, and with ``device=True`` on the device too.
    Off, the shared null context (it yields None)."""
    if name.startswith(SETUP):
        return _Span(name, timed=False)
    if _capture is not None and _capture.thread == threading.get_ident():
        return _GraphSpan(_capture, name)
    if tracing():
        return _Span(name, timed=device)
    return _NULL


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (tracing on only)."""
    if tracing():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def collect() -> Collected:
    """Synchronise once, read every pending device time and graph replay,
    and return the records and sums so far."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _resolve()
    with _lock:
        graphs = list(_pending_graphs.values())
        _pending_graphs.clear()
    for g in graphs:
        g.flush()
        g._store()
    with _lock:
        return Collected(list(_records),
                         {k: SpanSum(**vars(v)) for k, v in _sums.items()},
                         {k: SpanSum(**vars(v))
                          for k, v in _graph_sums.items()},
                         dict(_counters))


def reset() -> None:
    """Forget every record, sum and counter (pending reads are dropped)."""
    with _lock:
        _records.clear()
        _sums.clear()
        _graph_sums.clear()
        _counters.clear()
        _pending.clear()
        _pending_graphs.clear()
        _free_events.clear()


# ---------------------------------------------------------------------------
# device time by kernel

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
