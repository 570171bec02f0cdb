"""The program's own spans and counters (``profiling.collect()`` of the
port), the one place the metrics that read them touch the port.

The port records spans and counters while a profiler session records, so
a run's traced segment turns them on and its timed window runs with them
off; ``mbx.setup.*`` spans are recorded always.  A run is one process, so
what :func:`collected` returns is that run's.  Each reader returns None
where the port has no ``profiling.collect`` (a commit older than its
spans) or the spans it reads are absent.
"""

from __future__ import annotations

from typing import Iterable, Optional


def collected():
    """The port's ``profiling.collect()``, or None where it has none."""
    try:
        from multimodal_brain_pattern_identification_xai_tpu_torch import (
            profiling)
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    return None if collect is None else collect()


def per_request(c, names: Iterable[str], counter: str, field: str = "device_ms",
                graph: bool = False) -> Optional[float]:
    """The sum of ``field`` (ms) over the spans ``names`` (graph or eager
    sums), divided by the counter ``counter``; None where the counter is
    zero or none of the spans was recorded (with device times, for a
    device field: a CPU run has none)."""
    if c is None:
        return None
    n = c.counters.get(counter, 0)
    sums = c.graph_sums if graph else c.sums
    need = "timed" if field.endswith("device_ms") else "calls"
    got = [sums[k] for k in names if k in sums and getattr(sums[k], need)]
    if not n or not got:
        return None
    return sum(getattr(s, field) for s in got) / n


def total_s(c, name: str, field: str = "host_ms") -> Optional[float]:
    """The sum of ``field`` over every span ``name``, in seconds; None
    where there was none."""
    if c is None or name not in c.sums or not c.sums[name].calls:
        return None
    return getattr(c.sums[name], field) / 1e3
