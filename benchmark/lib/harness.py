"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), then the comparison with the reference once the
program's state is freed.  Returns the result line."""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from . import device, registry
from .profile import Segment


@dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cell: registry.Cell
    traffic: dict
    program: dict
    segment: Segment
    window: dict                     # attempted, failed, seconds
    flops: Dict[str, float]          # a request's operations by precision
    peaks: Dict[str, float]
    hbm_bytes_per_s: float


def _number(v: float):
    return v if math.isfinite(v) else str(v)


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, sizes: Optional[dict] = None,
        tamper: Optional[Callable[[object], None]] = None,
        phases: Optional[Dict[str, float]] = None) -> dict:
    """``phases``: seconds the caller spent before this call, by phase
    (printed on the ``setup`` line; the rest until now is ``imports``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = registry.kind(cell.traffic["kind"])
    phases = dict(phases or {})
    phases["imports"] = time.time() - t_start - sum(phases.values())
    st = kind.setup(cell, seed, dev, sizes or {})
    if tamper is not None:
        tamper(st)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                              {**phases, **st.phases}.items()),
          file=sys.stderr)
    win = kind.window(st, seconds)
    dev_line = device.describe(dev, cell.chips)
    metrics, breakdown = {}, None
    if trace:
        seg = kind.trace(st)
        ctx = Context(cell, st.traffic, st.prog, seg, win, kind.flops(st),
                      device.PEAKS, device.HBM_BYTES_PER_S)
        for m in cell.per_layer:
            v = registry.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_line.update(busy_s=seg.busy_s, window_s=seg.window_s)
        breakdown = {"device_ops": seg.top_ops(),
                     "idle_gaps": [[n, s] for n, s in seg.idle_gaps]}
    else:
        values = {**win["end_to_end"], "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    kind.release(st)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.judge(st)
    correct = win["failed"] == 0 and all(
        name in cell.limits and v <= cell.limits[name]
        for name, v in checks.items())
    line = {"correct": bool(correct), "attempted": int(win["attempted"]),
            "failed": int(win["failed"]), "metrics": metrics,
            "device": dev_line}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": _number(v),
                             "limit": cell.limits.get(name)}
                      for name, v in checks.items()}
    return line
