"""Explanation traffic: one client in a closed loop.  Each request is one
batch of raw windows from a pool of seeded batches on the device, in turn:
the program preprocesses it, takes the saliency of both branches for the
fused model's argmax and the integrated gradients of the EEG branch for
its own argmax, and the maps are copied to the host, where the request
ends.

Parameters (``traffic/<mix>.json``): ``batch``, ``pool``, ``n_points``,
``plane``, ``ig_steps``, ``program``, ``trace_requests``, ``tie`` (how
far below the reference's best logit a target may lie and still count as
the argmax).

Correctness: for each pool batch, one answer of the window drawn from the
seed (reservoir sampling), against the reference's maps of that batch:
the largest relative L2 error of a sample's map (``eeg_saliency_err``,
``spec_saliency_err``, ``ig_err``).  Where the program's target is not
within ``tie`` of the reference's best logit, the reference's map is of
its own argmax, and the map's error shows it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..lib import counters, profile, seeded
from ..lib.program import Explaining, no_span
from ..reference import cells


@dataclass
class State:
    cfg: dict
    prog: dict
    traffic: dict
    dev: torch.device
    seed: int
    weights: Dict[str, torch.Tensor]
    eeg: torch.Tensor
    spec: torch.Tensor
    program: Optional[Explaining]
    kept: Dict[int, tuple] = field(default_factory=dict)
    host: Optional[tuple] = None
    phases: Dict[str, float] = field(default_factory=dict)    # set-up, s

    def request(self, i: int, span=no_span) -> Tuple[tuple, bool]:
        """The maps and targets of request ``i`` in the client's host
        buffers (page-locked, made once and reused, as a client that
        streams maps to disk holds them), and whether every map is finite
        (read on the device)."""
        k = i % self.traffic["pool"]
        out = self.program.request(self.eeg[k], self.spec[k], span)
        finite = torch.stack([torch.isfinite(t).all() for t in out[:3]]).all()
        if self.host is None:
            pin = self.dev.type == "cuda"
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=pin) for t in out)
        for h, t in zip(self.host, out):
            h.copy_(t, non_blocking=True)
        return self.host, bool(finite)


def setup(cell, seed: int, dev: torch.device, sizes: dict) -> State:
    tr = {**cell.traffic, **sizes}
    cfg = cell.config
    prog = cfg["programs"][tr["program"]]
    t0 = time.perf_counter()
    w, eeg, spec = seeded.cell_inputs(cfg, tr, seed, dev)
    t1 = time.perf_counter()
    st = State(cfg, prog, tr, dev, seed, w, eeg, spec, None)
    st.program = Explaining(cfg, prog, w, dev, tr["plane"], tr["ig_steps"])
    t2 = time.perf_counter()
    for i in range(min(2, tr["pool"])):          # warm every shape, untimed
        st.request(i)
    st.phases = {"weights_and_inputs": t1 - t0, "program": t2 - t1,
                 "warm_requests": time.perf_counter() - t2}
    return st


def window(st: State, seconds: float) -> dict:
    pool = st.traffic["pool"]
    rng = np.random.default_rng(int(st.seed) % (2 ** 63))
    seen = [0] * pool
    failed = n = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        k = n % pool
        try:
            out, finite = st.request(n)
            failed += not finite
        except Exception:                        # noqa: BLE001 — counted
            out = None
            failed += 1
        seen[k] += 1
        if rng.integers(seen[k]) == 0:           # reservoir of one a batch
            st.kept[k] = None if out is None else tuple(t.clone() for t in out)
        n += 1
    elapsed = time.perf_counter() - t0
    return {"attempted": n, "failed": failed, "seconds": elapsed,
            "end_to_end": {"explain_windows_per_s":
                           (n - failed) * st.traffic["batch"] / elapsed}}


def trace(st: State) -> profile.Segment:
    from torch.profiler import record_function
    return profile.trace_segment(lambda i: st.request(i, record_function),
                                 st.traffic["trace_requests"])


def flops(st: State) -> counters.Flops:
    tr = st.traffic
    return counters.explain(st.cfg, st.prog, tr["batch"], tr["n_points"],
                            tr["plane"], tr["ig_steps"])


def release(st: State) -> None:
    st.program = None


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """Largest over samples of ‖a − r‖ / ‖r‖ (inf where not finite)."""
    a, r = a.flatten(1).double(), r.flatten(1).double()
    e = float(((a - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-300)).max())
    return e if e == e else float("inf")


def judge(st: State, control: bool = False, raw: bool = False
          ) -> Dict[str, float]:
    tr = st.traffic
    worst = {"eeg_saliency_err": 0.0, "spec_saliency_err": 0.0, "ig_err": 0.0}
    for k in range(tr["pool"]):
        if k not in st.kept and not control:
            continue
        ans = st.kept.get(k)
        if ans is None and not control:
            return {key: float("inf") for key in worst}
        args = (st.cfg, st.prog, st.weights, st.eeg[k], st.spec[k],
                tr["plane"], tr["ig_steps"])
        if control:
            ans = cells.explain(*args, None, None, tr["tie"], "control")
        ge, gs, ig, _, _, _ = cells.explain(*args, ans[3], ans[4], tr["tie"])
        for key, a, r in (("eeg_saliency_err", ans[0], ge),
                          ("spec_saliency_err", ans[1], gs),
                          ("ig_err", ans[2], ig)):
            worst[key] = max(worst[key], _rel(a, r))
    return worst
