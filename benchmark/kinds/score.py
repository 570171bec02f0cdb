"""Scoring traffic: one client in a closed loop.  Each request is one batch
of raw windows from a pool of seeded batches resident on the device, in
turn; the program replays its captured forward, the log-probs are copied
to the host, and the request ends there.

Parameters (``traffic/<mix>.json``): ``batch``, ``pool``, ``n_points``
(raw EEG samples a window), ``plane`` (the raw spectrogram), ``program``
(the key of the configuration's program), ``trace_requests``.

Correctness: every answer of the window against the reference's
log-probs of its batch, in units of the gap that a plain implementation
in the configuration's stated precision shows on the same batch (the
networks' sensitivity to rounding differs from seed to seed by 20× and
more; this ratio does not): see :func:`judge`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..lib import counters, profile, seeded
from ..lib.program import Scoring
from ..reference import cells


@dataclass
class State:
    cfg: dict
    prog: dict
    traffic: dict
    dev: torch.device
    weights: Dict[str, torch.Tensor]
    eeg: torch.Tensor
    spec: torch.Tensor
    program: Optional[Scoring]
    answers: List[Tuple[int, Optional[torch.Tensor]]] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)    # set-up, s

    def request(self, i: int) -> torch.Tensor:
        k = i % self.traffic["pool"]
        return self.program.replay(self.eeg[k], self.spec[k]).cpu()


def setup(cell, seed: int, dev: torch.device, sizes: dict) -> State:
    tr = {**cell.traffic, **sizes}
    cfg = cell.config
    prog = cfg["programs"][tr["program"]]
    t0 = time.perf_counter()
    w, eeg, spec = seeded.cell_inputs(cfg, tr, seed, dev)
    t1 = time.perf_counter()
    st = State(cfg, prog, tr, dev, w, eeg, spec, None)
    st.program = Scoring(cfg, prog, w, dev, tr["plane"], (eeg[0], spec[0]))
    t2 = time.perf_counter()
    for i in range(tr["pool"]):                  # every batch once, untimed
        st.request(i)
    st.phases = {"weights_and_inputs": t1 - t0, "program": t2 - t1,
                 "warm_requests": time.perf_counter() - t2}
    return st


def window(st: State, seconds: float) -> dict:
    lat, failed, n = [], 0, 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= end:
            break
        try:
            out = st.request(n)
            if not bool(torch.isfinite(out).all()):
                failed += 1
        except Exception:                        # noqa: BLE001 — counted
            out = None
            failed += 1
        lat.append(time.perf_counter() - t)
        st.answers.append((n % st.traffic["pool"], out))
        n += 1
    elapsed = time.perf_counter() - t0
    b = st.traffic["batch"]
    return {"attempted": n, "failed": failed, "seconds": elapsed,
            "end_to_end": {
                "infer_windows_per_s": (n - failed) * b / elapsed,
                "infer_batch_p95_ms": float(np.percentile(lat, 95)) * 1e3}}


def trace(st: State) -> profile.Segment:
    from torch.profiler import record_function

    n = st.traffic["trace_requests"]
    seg = profile.trace_segment(st.request, n)
    staged = profile.trace_segment(
        lambda i: st.program.staged(st.eeg[i % st.traffic["pool"]],
                                    st.spec[i % st.traffic["pool"]],
                                    record_function), 2)
    seg.span_s = staged.span_s
    return seg


def flops(st: State) -> counters.Flops:
    tr = st.traffic
    return counters.score(st.cfg, st.prog, tr["batch"], tr["n_points"],
                          tr["plane"])


def release(st: State) -> None:
    st.program = None


def _gaps(outs: List[torch.Tensor], ref: torch.Tensor) -> Tuple[float, float]:
    """(largest, root-mean-square) difference of a class probability
    between each of ``outs`` and ``ref`` (inf for a missing or non-finite
    answer)."""
    if any(o is None for o in outs):
        return float("inf"), float("inf")
    d = (torch.stack(outs).exp() - ref.exp()).abs()
    big, rms = float(d.max()), float(d.pow(2).mean().sqrt())
    return tuple(v if v == v else float("inf") for v in (big, rms))


def judge(st: State, control: bool = False, raw: bool = False
          ) -> Dict[str, float]:
    """The window's answers (with ``control``: the control's, in the
    program's place, on every pool batch) against the reference: the
    largest and the root-mean-square class-probability gap, each over the
    same gap of the plain reference computed in the configuration's stated
    precision (``prob_gap_ratio``, ``rms_gap_ratio``).  ``raw`` adds the
    gaps themselves."""
    tr = st.traffic
    ks = range(tr["pool"]) if control else sorted({k for k, _ in st.answers})
    big = s_big = sq = s_sq = 0.0
    n = 0
    for k in ks:
        args = (st.cfg, st.prog, st.weights, st.eeg[k], st.spec[k], tr["plane"])
        ref = cells.score(*args)
        outs = ([cells.score(*args, "control")] if control
                else [o for kk, o in st.answers if kk == k])
        b, r = _gaps(outs, ref)
        sb, sr = _gaps([cells.score(*args, "stated")], ref)
        big, s_big = max(big, b), max(s_big, sb)
        sq, s_sq, n = sq + r * r * len(outs), s_sq + sr * sr, n + len(outs)
    rms, s_rms = (sq / max(n, 1)) ** 0.5, (s_sq / max(len(ks), 1)) ** 0.5
    out = {"prob_gap_ratio": big / max(s_big, 1e-30),
           "rms_gap_ratio": rms / max(s_rms, 1e-30)}
    if raw:
        out.update(prob_gap=big, rms_gap=rms, stated_prob_gap=s_big,
                   stated_rms_gap=s_rms)
    return out
