"""The port's benchmark harness: the repo-root ``bench.py``'s modes run
through the port's own code, on the card unless ``--device cpu`` is given.

    python -m multimodal_brain_pattern_identification_xai_tpu_torch bench [--mode] [--device D]
    python -m multimodal_brain_pattern_identification_xai_tpu_torch.bench [--mode] [--device D]

Each run prints ONE JSON line: ``metric``, ``value``, ``unit``,
``vs_baseline`` and the keys of the same mode of ``bench.py``
(``docs/BENCH.md``: the same flags, metric names and ``BENCH_*``
variables with the same defaults), plus ``device``
(``torch.cuda.get_device_name()``, or ``"cpu"``) and ``power_limit_w``
(the card's power limit by ``nvidia-smi``; null on the CPU).  Each mode is
a function of this module (``bench_headline``, ``bench_multimodal``, ...)
whose keyword arguments default to the mode's shapes; :func:`main` reads
the ``BENCH_*`` variables into them.

Measurement: every input is derived from the last output by the
multiplicative perturbation ``x · (1 + mean(out) · ε)``; a timed chain
ends with a device sync, and the value is the median of the repeats after
a warm-up.  ``BENCH_SCAN=K`` (scanned modes: the headline, ``--multimodal*``,
``--gradcam``, ``--latency``) captures one step as a CUDA graph whose
perturbation writes into its own static input, and replays it K times
between syncs; ``per_dispatch_value`` is the eager step (K=1).  On the CPU
the K steps run eagerly.  float32 runs with TF32 off for matmuls and cuDNN;
bf16 where the mode of ``bench.py`` sets bf16.  The kernels a mode runs are
built (``nvcc`` into ``_build/``) before its timed part.  The synthetic
EEG windows go through the host library's NaN repair
(``runtime.gather_windows``) in every mode, as the headline's do.

Supervision: unless ``BENCH_NO_SUPERVISOR=1``, the run is a child process
under a deadline of ``BENCH_TOTAL_BUDGET`` seconds (default 240; 0: none).
On the deadline or SIGTERM/SIGINT/SIGHUP the newest partial measurement of
this run is printed, marked ``"partial": true``.  ``BENCH_SCAN_RESERVE``
(default 75) seconds of budget must remain for an optional second
measurement (the per-dispatch figure, ``--xai-batch``'s SHAP), and
``BENCH_DEVICE_TIMEOUT`` (default 60) bounds the card's start-up.

Three differences from ``bench.py``, on purpose:

* no ``last_good``: nothing here reads ``BENCH_SWEEP.jsonl`` or any stored
  number;
* a failure is a failure: the line is ``{"metric": ..., "value": null,
  "unit": "error", "error": "<class>: <first line>"}`` and the exit code
  is 1 (``bench.py`` exits 0 after a ``value: 0.0`` error line); the exit
  code is 0 only when a measured value, final or partial, was printed;
* ``vs_baseline`` is null where ``bench.py`` divides by a TPU target (the
  headline's and ``--multimodal*``'s windows/s); ``--gradcam`` keeps the
  ``2 / ratio`` of its < 2× target, ``--hostgather`` fresh ÷ ring, and
  ``--convprobe`` and ``--breakdown``'s MFU divide by the H100's own
  bf16 peak (``PEAK_BF16`` below).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiling, resolve_device

#: NVIDIA H100 SXM dense bf16 tensor-core peak, FLOP/s (the probes and
#: the spectrogram blocks of ``--breakdown`` run in bf16)
PEAK_BF16 = 989e12
#: eager calls on a side stream before a step is captured: the first builds
#: the kernels and sets their shared-memory attributes
CAPTURE_WARMUP = 2
#: the checkout's root: the supervised child runs from there
ROOT = Path(__file__).resolve().parents[1]

#: mode flag → metric (the headline's when no flag is given)
MODE_METRIC = {
    "--gradcam": "gradcam_cost_vs_inference",
    "--multimodal": "multimodal_windows_per_sec_per_chip",
    "--multimodal-effnetv2": "multimodal_effnetv2_windows_per_sec_per_chip",
    "--multimodal-effnet": "multimodal_effnet_windows_per_sec_per_chip",
    "--train": "multimodal_train_windows_per_sec_per_chip",
    "--diffusion": "diffeeg_1000step_samples_per_sec_per_chip",
    "--diffeeg-train": "diffeeg_train_windows_per_sec_per_chip",
    "--longeeg": "longeeg_rollout_hours_per_sec_per_chip",
    "--latency": "single_window_stft_effnet_gradcam_latency",
    "--hostgather": "hostgather_ring_ms_per_batch",
    "--convprobe": "convprobe_best_smallcout_tflops",
    "--xai-batch": "xai_ig_maps_per_sec_per_chip",
}
HEADLINE_METRIC = "eeg_windows_per_sec_per_chip"


# ---------------------------------------------------------------------------
# the line

@functools.lru_cache(maxsize=None)
def _power_limit_w(index: int) -> Optional[float]:
    """The card's power limit in W by ``nvidia-smi`` (None when it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _card_keys(dev: torch.device) -> dict:
    """``device`` and ``power_limit_w`` of a line run on ``dev``."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": _power_limit_w(index)}


def _line(out: dict, dev: torch.device) -> dict:
    return {**out, **_card_keys(dev)}


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _partial(line: dict) -> None:
    """Publish an intermediate measurement to the supervisor: if the run is
    stopped later, the newest one becomes the printed line."""
    if os.environ.get("BENCH_SUPERVISED") == "1":
        print("PARTIAL " + json.dumps(line), flush=True)


def _short_err(e: BaseException) -> str:
    """``<class>: <first line>``, ANSI codes stripped, at most 200
    characters of the line."""
    first = (str(e).splitlines() or [""])[0]
    first = re.sub(r"\x1b\[[0-9;]*[A-Za-z]", "", first)
    return f"{type(e).__name__}: {first[:200]}"


def _error_line(metric: str, error: str) -> dict:
    return {"metric": metric, "value": None, "unit": "error",
            "vs_baseline": None, "error": error}


# ---------------------------------------------------------------------------
# budget and timing

#: monotonic time at which the child's budget ends (None: unbounded)
_budget_end: List[Optional[float]] = [None]


def _have_budget_for(n: float = 1.0) -> bool:
    """True when the remaining budget covers ``n`` optional measurements
    (``BENCH_SCAN_RESERVE`` seconds each, default 75)."""
    if _budget_end[0] is None:
        return True
    reserve = float(os.environ.get("BENCH_SCAN_RESERVE", 75))
    return _budget_end[0] - time.monotonic() > n * reserve


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_reps(run_chain, state, iters: int, reps: int) -> float:
    """``run_chain(state, iters) -> (state, seconds)``; the median seconds
    an iteration over ``reps`` repeats."""
    times = []
    for _ in range(reps):
        state, dt = run_chain(state, iters)
        times.append(dt / iters)
    return sorted(times)[len(times) // 2]


def _graph(step: Callable[[], object], dev: torch.device,
           spans: Optional[list] = None) -> Callable[[], None]:
    """``step`` (no arguments; it perturbs its own inputs in place) as one
    captured CUDA graph's replay: ``CAPTURE_WARMUP`` eager calls on a side
    stream first, then the capture.  On the CPU: ``step`` itself.  With a
    list ``spans``, the spans ``step`` opens record their timing events
    into the graph (``profiling.capturing``), and their
    ``profiling.GraphSpans`` is appended to it."""
    if dev.type != "cuda":
        return step
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        if spans is None:
            step()
        else:
            with profiling.capturing() as cap:
                step()
            spans.append(cap)
    return graph.replay


def _scan_rate(step, dev: torch.device, n_items: int, K: int, iters: int,
               reps: int) -> float:
    """Items a second of ``step``: K replays of its graph a dispatch (the
    eager step at K=1), ``iters`` dispatches a repeat, after a warm-up of
    two dispatches."""
    run = _graph(step, dev) if K > 1 else step

    def run_chain(state, n):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            for _ in range(K):
                run()
        _sync(dev)
        return state, time.perf_counter() - t0

    run_chain(None, 2)
    return n_items / (_timed_reps(run_chain, None, iters, reps) / K)


def _run_scan_first(step, dev, n_items: int, K: int, base_iters: int,
                    reps: int, result) -> dict:
    """The scanned throughput modes: the K-replay figure first, published
    as a partial; then the eager per-dispatch figure when the budget
    allows."""
    value = _scan_rate(step, dev, n_items, K,
                       max(2, base_iters // K) if K > 1 else base_iters, reps)
    _partial(_line(result(value, K, None), dev))
    if K > 1 and _have_budget_for(1):
        disp = _scan_rate(step, dev, n_items, 1, base_iters, reps)
        return _line(result(value, K, disp), dev)
    return _line(result(value, K, value if K == 1 else None), dev)


def _load_kernels(dev: torch.device, *names: str) -> None:
    """Build and load the named kernel libraries (``iir``, ``specblock``,
    ``duty``) before a timed part: a cold ``_build/`` compiles them with
    nvcc.  Nothing on the CPU."""
    if dev.type != "cuda":
        return
    from .ops import cuda_duty, cuda_iir, cuda_specblock
    mods = {"iir": cuda_iir, "specblock": cuda_specblock, "duty": cuda_duty}
    for name in names:
        mods[name]._lib()


def _seeded(model: torch.nn.Module, seed: int,
            state_dict: Optional[Dict[str, torch.Tensor]] = None
            ) -> torch.nn.Module:
    from .models import seeded_state_dict
    model.load_state_dict(state_dict if state_dict is not None
                          else seeded_state_dict(model, seed))
    return model


def _raw_eeg(batch: int, rng: np.random.Generator, dev: torch.device,
             n_points: int = 10_000) -> torch.Tensor:
    """Synthetic raw EEG (batch, 20, n_points) µV, NaNs repaired by the
    host library's gather, on ``dev``."""
    from .data import synthetic_raw_eeg
    from .runtime import gather_windows
    raw = synthetic_raw_eeg(batch, rng, n_points=n_points)
    return torch.as_tensor(gather_windows(
        raw, np.arange(batch, dtype=np.int64))).to(dev)


# ---------------------------------------------------------------------------
# the headline

def headline_program(device="cuda", batch: int = 256, eeg_bf16: bool = False,
                     n_points: int = 10_000, seed: int = 0,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """The headline's chained step: ``(step, raw, model)``.  ``step()``
    runs raw (batch, 20, n_points) → ``hms_eeg_preprocess(assume_finite=
    True)`` (the K=11 cascade with the fused mean-4 and ::4, #2) →
    ``EEGNetAttentionRegularized`` (weights from ``seed``, or
    ``state_dict``) and perturbs ``raw`` in place; it returns the
    log-probs."""
    from .models import EEGNetAttentionRegularized
    from .ops import hms_eeg_preprocess

    dev = resolve_device(device)
    raw = _raw_eeg(batch, np.random.default_rng(seed), dev, n_points)
    model = _seeded(EEGNetAttentionRegularized().eval(), seed,
                    state_dict).to(dev)
    dt = torch.bfloat16 if eeg_bf16 else None

    @torch.no_grad()
    def step() -> torch.Tensor:
        logp = model(hms_eeg_preprocess(raw, assume_finite=True,
                                        serving_dtype=dt))
        raw.mul_(1.0 + logp.mean() * 1e-4)
        return logp
    return step, raw, model


def bench_headline(device="cuda", batch: int = 256, scan: int = 64,
                   iters: int = 12, reps: int = 5, eeg_bf16: bool = False,
                   n_points: int = 10_000) -> dict:
    """``eeg_windows_per_sec_per_chip``: raw (B, 20, 10000) windows →
    the EEG preprocessing → EEGNetAttentionRegularized, windows/s."""
    step, raw, _ = headline_program(device, batch, eeg_bf16, n_points)
    _load_kernels(raw.device, "iir")

    def result(wps, scan_len, wps_disp):
        out = {"metric": HEADLINE_METRIC, "value": round(wps, 2),
               "unit": "windows/s", "vs_baseline": None,
               "scan_len": scan_len,
               "per_dispatch_value": (round(wps_disp, 2)
                                      if wps_disp is not None else None)}
        if wps_disp is None:
            out["per_dispatch_skipped"] = "budget"
        return out
    return _run_scan_first(step, raw.device, batch, scan, iters, reps, result)


# ---------------------------------------------------------------------------
# the multimodal pipeline

SPEC_MODELS = ("speccnn", "effnet", "effnetv2")


def multimodal_metric(spec_model: str = "speccnn",
                      spec_res: Optional[str] = None) -> str:
    name = {"effnet": "multimodal_effnet_windows_per_sec_per_chip",
            "effnetv2": "multimodal_effnetv2_windows_per_sec_per_chip"}.get(
                spec_model, "multimodal_windows_per_sec_per_chip")
    return (name.replace("_windows", f"_spec{spec_res}_windows")
            if spec_res else name)


def multimodal_program(device="cuda", batch: int = 256,
                       spec_model: str = "speccnn", fused_spec: int = 0,
                       spec_res: Optional[str] = None, eeg_bf16: bool = False,
                       param_bf16: bool = False, seed: int = 0,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       n_points: int = 10_000,
                       image_size: Tuple[int, int] = (400, 300)):
    """The ``--multimodal*`` chained step: ``(step, (raw_eeg, raw_spec),
    model)``.  ``step()`` runs both preprocessing chains (the spectrogram
    chain in bf16; ``spec_res`` "HxW": anti-alias-resampled to that plane)
    → ``MultimodalModel(EEGNetAttentionRegularized, spectrogram branch)``:
    ``SpectrogramCNN`` in bf16 with blocks 1 to ``fused_spec`` fused (#3's
    bf16 kernel), or float32 ``EfficientNetB0`` / ``EfficientNetV2B2``
    (fed the bf16 plane's values).  ``param_bf16`` rounds the spectrogram
    branch's parameters to bf16 values (the port keeps their float32
    storage).  Raw EEG (batch, 20, ``n_points``), raw spectrograms
    (batch, 400, 300) zero-padded or cropped to ``image_size`` without
    ``spec_res``.  Perturbs both raw inputs in place; returns the
    log-probs."""
    from . import config as C
    from .data import synthetic_raw_spectrogram
    from .models import (EEGNetAttentionRegularized, EfficientNetB0,
                         EfficientNetV2B2, MultimodalModel, SpectrogramCNN)
    from .ops import hms_eeg_preprocess, hms_spectrogram_preprocess

    if spec_model not in SPEC_MODELS:
        raise ValueError(f"spec_model {spec_model!r} not in {SPEC_MODELS}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    raw_eeg = _raw_eeg(batch, rng, dev, n_points)
    raw_spec = torch.as_tensor(synthetic_raw_spectrogram(batch, rng)).to(dev)
    bf16 = torch.bfloat16
    spec = {"effnet": EfficientNetB0, "effnetv2": EfficientNetV2B2}.get(
        spec_model, lambda: SpectrogramCNN(fused_blocks=fused_spec,
                                           dtype=bf16))()
    model = _seeded(MultimodalModel(EEGNetAttentionRegularized(), spec)
                    .eval(), seed, state_dict)
    if param_bf16:
        with torch.no_grad():
            for p in model.spectrogram_model.parameters():
                p.copy_(p.to(bf16))
    model.to(dev)
    f32_spec = getattr(spec, "dtype", None) is None
    sig = C.SignalConfig(image_size=tuple(image_size))
    if spec_res:
        h, w = (int(v) for v in spec_res.lower().split("x"))
        sig = C.SignalConfig(image_size=(h, w), resize_mode="resample")
    eeg_dt = bf16 if eeg_bf16 else None

    @torch.no_grad()
    def step() -> torch.Tensor:
        xe = hms_eeg_preprocess(raw_eeg, assume_finite=True,
                                serving_dtype=eeg_dt)
        xs = hms_spectrogram_preprocess(raw_spec, signal=sig,
                                        serving_dtype=bf16)
        out = model(xe, xs.float() if f32_spec else xs)
        f = 1.0 + out.mean() * 1e-4
        raw_eeg.mul_(f)
        raw_spec.mul_(f)
        return out
    return step, (raw_eeg, raw_spec), model


def bench_multimodal(device="cuda", spec_model: str = "speccnn",
                     batch: int = 256, scan: int = 64, iters: int = 10,
                     reps: int = 5, fused_spec: int = 0,
                     spec_res: Optional[str] = None, eeg_bf16: bool = False,
                     param_bf16: bool = False, n_points: int = 10_000,
                     image_size: Tuple[int, int] = (400, 300)) -> dict:
    """``multimodal*_windows_per_sec_per_chip``: raw EEG + raw spectrogram
    → both preprocessing chains → the late-fusion model
    (:func:`multimodal_program`), windows/s."""
    step, (raw_eeg, _), _ = multimodal_program(
        device, batch, spec_model, fused_spec, spec_res, eeg_bf16,
        param_bf16, n_points=n_points, image_size=image_size)
    dev = raw_eeg.device
    _load_kernels(dev, "iir", "specblock")
    name = multimodal_metric(spec_model, spec_res)

    def result(wps, scan_len, wps_disp):
        out = {"metric": name, "value": round(wps, 2), "unit": "windows/s",
               "vs_baseline": None, "scan_len": scan_len,
               "per_dispatch_value": (round(wps_disp, 2)
                                      if wps_disp is not None else None)}
        if wps_disp is None:
            out["per_dispatch_skipped"] = "budget"
        if spec_res:
            out["spec_image_size"] = spec_res
            out["serving_preset"] = (
                "reduced-resolution serving preset: same CNN weights, "
                "anti-alias-resampled input; exact-parity 400x300 is the "
                "default")
        return out
    return _run_scan_first(step, dev, batch, scan, iters, reps, result)


def bench_multimodal_breakdown(device="cuda", batch: int = 256,
                               fused_spec: int = 0, iters: int = 8,
                               reps: int = 5, n_points: int = 10_000,
                               image_size: Tuple[int, int] = (400, 300)
                               ) -> dict:
    """``multimodal_breakdown``: the whole program (both chains, the
    late-fusion model with the spectrogram blocks one span each) as one
    captured CUDA graph; windows/s from its chained replays with tracing
    off, per-stage ms from the device time of the spans its layers record
    into the graph (``graph=True``, :mod:`.profiling`) over ``iters``
    traced replays (on the CPU: the host time of the same spans, run
    eagerly), and each spectrogram block's MFU (conv MACs × 2 over the
    H100's dense bf16 peak).  ``dispatch_overhead`` is a replay's time
    less the step's device time; ``full_pipeline`` the step's time outside
    the named stages (the spectrogram head, the fusion head, the
    perturbation)."""
    from . import config as C
    from .data import synthetic_raw_spectrogram
    from .models import (EEGNetAttentionRegularized, MultimodalModel,
                         SpectrogramCNN)
    from .ops import hms_eeg_preprocess, hms_spectrogram_preprocess

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    re = _raw_eeg(batch, rng, dev, n_points)
    rs = torch.as_tensor(synthetic_raw_spectrogram(batch, rng)).to(dev)
    bf16 = torch.bfloat16
    sig = C.SignalConfig(image_size=tuple(image_size))
    spec = SpectrogramCNN(fused_blocks=fused_spec, dtype=bf16)
    mm = _seeded(MultimodalModel(EEGNetAttentionRegularized(), spec).eval(),
                 0).to(dev)
    _load_kernels(dev, "iir", "specblock")
    n_blocks = len(spec.widths)

    @torch.no_grad()
    def step():
        with profiling.span("mbx.bench.step"):
            xe = hms_eeg_preprocess(re, assume_finite=True)
            x = hms_spectrogram_preprocess(rs, signal=sig, serving_dtype=bf16)
            le = mm.forward_eeg(xe)
            with profiling.span("mbx.model.spec_branch"):
                for k in range(1, n_blocks + 1):
                    with profiling.span(f"mbx.bench.spec_block{k}"):
                        x = getattr(spec, f"block{k}")(x)
                ls = spec.head(x)
            out = mm.fuse(le, ls)
            f = 1.0 + out.mean() * 1e-4
            re.mul_(f)
            rs.mul_(f)

    captured: list = []
    run = _graph(step, dev, captured)

    def run_chain(state, n):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        _sync(dev)
        return state, time.perf_counter() - t0
    run_chain(None, 2)
    wall = _timed_reps(run_chain, None, iters, reps)

    # the same replays traced: each one's layer times, read after it
    field = "device_ms" if captured else "host_ms"
    before = profiling.collect()
    with profiling.traced():
        for _ in range(iters):
            with profiling.span("mbx.bench.replay") as req:
                run()
            if captured:
                captured[0].pending(req.request)
                captured[0].flush()
    after = profiling.collect()
    old, new = ((before.graph_sums, after.graph_sums) if captured
                else (before.sums, after.sums))
    ms = {k: (getattr(v, field) - getattr(old.get(k, profiling.SpanSum()),
                                          field)) / iters
          for k, v in new.items()}

    stages = {"eeg_preprocess": ms["mbx.preprocess.eeg"],
              "spec_preprocess": ms["mbx.preprocess.spec"],
              "eeg_branch": ms["mbx.model.eeg_branch"]}
    for k in range(1, n_blocks + 1):
        stages[f"spec_block{k}"] = ms[f"mbx.bench.spec_block{k}"]
    step_ms = ms["mbx.bench.step"]
    per_stage_ms = {"dispatch_overhead": wall * 1e3 - step_ms, **stages,
                    "full_pipeline": step_ms - sum(stages.values())}

    # conv FLOPs a spectrogram block (3×3 convs + the 1×1 pooled skip)
    H, W = sig.image_size
    cin, block_mfu = 3, {}
    for i, cout in enumerate(spec.widths):
        flops = 2 * H * W * 9 * (cin * cout + 2 * cout * cout)
        hp, wp = H // 2, W // 2
        flops += 2 * hp * wp * cin * cout
        ms_k = per_stage_ms[f"spec_block{i + 1}"]
        block_mfu[f"block{i + 1}"] = {
            "ms": round(ms_k, 3), "gflops_per_sample": round(flops / 1e9, 3),
            "mfu": round(flops * batch / max(ms_k / 1e3, 1e-9) / PEAK_BF16,
                         4),
            "shape_in": [int(H), int(W), cin]}
        H, W, cin = hp, wp, cout

    return _line({
        "metric": "multimodal_breakdown", "value": round(batch / wall, 2),
        "unit": "windows/s", "vs_baseline": None, "batch": batch,
        "fused_spec_blocks": fused_spec,
        "per_stage_ms": {k: round(v, 3) for k, v in per_stage_ms.items()},
        "spec_block_mfu": block_mfu,
        "note": ("per-stage = device time of each stage's span inside the "
                 "one captured CUDA graph (host time of the same spans on "
                 "the CPU), over traced replays; MFU = conv MACs×2 / the "
                 "NVIDIA H100 SXM's dense bf16 peak 989 TFLOP/s")}, dev)


# ---------------------------------------------------------------------------
# attribution

def _eeg_model(dev: torch.device, seed: int = 0) -> torch.nn.Module:
    """EEGNetAttentionRegularized with weights from ``seed``, eval mode,
    parameters frozen (attribution needs input gradients only)."""
    from .models import EEGNetAttentionRegularized
    model = _seeded(EEGNetAttentionRegularized().eval(), seed).to(dev)
    return model.requires_grad_(False)


def bench_gradcam(device="cuda", batch: int = 256, scan: int = 64,
                  iters: int = 4) -> dict:
    """``gradcam_cost_vs_inference``: Grad-CAM's time over inference's on
    EEGNetAttentionRegularized, B=256 (1, 37, 3000) inputs, each side K
    chained steps a dispatch; ``vs_baseline`` is the < 2× target over the
    ratio."""
    from .xai import grad_cam

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((batch, 1, 37, 3000)),
                        dtype=torch.float32).to(dev)
    model = _eeg_model(dev)

    def infer(xx):
        with torch.no_grad():
            return model(xx)

    def per_step(fn) -> float:
        xx = x.clone()

        def step():
            out = fn(xx)
            with torch.no_grad():
                xx.mul_(1.0 + out.mean() * 1e-4)
        return 1.0 / _scan_rate(step, dev, 1, scan, iters, 1)

    t_inf = per_step(infer)
    t_cam = per_step(lambda xx: grad_cam(model, xx))
    ratio = t_cam / t_inf
    return _line({"metric": "gradcam_cost_vs_inference",
                  "value": round(ratio, 3), "unit": "x",
                  "vs_baseline": round(2.0 / ratio, 3),
                  "inference_ms": round(t_inf * 1e3, 2),
                  "gradcam_ms": round(t_cam * 1e3, 2), "scan_len": scan}, dev)


def bench_xai_batch(device="cuda", batch: int = 256, ig_steps: int = 50,
                    shap_nsamples: int = 32, iters: int = 2,
                    reps: int = 3) -> dict:
    """``xai_ig_maps_per_sec_per_chip``: integrated gradients (``ig_steps``
    midpoints, chunks of ~2048 network samples) on the EEG branch at B=256,
    maps/s; then per-class gradient SHAP (6 classes × ``shap_nsamples``
    draws), ``shap_maps_per_sec``, when the budget allows."""
    from .xai import gradient_shap_values, integrated_gradients

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((batch, 1, 37, 3000)),
                        dtype=torch.float32).to(dev)
    model = _eeg_model(dev)
    with torch.no_grad():
        tgt = model(x).argmax(-1)
    bg = x[:min(16, batch)].clone()
    chunk_ig = max(1, 2048 // batch)
    while ig_steps % chunk_ig:
        chunk_ig -= 1
    chunk_eg = max(1, 1024 // batch)
    while shap_nsamples % chunk_eg:
        chunk_eg -= 1

    def ig_step(xx):
        attr = integrated_gradients(model, xx, None, tgt, steps=ig_steps,
                                    chunk=chunk_ig)
        return xx * (1.0 + attr.abs().mean() * 1e-4)

    def shap_step(xx):
        gen = torch.Generator(device=dev).manual_seed(1)
        sv = gradient_shap_values(model, xx, bg, gen, nsamples=shap_nsamples,
                                  chunk=chunk_eg)
        return xx * (1.0 + sv.abs().mean() * 1e-4)

    def measure(step) -> float:
        def run_chain(xx, n):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                xx = step(xx)
            _sync(dev)
            return xx, time.perf_counter() - t0
        xx, _ = run_chain(x, 1)
        return batch / _timed_reps(run_chain, xx, iters, reps)

    def result(ig_mps, shap_mps):
        out = {"metric": "xai_ig_maps_per_sec_per_chip",
               "value": round(ig_mps, 2), "unit": "maps/s",
               "vs_baseline": None, "ig_steps": ig_steps, "batch": batch}
        if shap_mps is not None:
            out.update(shap_maps_per_sec=round(shap_mps, 2),
                       shap_nsamples=shap_nsamples, shap_classes=6)
        return out

    ig_mps = measure(ig_step)
    _partial(_line(result(ig_mps, None), dev))
    if _have_budget_for(1):
        return _line(result(ig_mps, measure(shap_step)), dev)
    return _line({**result(ig_mps, None), "shap_skipped": "budget"}, dev)


def bench_latency(device="cuda", scan: int = 64, iters: int = 20) -> dict:
    """``single_window_stft_effnet_gradcam_latency``: one 50 s window →
    STFT log-spectrogram image (3, 96, 300) → EfficientNet-B0 → Grad-CAM,
    B=1, ms; ``value`` from K chained windows a graph replay,
    ``per_dispatch_ms`` from the eager step."""
    import torch.nn.functional as F

    from .models import EfficientNetB0
    from .ops import stft_log1p_interp
    from .xai import grad_cam

    dev = resolve_device(device)
    raw = _raw_eeg(1, np.random.default_rng(0), dev)        # (1, 20, 10000)
    model = _seeded(EfficientNetB0().eval(), 0).to(dev).requires_grad_(False)

    def make_spec(r):
        s = stft_log1p_interp(r, out_t=300, nperseg=64, noverlap=32)
        img = s.mean(dim=1)                                  # (B, 33, 300)
        img = F.interpolate(img[:, None], size=(96, 300), mode="bilinear",
                            align_corners=False, antialias=True)
        return img.expand(-1, 3, -1, -1).contiguous()        # (B, 3, 96, 300)

    def step():
        with torch.no_grad():
            x = make_spec(raw)
            out = model(x)
        grad_cam(model, x)
        with torch.no_grad():
            raw.mul_(1.0 + out.mean() * 1e-4)

    def result(ms, scan_len, disp_ms):
        out = {"metric": "single_window_stft_effnet_gradcam_latency",
               "value": round(ms, 3), "unit": "ms", "vs_baseline": None,
               "scan_len": scan_len,
               "per_dispatch_ms": (round(disp_ms, 3)
                                   if disp_ms is not None else None)}
        if disp_ms is None:
            out["per_dispatch_skipped"] = "budget"
        return out

    measure_single = lambda: 1e3 / _scan_rate(step, dev, 1, 1, iters, 1)
    if scan <= 1:
        disp_ms = measure_single()
        return _line(result(disp_ms, 1, disp_ms), dev)
    ms = 1e3 / _scan_rate(step, dev, 1, scan, max(2, iters // scan) + 3, 1)
    _partial(_line(result(ms, scan, None), dev))
    if _have_budget_for(1):
        return _line(result(ms, scan, measure_single()), dev)
    return _line(result(ms, scan, None), dev)


# ---------------------------------------------------------------------------
# training and diffusion

def bench_train(device="cuda", batch: int = 256, bf16: bool = True,
                iters: int = 8, reps: int = 5, n_points: int = 10_000,
                image_size: Tuple[int, int] = (400, 300)) -> dict:
    """``multimodal_train_windows_per_sec_per_chip``: raw windows → both
    preprocessing chains (finite route) → forward + KLDiv + L2 + backward
    + Adam, the port's train step (``entry.train_entry``: the spectrogram
    branch in bf16 unless ``bf16=False``), B=256 one-hot targets,
    windows/s."""
    from . import config as C
    from .entry import train_entry

    step, state, (raw_eeg, raw_spec, _) = train_entry(
        device, batch=batch, seed=0, dtype=torch.bfloat16 if bf16 else None,
        n_points=n_points, signal=C.SignalConfig(image_size=tuple(image_size)))
    dev = raw_eeg.device
    _load_kernels(dev, "iir")
    y = torch.as_tensor(np.eye(6, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 6, batch)]).to(dev)

    def run_chain(st, n):
        state_, re, rs = st
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            state_, metrics = step(state_, re, rs, y)
            f = 1.0 + metrics["loss"].detach() * 1e-6
            re, rs = re * f, rs * f
        _sync(dev)
        return (state_, re, rs), time.perf_counter() - t0

    s0, _ = run_chain((state, raw_eeg, raw_spec), 2)
    per_iter = _timed_reps(run_chain, s0, iters, reps)
    return _line({"metric": "multimodal_train_windows_per_sec_per_chip",
                  "value": round(batch / per_iter, 2), "unit": "windows/s",
                  "vs_baseline": None}, dev)


def bench_diffusion(device="cuda", batch: int = 256,
                    steps: Optional[int] = None, length: Optional[int] = None,
                    iters: int = 3) -> dict:
    """``diffeeg_1000step_samples_per_sec_per_chip``: the DiffEEG reverse
    process (``DiffEEGConfig()``'s width, ``steps`` default 1,000) over
    ``make_cached_denoiser`` at B=256, class-conditional, samples/s."""
    from . import config as C
    from .diffusion import make_schedule, reverse_diffusion
    from .entry import diffeeg_model
    from .models import make_cached_denoiser

    dev = resolve_device(device)
    cfg = C.DiffEEGConfig()
    steps = steps or cfg.n_diffusion_steps
    T = length or cfg.input_length
    model = diffeeg_model(cfg, seed=0).to(dev).eval()
    y = torch.eye(6, device=dev)[torch.arange(batch, device=dev) % 6]
    spec = torch.zeros((batch, cfg.n_channels, 50, 50), device=dev)
    sched = make_schedule(steps, dev)
    den = make_cached_denoiser(model, y, spec, T)

    @torch.no_grad()
    def gen(i: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(i)
        return reverse_diffusion(sched, den, g, batch, y, spec,
                                 (cfg.n_channels, T))

    gen(0)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        gen(i + 1)
    _sync(dev)
    sps = batch * iters / (time.perf_counter() - t0)
    return _line({"metric": "diffeeg_1000step_samples_per_sec_per_chip",
                  "value": round(sps, 2), "unit": "samples/s",
                  "vs_baseline": None}, dev)


def bench_diffeeg_train(device="cuda", batch: int = 64, fuse: int = 1,
                        diff_bf16: bool = False,
                        accumulate: Optional[int] = None,
                        length: Optional[int] = None, iters: int = 2,
                        reps: int = 3) -> dict:
    """``diffeeg_train_windows_per_sec_per_chip``: one ``DiffEEGTrainer``
    step over ``accumulate`` (default 50) micro-batches of 64 windows (STFT
    conditioning, same-class mixup, q-sample, the denoiser's forward and
    backward), ``fuse`` micro-batches a pass, ``diff_bf16``: the amp mode;
    windows/s and ``step_ms``."""
    from . import config as C
    from .entry import diffeeg_model
    from .train import DiffEEGTrainer

    dev = resolve_device(device)
    base = C.DiffEEGConfig()
    cfg = C.DiffEEGConfig(
        batch_size=batch, fuse_accum=fuse, amp=diff_bf16,
        gradient_accumulate_every=accumulate or base.gradient_accumulate_every,
        input_length=length or base.input_length)
    model = diffeeg_model(cfg, seed=0,
                          dtype=torch.bfloat16 if cfg.amp else None)
    trainer = DiffEEGTrainer(model, cfg, ckpt_dir=None, seed=0, device=dev)
    K, B, T = cfg.gradient_accumulate_every, cfg.batch_size, cfg.input_length
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.standard_normal((K, B, cfg.n_channels, T)),
                         dtype=torch.float32).to(dev)
    ys = torch.as_tensor(np.eye(6, dtype=np.float32)[
        rng.integers(0, 6, (K, B))]).to(dev)

    def run_chain(xs_, n):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            loss = trainer.train_step(xs_, ys)["loss"]
            xs_ = xs_ * (1.0 + loss.detach() * 1e-6)
        _sync(dev)
        return xs_, time.perf_counter() - t0

    x1, _ = run_chain(xs, 1)
    per_step = _timed_reps(run_chain, x1, iters, reps)
    return _line({"metric": "diffeeg_train_windows_per_sec_per_chip",
                  "value": round(K * B / per_step, 2), "unit": "windows/s",
                  "vs_baseline": None,
                  "step_ms": round(per_step * 1e3, 1)}, dev)


# ---------------------------------------------------------------------------
# long EEG

def bench_longeeg(device="cuda", hours: float = 1.0, iters: int = 4,
                  reps: int = 3) -> dict:
    """``longeeg_rollout_hours_per_sec_per_chip``: the long-EEG encoder
    (20 channels, patch 200, d 128, depth 4, 4 heads; weights from seed 0)
    over one hour at 200 Hz (720,000 samples, 3,600 tokens) on one card,
    no process group, with attention rollout; EEG-hours/s."""
    from .parallel import LongEEGEncoder
    from .xai import attention_rollout

    dev = resolve_device(device)
    T = int(hours * 3600 * 200)
    enc = LongEEGEncoder(n_channels=20, patch=200, d_model=128, depth=4,
                         n_heads=4,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 20, T)),
                        dtype=torch.float32).to(dev)

    @torch.no_grad()
    def step(xx):
        logits, attn = enc.local_forward(xx, None, return_attn=True)
        attention_rollout(list(attn))
        return xx * (1.0 + logits.mean() * 1e-4)

    def run_chain(xx, n):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            xx = step(xx)
        _sync(dev)
        return xx, time.perf_counter() - t0

    xx = step(x)
    per_iter = _timed_reps(run_chain, xx, iters, reps)
    return _line({"metric": "longeeg_rollout_hours_per_sec_per_chip",
                  "value": round(hours / per_iter, 3), "unit": "EEG-hours/s",
                  "vs_baseline": None, "tokens": T // 200}, dev)


# ---------------------------------------------------------------------------
# host and probes

def bench_hostgather(device="cuda", batch: int = 256, n_rows: int = 1024,
                     n_eeg: int = 200, n_spec: int = 120) -> dict:
    """``hostgather_ring_ms_per_batch``: host-side batch assembly of the
    real-data multimodal path (``MultimodalSource.batches`` over the host
    library's ``gather_multimodal``: 20×10000 EEG + a ragged spectrogram
    cropped to 400×300 a row) into a reused ring, median ms a batch;
    ``vs_baseline`` = fresh allocation ÷ ring.  No device work."""
    from .data.hms import MultimodalSource
    from .data.loader import ColumnTable

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    U, C_, T = n_eeg, 20, 10_000
    NS, F_, W = n_spec, 400, 300
    cache = {i: rng.standard_normal((T, C_)).astype(np.float32)
             for i in range(U)}
    lens = rng.integers(400, 620, NS)
    store = {i: rng.standard_normal((int(lens[i]), F_)).astype(np.float32)
             for i in range(NS)}
    meta = ColumnTable({
        "eeg_id": rng.integers(0, U, n_rows),
        "spectrogram_id": rng.integers(0, NS, n_rows),
        "spectrogram_label_offset_seconds":
            rng.integers(0, 600, n_rows).astype(float),
        "expert_consensus": np.random.default_rng(1).choice(
            ["Seizure", "LPD", "GPD", "LRDA", "GRDA", "Other"], n_rows)})
    src = MultimodalSource(meta, cache, store, spec_width=W)
    rows = np.arange(n_rows)

    def time_mode(reuse: bool) -> float:
        it = src.batches(rows, batch, shuffle=False, reuse_buffers=reuse)
        next(it)                                   # warm: page the ring in
        ts = []
        t0 = time.perf_counter()
        for _ in it:
            t1 = time.perf_counter()
            ts.append(t1 - t0)
            t0 = t1
        return sorted(ts)[len(ts) // 2] * 1e3

    fresh = time_mode(False)
    ring = time_mode(True)
    mb = batch * (C_ * T + F_ * W) * 4 / 1e6
    return _line({"metric": "hostgather_ring_ms_per_batch",
                  "value": round(ring, 2),
                  "unit": f"ms/batch (B={batch}, ~{round(mb, -1):.0f} MB)",
                  "vs_baseline": round(fresh / ring, 3)}, dev)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ b with float32 output (cuBLAS on the card; float32 on the
    CPU, which has no bf16→f32 product)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bench_convprobe(device="cuda", gemm_cols: Optional[int] = None,
                    conv_batch: Optional[int] = None,
                    n_tile: Optional[int] = None, r: Optional[int] = None,
                    iters: int = 8, reps: int = 5,
                    plane: Tuple[int, int] = (400, 300)) -> dict:
    """``convprobe_best_smallcout_tflops``: bf16 products of the
    spectrogram blocks' small-Cout shapes with float32 accumulation, each a
    chained step: (1) block 2's im2col GEMM in the convolution's
    orientation and position-major, a well-shaped control, the 2×2 / 2×4
    phase-packed GEMMs (cuBLAS; ``*_eff`` counts their useful 9/16, 9/24);
    (2) the block-1/2 conv subgraphs, 3 × (conv + ReLU) + pool, NHWC
    (cuDNN) on ``plane`` and its half, ms and MFU over the H100's dense
    bf16 peak; (3) the duty
    kernel (#4, ``ops.cuda_duty.duty``: R passes of W (co, k) @ P (k, N)
    from shared memory) at (16, 144), (64, 256), (128, 384), (64, 48),
    keys ``pallas_duty*`` as ``bench.py`` names its probe.  The value is
    the best useful rate; ``vs_baseline`` its share of the bf16 peak.  On
    the CPU the shapes shrink as ``bench.py``'s CPU smoke does (the
    numbers mean nothing there).  A probe that fails fails the run."""
    import torch.nn.functional as F

    from .ops import cuda_duty

    dev = resolve_device(device)
    cpu = dev.type != "cuda"
    S = gemm_cols or (2048 if cpu else 384 * 1024)
    B = conv_batch or (2 if cpu else 64)
    N_TILE = n_tile or (512 if cpu else 16384)
    R = r if r is not None else (2 if cpu else 512)
    _load_kernels(dev, "duty")
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def draw(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=bf16).to(dev)

    def chain_time(step, x0, n_iters=iters) -> float:
        def run(x, n):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                x, _ = step(x)
            _sync(dev)
            return x, time.perf_counter() - t0
        x, _ = run(x0, 2)
        return _timed_reps(run, x, n_iters, reps)

    def perturbed(x, out, eps=1e-4):
        return x * (1 + out.mean().to(bf16) * eps)

    results = {}
    # 1) GEMM orientations (K=144, Cout=16)
    K, CO = 144, 16
    W2, P0 = draw(CO, K), draw(K, S, scale=0.1)
    gemm_flops = 2 * CO * K * S

    def xla_orient(P):            # (S, 144) @ (144, 16): the conv's mapping
        out = _mm_f32(P.t(), W2.t())
        return perturbed(P, out), out

    def pos_major(P):             # (16, 144) @ (144, S): positions on N
        out = _mm_f32(W2, P)
        return perturbed(P, out), out

    for name, fn in (("gemm_xla_orient", xla_orient),
                     ("gemm_pos_major", pos_major)):
        results[name + "_tflops"] = round(
            gemm_flops / chain_time(fn, P0) / 1e12, 2)

    M = gemm_flops // (2 * 1152 * 256)
    A0, Wb = draw(M, 1152, scale=0.1), draw(1152, 256)

    def control(A):
        out = _mm_f32(A, Wb)
        return perturbed(A, out), out
    results["gemm_control_tflops"] = round(
        2 * M * 1152 * 256 / chain_time(control, A0) / 1e12, 2)
    del P0, A0

    for name, m2, k2, useful in (("gemm_pack2x2", 64, 256, 9 / 16),
                                 ("gemm_pack2x4", 128, 384, 9 / 24)):
        n2 = max(256, (gemm_flops // (2 * m2 * k2)) // 128 * 128)
        Wp, Pp = draw(m2, k2), draw(k2, n2, scale=0.1)

        def packed(P, _W=Wp):
            out = _mm_f32(_W, P)
            return perturbed(P, out), out
        raw = 2 * m2 * k2 * n2 / chain_time(packed, Pp) / 1e12
        results[name + "_tflops"] = round(raw, 2)
        results[name + "_eff_tflops"] = round(raw * useful, 2)

    # 2) conv subgraphs: 3 × (conv3x3 + ReLU) + 2×2 pool, NHWC
    ph, pw = plane
    for name, (h, w, cin, cout, pool) in {
            "conv_block1": (ph, pw, 3, 16, "max"),
            "conv_block2": (ph // 2, pw // 2, 16, 32, "avg")}.items():
        cl = torch.channels_last
        x0 = draw(B, cin, h, w).contiguous(memory_format=cl)
        ws = [draw(co, ci, 3, 3, scale=0.05).contiguous(memory_format=cl)
              for ci, co in ((cin, cout), (cout, cout), (cout, cout))]

        def conv_step(x, _ws=ws, _pool=pool):
            y = x
            for wk in _ws:
                y = F.relu(F.conv2d(y, wk, padding=1))
            out = (F.max_pool2d(y, 2) if _pool == "max"
                   else F.avg_pool2d(y, 2))
            return perturbed(x, out), out
        t = chain_time(conv_step, x0)
        macs = B * h * w * 9 * (cin * cout + 2 * cout * cout)
        results[name + "_ms"] = round(t * 1e3, 3)
        results[name + "_mfu"] = round(2 * macs / t / PEAK_BF16, 4)
        del x0

    # 3) the duty kernel (#4): R passes from shared memory
    for name, co, k, useful in (("pallas_duty", CO, K, 1.0),
                                ("pallas_duty_pack2x2", 64, 256, 9 / 16),
                                ("pallas_duty_pack2x4", 128, 384, 9 / 24),
                                ("pallas_duty_b1pack2x2", 64, 48, 9 / 16)):
        Wd, Pt = draw(co, k), draw(k, N_TILE, scale=0.1)

        def duty_step(P, _W=Wd):
            out = cuda_duty.duty(_W, P, R)
            return perturbed(P, out, 1e-9), out
        raw = 2 * R * co * k * N_TILE / chain_time(duty_step, Pt, 4) / 1e12
        results[name + "_tflops"] = round(raw, 2)
        if useful < 1.0:
            results[name + "_eff_tflops"] = round(raw * useful, 2)

    # "best" compares useful rates: a packed probe by its *_eff twin
    best = max(v for key, v in results.items()
               if key.startswith(("gemm_xla", "gemm_pos", "gemm_pack",
                                  "pallas"))
               and (key.endswith("_eff_tflops") or (
                   key.endswith("_tflops")
                   and key[:-len("_tflops")] + "_eff_tflops" not in results)))
    return _line({"metric": "convprobe_best_smallcout_tflops", "value": best,
                  "unit": "TFLOP/s",
                  "vs_baseline": round(best / (PEAK_BF16 / 1e12), 4),
                  **results}, dev)


# ---------------------------------------------------------------------------
# the command

def _env_kwargs(mode: str) -> dict:
    """The keyword arguments a mode takes from the ``BENCH_*`` variables,
    with ``bench.py``'s defaults."""
    env = os.environ.get
    batch = lambda d: int(env("BENCH_BATCH", d))
    scan = lambda: int(env("BENCH_SCAN", 64))
    eeg_bf16 = env("BENCH_EEG_BF16") == "1"
    if mode == "headline":
        return dict(batch=batch(256), scan=scan(), eeg_bf16=eeg_bf16)
    if mode.startswith("multimodal-"):
        return dict(spec_model={"multimodal-speccnn": "speccnn",
                                "multimodal-effnet": "effnet",
                                "multimodal-effnetv2": "effnetv2"}[mode],
                    batch=batch(256), scan=scan(), eeg_bf16=eeg_bf16,
                    fused_spec=int(env("BENCH_FUSED_SPEC", "0")),
                    spec_res=env("BENCH_SPEC_RES") or None,
                    param_bf16=env("BENCH_PARAM_BF16", "0") == "1")
    if mode == "breakdown":
        return dict(batch=batch(256),
                    fused_spec=int(env("BENCH_FUSED_SPEC", "0")))
    if mode in ("gradcam", "latency"):
        return dict(scan=scan())
    if mode == "xai-batch":
        return dict(batch=batch(256),
                    ig_steps=int(env("BENCH_IG_STEPS", 50)),
                    shap_nsamples=int(env("BENCH_SHAP_NSAMPLES", 32)))
    if mode == "train":
        return dict(batch=batch(256), bf16=env("BENCH_BF16", "1") == "1")
    if mode == "diffusion":
        return dict(batch=batch(256))
    if mode == "diffeeg-train":
        return dict(batch=batch(64), fuse=int(env("BENCH_FUSE", 1)),
                    diff_bf16=env("BENCH_DIFF_BF16", "0") == "1")
    return {}


#: mode → its function's name in this module (looked up at run time)
MODE_FUNCTIONS = {
    "headline": "bench_headline", "gradcam": "bench_gradcam",
    "multimodal-speccnn": "bench_multimodal",
    "multimodal-effnet": "bench_multimodal",
    "multimodal-effnetv2": "bench_multimodal",
    "breakdown": "bench_multimodal_breakdown", "train": "bench_train",
    "diffusion": "bench_diffusion", "diffeeg-train": "bench_diffeeg_train",
    "longeeg": "bench_longeeg", "latency": "bench_latency",
    "hostgather": "bench_hostgather", "convprobe": "bench_convprobe",
    "xai-batch": "bench_xai_batch",
}


def add_mode_flags(p: argparse.ArgumentParser) -> None:
    """The mode flags of ``bench.py`` (``--breakdown`` with
    ``--multimodal``)."""
    for flag in MODE_METRIC:
        p.add_argument(flag, action="store_true")
    p.add_argument("--breakdown", action="store_true",
                   help="with --multimodal: per-stage ms and per-block MFU")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="multimodal_brain_pattern_identification_xai_tpu_torch.bench",
        description=__doc__.splitlines()[0], allow_abbrev=False)
    add_mode_flags(p)
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; --device cpu runs "
                        "the plain PyTorch versions on the CPU)")
    return p


def mode_of(args: argparse.Namespace) -> str:
    """The mode the flags select, in ``bench.py``'s order of precedence."""
    for flag, mode in (("gradcam", "gradcam"),
                       ("multimodal_effnetv2", "multimodal-effnetv2"),
                       ("multimodal_effnet", "multimodal-effnet"),
                       ("train", "train"), ("longeeg", "longeeg"),
                       ("diffeeg_train", "diffeeg-train")):
        if getattr(args, flag):
            return mode
    if args.multimodal:
        return "breakdown" if args.breakdown else "multimodal-speccnn"
    for flag, mode in (("diffusion", "diffusion"), ("latency", "latency"),
                       ("hostgather", "hostgather"),
                       ("xai_batch", "xai-batch"),
                       ("convprobe", "convprobe")):
        if getattr(args, flag):
            return mode
    return "headline"


def metric_of(mode: str) -> str:
    """The metric a mode prints (an error line's too)."""
    spec_res = os.environ.get("BENCH_SPEC_RES")
    if mode == "breakdown":
        return "multimodal_breakdown"
    if mode.startswith("multimodal-"):
        return multimodal_metric(mode.split("-", 1)[1], spec_res)
    if mode == "headline":
        return HEADLINE_METRIC
    return MODE_METRIC["--" + mode]


def run_mode(mode: str, device, **kwargs) -> dict:
    """One mode's line: its function with the ``BENCH_*`` variables'
    arguments (``kwargs`` override them)."""
    fn = globals()[MODE_FUNCTIONS[mode]]
    return fn(device=device, **{**_env_kwargs(mode), **kwargs})


def _require_device(dev: torch.device, metric: str, timeout_s: float) -> None:
    """Raise when the card fails to start; print an error line and leave
    when it does not start within ``timeout_s`` (a hung driver would
    otherwise hang the run)."""
    done: dict = {}

    def probe():
        try:
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)
            done["ok"] = True
        except Exception as e:                            # noqa: BLE001
            done["error"] = _short_err(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        _emit(_error_line(metric, f"TimeoutError: the device {dev} did not "
                                  f"start within {timeout_s:.0f}s"))
        # the probe thread is still inside the driver: leave without the
        # interpreter's finalisation
        os._exit(1)
    if "error" in done:
        raise RuntimeError(done["error"])


def _run(args: argparse.Namespace, dev: torch.device) -> int:
    """Measure in this process: the line, exit 0; an error line, exit 1."""
    mode = mode_of(args)
    metric = metric_of(mode)
    if os.environ.get("BENCH_BUDGET_S"):
        _budget_end[0] = time.monotonic() + float(os.environ["BENCH_BUDGET_S"])
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if dev.type == "cuda":
            _require_device(dev, metric,
                            float(os.environ.get("BENCH_DEVICE_TIMEOUT", 60)))
        line = run_mode(mode, dev)
    except Exception as e:                                # noqa: BLE001
        traceback.print_exc()
        _emit(_error_line(metric, _short_err(e)))
        return 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    _emit(line)
    return 0


class _Stopped(Exception):
    """A signal reached the supervisor."""


def _settle(state: dict, reason: str, metric: str) -> int:
    """The supervisor's line: the final one; else the newest partial,
    marked; else an error line (exit 1)."""
    final, partial = state["final"], state["partial"]
    if final is not None and final.get("unit") != "error":
        _emit(final)
        return 0
    if partial is not None:
        _emit({**partial, "partial": True,
               "stopped_by": final["error"] if final is not None
               else reason})
        return 0
    _emit(final if final is not None else _error_line(
        metric, f"RuntimeError: no measurement completed before {reason}"))
    return 1


def _supervise(argv: Sequence[str], metric: str,
               child: Optional[Sequence[str]] = None) -> int:
    """Run the measurement as a child process (``child``: its command, by
    default this module with ``argv``) under ``BENCH_TOTAL_BUDGET``; print
    the child's final line, or on the deadline, a signal or a child that
    ended without one, the newest ``PARTIAL`` it printed, marked."""
    total = float(os.environ.get("BENCH_TOTAL_BUDGET", 240))
    env = dict(os.environ, BENCH_SUPERVISED="1")
    if total > 0:
        # the child's own budget leaves the parent time to stop it and print
        env.setdefault("BENCH_BUDGET_S", str(max(total * 0.92 - 5.0, 5.0)))
    cmd = list(child) if child is not None else (
        [sys.executable, "-m", __spec__.name] + list(argv))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))
    state: dict = {"partial": None, "final": None}

    def reader():
        for raw in proc.stdout:
            line = raw.rstrip("\n")
            try:
                if line.startswith("PARTIAL "):
                    state["partial"] = json.loads(line[len("PARTIAL "):])
                    continue
                if line.lstrip().startswith("{"):
                    state["final"] = json.loads(line)
                    continue
            except json.JSONDecodeError:
                pass
            if line:
                print(line, file=sys.stderr, flush=True)

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    def on_signal(signum, _frame):
        raise _Stopped(f"signal {signum}")

    old = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            old[sig] = signal.signal(sig, on_signal)
    try:
        proc.wait(timeout=total if total > 0 else None)
        reason = f"child exit rc={proc.returncode} without a final result"
    except subprocess.TimeoutExpired:
        reason = f"BENCH_TOTAL_BUDGET={total:.0f}s deadline"
    except _Stopped as e:
        reason = str(e)
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t.join(timeout=10)
    return _settle(state, reason, metric)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one mode and print its line; the exit code (0: a measured value
    was printed)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    metric = metric_of(mode_of(args))
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        _emit(_error_line(metric, _short_err(e)))
        return 1
    if (os.environ.get("BENCH_SUPERVISED") == "1"
            or os.environ.get("BENCH_NO_SUPERVISOR") == "1"):
        return _run(args, dev)
    return _supervise(argv, metric)


if __name__ == "__main__":
    sys.exit(main())
