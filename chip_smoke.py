"""Chip smoke test of the PyTorch port on one NVIDIA H100 (phase 16 on
every visible card).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel from ``csrc/``, all sources at
              once; prints ptxas's register / shared-memory / spill lines
              (for the IIR kernels a summary and the serving path's
              instantiations, the given-state ones without spills; the
              spectrogram block's f32 and bf16
              tensor-core kernels, both wide convs' three
              instantiations included, must not spill), each block's
              shared memory for f32 and bf16, and, where ``cuobjdump`` is
              found, the ``HMMA`` instructions in each kernel's SASS (TF32
              in the f32 kernels, BF16 in the bf16 ones) and the duty
              kernel's ``HGMMA`` (every instantiation, no ``HMMA``, no
              spills), and the duty kernel's shared-memory layout held
              equal to ``cuda_duty.smem_layout``;
3. kernels  — every serving kernel against its plain PyTorch version on
              the card (float32 with TF32 off; bf16 for the spectrogram
              block), at the main path's shapes, with the bounds of the JAX
              package's kernel tests: the IIR kernels at B=256 and B=4
              lane counts, timed beside the block-Toeplitz matmul route
              (the JAX package's route on its own chip, a few torch calls),
              and on a DC-offset input at B=4's shortest chunk;
              ``filtfilt`` timed at its shapes; the spectrogram block's f32
              time beside the cuDNN chain's, its useful TFLOP/s, and its
              3xTF32 tensor-core bound beside the f32 CUDA-core one; its
              bf16 kernel at blocks 1-2 of the serving size, B=256 and
              B=4, held against the float32 chain and the plain bf16
              chain; the wide
              block (Cout 64/128/256: three launches of one tensor-core
              conv, 3xTF32 in f32, bf16 in bf16) on the planes of a 64x48
              input and on a 100x76 plane, as one CUDA graph (and eagerly),
              each beside its bound and the cuDNN chain; the bf16 kernel
              at the 200x150 preset's
              block 1, B=256 and B=4;
4. main     — the serving entry at B=4 on cuda, NaN route (a NaN run in one
              EEG channel of one window, a NaN pixel and an all-NaN
              spectrogram row) and finite route, with every kernel's
              launch counter read around that run and held to one
              forward's launches; log-probs held against
              the same forward on the CPU's plain versions; then the bf16
              program (``serving_dtype=torch.bfloat16``) the same way, its
              probabilities held against the float32 program's;
5. wide     — SpectrogramCNN with fused blocks 3, 4 (64x48 input) and 5
              (64x64) against the unfused model, float32 and bf16, with the
              wide kernel's launches read around that run;
6. timing   — the serving forward at B=256 (windows/s) and at B=4 (ms per
              batch), both routes, float32 and bf16, eager and captured as
              one CUDA graph (``capture_forward``, held equal to eager on
              two inputs); kernels launched per forward (profiler);
7. routes   — the spectrogram chain's other routes and eeg_transform,
              each path with its own launch counts: (A) the
              reduced-resolution serving preset (``signal=
              config.SPEC_RES_PRESET``, 200x150 ``resize_mode="resample"``,
              the JAX bench's ``BENCH_SPEC_RES=200x150``) through phases 4
              and 6 again: held against the CPU and float32, the fused
              block once a forward (block 2's 100x75 plane is odd), then
              timed beside phase 6's 400x300 programs; (B) the op-by-op
              reference chain (``linear_ops=False``, the notch
              ``filtfilt`` through two IIR launches; no serving program
              takes it) on both resize modes, float32 and bf16, against
              the CPU and the dense-operator route, and its cost beside
              the dense route's at B=256; (C) ``eeg_transform`` (the IIR
              kernel along axis -2) against the CPU, then timed at B=256;
8. stem     — the EEGNet stem reassociated (as served) against canonical,
              log-probs held, with cuDNN's FFT-convolution share of device
              time for each (profiler), B=256 and B=4;
9. xai      — input-gradient attribution through the fused serving model
              (``explain_entry``): saliency, Grad-CAM, IG and expected
              gradients at B=4 (B=2 for the spectrogram sweeps) held
              against the CPU and against the unfused model, with the fused
              block's launches and backward calls read around them; then
              their times at B=256 (IG on the spectrogram branch at B=32)
              and the fused block's VJP beside the cuDNN chain's backward;
10. train    — the training path (``entry.train_entry``, the JAX bench's
              ``--train`` program; ``entry.train_multimodal``, the JAX
              CLI's ``train-multimodal --demo`` loop): a float32 step at
              B=4 against the CPU (loss, gradient norm, every gradient,
              BatchNorm statistics), the IIR kernels' launches read around
              the entry's step on both EEG routes, the NaN sentinel on the
              card (bitwise), the loss falling over 10 steps in float32 and
              bf16, two epochs of ``train_multimodal`` with checkpoints and a
              bitwise resume, then ms/step, training windows/s, peak memory,
              idle share and top device ops at B=256 (bf16 and float32,
              finite route; bf16 on the NaN route);
11. convprobe — the conv probe's duty kernel (a ``wgmma`` loop) against its
              plain version at the probe's four GEMM shapes (exactly on
              integer operands), then its time and rate at R=512 beside
              its bounds by operations and by shared memory (at the SM
              clock read during the run) and the R library products as
              one CUDA graph.
12. diffusion — the DiffEEG diffusion path at full width (``entry.
              train_diffeeg`` and ``entry.generate``, the JAX CLI's
              ``train-diffeeg`` and ``generate``): the training set's
              transform (#1) against the CPU with its launches; the STFT
              conditioner, the denoiser (gathered and dense conditioning,
              amp) and one K=50, B=64 step against the CPU on the same
              draws; the NaN sentinel bitwise; the loss falling in float32
              and amp; a bitwise resume of ``train_diffeeg``; the sampler's
              NaN guard; ``generate`` for all 6 classes with 1,000 steps;
              the step's, the sampler's, the conditioning's and the
              metrics' times.
13. realdata — the real-data training paths at full width from a
              synthetic HMS tree in numpy form (256 eeg_ids x 5 rows, the
              window cache and .npy spectrograms, no pandas): (a)
              ``entry.train_multimodal(data_root=...)``, one epoch of fold
              0 at B=256 in bf16 and float32, its first step's loss held
              to the same step on the numpy gather's batch; (b)
              ``entry.train_wavenet``, one fold, one epoch at B=16; (c)
              ``entry.grid_search``, 3 candidates a grid step, each held
              against the candidate trained alone, the grid step within
              1.1x of 3 single steps; (d)
              ``entry.train_diffeeg(data_root=...)``, two steps at K=4;
              the host library's gather and queue bitwise against numpy;
              ms a step, windows/s, the host gather, peak memory, and a
              ``{"realdata": ...}`` line.
14. zoo      — on phase 13's tree: (a) the 10 zoo models no other phase
              runs (all but the serving pair, the WaveNet and the DiffEEG
              denoisers), at full width, B=4, against the CPU, and a forward's time and peak memory at
              B=64; (b) ``entry.train_branch("eeg")`` for all 8 EEG archs
              (B=256) and (c) ``train_branch("spectrogram")`` for all 4
              spectrogram archs (B=64), one epoch of fold 0 each: ms a
              step, training windows/s, peak memory; (d)
              ``train_multimodal(data_root=..., init_from=...)`` from the
              default archs' checkpoints, its model at the first step
              bitwise equal to them; (e) rollout of the ViT and the EEG
              transformer against the CPU; (f) ``retrain_on_top_channels``
              (N=5, 2 epochs) ranked by gradient SHAP of (b)'s model; a
              ``{"zoo": ...}`` line.
15. cli      — the command line in-process (``cli.main``) on phase 13's
              tree at full width: (a) ``train-multimodal --epochs 1
              --one-fold --lime-every 1``, then ``predict`` over every row
              at B=256 with ``--fused-spec 2`` and ``0``, both held against
              ``entry.make_forward`` of the best checkpoint (1e-3, argmax
              where the top two are apart), rows/s end to end, the
              forward's ms a batch, the LIME snapshot's ms; (b) ``predict
              --eval``; (c) ``xai --fused-spec 2 --limit 8``, LIME's ridge
              weights against the unfused branch, each method's ms; (d)
              ``sanity-check --epochs 5``, ``dump-config`` where PyYAML
              imports, the "plot skipped" lines without matplotlib; a
              ``{"cli": ...}`` line.
16. parallel — the parallel programs on a world of each size of 1, 2
              and 4 that the visible cards hold (``parallel.launch.spawn``:
              NCCL, one card a rank; a world of one runs in this process);
              the worlds run are printed: (a) ``Trainer(mesh=...)`` on the
              multimodal training model, f32, B=256, 3 steps, against the
              same steps without a mesh (bitwise at a world of one; above
              one the first loss against the single-device replay and the
              full-width WaveNet's SGD step against the single device's),
              ms a step, windows/s, idle share, the all-reduce's ms, bytes
              and bus bandwidth, and B=256 a card on the largest world;
              (b) ``entry.dryrun_multichip(world)`` on the JAX mesh; (c)
              the full-width long-EEG encoder with rollout over B=2 × one
              hour (T=720,000) at seq = world against its single-card
              forward, ms and each card's peak GiB, the halo conv across
              cards (K = 3, 5, 7, 9) under the flags the ranks were
              started with; (d) sharded IG and SHAP at B=8 over the EEG branch
              and the fused spectrogram forward against the unsharded
              functions (1e-6); (e) ``DiffEEGTrainer(mesh=...)`` at full
              width against the single device; (f) above one rank,
              ``predict --mesh N`` against phase 15's one-card predictions
              and ``train-multimodal --mesh N``; then the CLI's
              ``long-eeg`` over every card and, on more than one card,
              ``initialize_multihost`` without ``LOCAL_RANK``; a
              ``{"parallel": ...}`` line with every world's record.
17. ops api  — the public DSP API: ``ops.lfilter`` under each of the JAX
              package's engines (auto, pallas, scan, blockmm, block, xla),
              from zero and from a random per-lane state (#1's given-state
              mode), and along axis 0, ``ops.filtfilt`` under blockmm and
              the kernel, against float64 scipy and the CPU, with every
              kernel's launches read around that run; #1 from a given
              state at 5,120 x 10,000 against its plain version, timed
              beside #1 from zero, the block-Toeplitz route and the
              ``block``/``blockmm`` routes; an ``{"ops_api": ...}`` line.
18. bench    — the port's ``bench`` command: ``python -m ..._torch bench``
              as a subprocess at full width (B=256, BENCH_SCAN=64), its
              line held (exit 0, a finite value, the card's name,
              ``vs_baseline`` null); the headline's step against #2's
              plain version on the card, the BENCH_FUSED_SPEC=2 multimodal
              step against the unfused one; every other mode through its
              mode function (``BENCH_CUTS``), each line, its seconds and
              its launches; the duty probe's outputs against the plain
              version.

Output: a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, then the
last line ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` are
the main path's (phase 4; phase 5 for the wide kernel), and for
``iir_sosfilt`` also paths B and C (its ``main_launches`` is phase 4's);
``routes_launches`` holds each path of phase 7 apart, ``train_launches``
(IIR rows) phase 10's training path, ``diffusion_launches``
(``iir_sosfilt``) phase 12's ``train_diffeeg`` run, ``realdata_launches``
(IIR rows) phase 13's four paths summed, ``zoo_launches`` (IIR rows) phase
14's paths summed, ``cli_launches`` (every row) phase 15's commands
summed, ``parallel_launches`` (every row) phase 16's runs summed over
its ranks, ``ops_api_launches`` (every row) phase 17's run; the row
``iir_sosfilt_given`` (#1 from a given state) has phase 17's launches as
its ``launches``; ``bench_launches`` (every row) phase 18's in-process
runs summed.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 on the tensor cores
SMEM_BYTES_PER_CLK, N_SMS = 128, 132   # H100 SXM shared memory a clock an SM
B_MAIN, B_TIME = 4, 256
LOGP_ATOL = 1e-3                 # GPU vs CPU log-probs (see main_path)
# Attributions, card vs CPU and fused vs unfused (see phase_xai), relative
# to the reference tensor's max |value|: float32 on both sides with sums in
# other orders (cuDNN's backward convolutions use atomics), the JAX
# package's attribution bound rtol 1e-3 (tests/test_xai.py:229).
XAI_REL = 1e-3
# Spectrogram input gradients pass ReLUs and max pools in five blocks.
# Where the two sides' roundings (fused kernel vs cuDNN, card vs CPU, NHWC
# vs NCHW algorithms) put a ReLU input or a max-pool pair on opposite sides
# of a tie, the gradient steps by that unit's whole contribution, and a
# unit of blocks 3-5 reaches much of the image.  At full width a few such
# flips per sample are expected: on the CPU alone the fused and unfused
# models differ by 8e-3 (max) and 3e-3 (normwise) on a random spectrogram
# for this reason, while the fused block alone agrees to 4e-7; card vs CPU
# saliency at B=4 differed by 2.6e-2 (max) and 3.8e-3 (normwise).  The
# normwise bound is the guard: a wrong gradient differs by O(1).
XAI_KINK_REL, XAI_KINK_NORM = 1e-1, 1e-2
# bf16 program: probabilities within 2e-2 of the float32 program's, the JAX
# package's bf16-versus-f32 bound (tests/test_models.py:176-186)
BF16_PROB_ATOL = 2e-2
# a captured forward replays the eager forward's kernels on the same inputs
GRAPH_ATOL = 1e-6
# bf16 fused block vs the plain bf16 chain, relative to the chain's max
# |value|: both accumulate exact bf16 products in float32, in other orders,
# so a stage's bf16 rounding (2^-8 relative) can flip by one unit; a flip
# near the tensor's maximum is ~4e-3 of it, and flips of earlier stages
# reach the output damped by the weights
BF16_PLAIN_REL = 1e-2
DUTY_REL = 1e-4                  # duty kernel vs plain (exact bf16 products)
SUSTAIN_MAX_S = 30.0             # longest wait for an SM clock reading
# Training step at full width, B=4, card vs CPU (float32, TF32 off; both
# also against the CPU in float64).  float32 itself is this far from
# float64 here (CPU, one step; BatchNorm's E[x²] − E[x]² cancels at 200x150
# planes): gradient norm 0.8-1.6e-4 relative, single gradients up to 1.1e-2
# of their tensor's max (2.2e-2 for BatchNorm 1's bias, zero in exact
# arithmetic), running means up to 5.9e-5 of their max.  The bounds sit
# above that; the loss agrees to ~1e-7.
TRAIN_LOSS_REL, TRAIN_NORM_REL = 1e-5, 1e-3
TRAIN_GRAD_REL, TRAIN_BN_REL = 3e-2, 1e-4
# all gradients against the CPU's float64 step, normwise: the card within
# twice the CPU float32's distance (measured: card 1.35e-3, CPU 1.59e-3)
TRAIN_F64_FACTOR = 2.0
TRAIN_L2 = 1e-3                  # train_entry's l2_lambda
TRAIN_STEPS = 8                  # timed steps, as bench.py's bench_train
# DiffEEG at full width (phase 12): micro-batch, accumulation, generate's
# windows a class, raw windows of the train_diffeeg run, reverse steps timed
DIFF_B, DIFF_K, GEN_B, DIFF_N, SAMPLER_STEPS = 64, 50, 50, 300, 200
# DiffEEG card vs CPU (float32, TF32 off), relative to the CPU's max |value|:
# the conditioner and the denoiser at B=64
DIFF_REL = 1e-4
DIFF_DENSE_ATOL = 3e-3           # gathered vs dense (tests/test_diffusion.py)
# the amp forward differs from float32 by more than this share of the max
# (bf16 keeps 8 bits; a model that kept float32 would sit at 0)
DIFF_AMP_FLOOR = 1e-4
# the full-width step, card vs CPU: loss; gradient norm and Adam's first
# moment (0.1 g after one step) normwise; after Adam's first step each
# parameter moved by ~lr·sign(g): where |g| exceeds DIFF_FAR of its max the
# two agree to float32 rounding (+1e-3 lr); elsewhere a rounding-level g
# may change sign, which no bound below 2 lr (the most two first steps can
# differ) would allow, so that share is printed and not bounded
DIFF_LOSS_REL, DIFF_NORM_REL, DIFF_FAR = 1e-5, 1e-3, 1e-3
# the metrics on the card against the CPU in float64: Fréchet relative,
# Pearson (in [-1, 1], near 0 here) absolute; MMD at the bandwidth that
# puts the median real×generated kernel entry at e⁻¹, absolute (see
# _diff_generation)
DIFF_METRIC_REL, PEARSON_ATOL = 1e-3, 1e-5
# Real-data paths (phase 13): a synthetic HMS tree in numpy form of RD_IDS
# eeg_ids × RD_ROWS rows (the Kaggle train.csv has about 6 rows an id),
# RD_EEG_LEN-sample recordings cropped to 10,000, (400, RD_SPEC_T)
# spectrogram planes; the WaveNet's batch; the grid's candidates against
# the same candidate trained alone (16 Adam steps, float32 with TF32 off);
# a grid step of 3 candidates against 3 single steps
RD_IDS, RD_ROWS, RD_EEG_LEN, RD_SPEC_T = 256, 5, 12_000, 340
RD_WAVENET_B, RD_SEED, RD_GRID_REL, RD_GRID_RATIO = 16, 42, 1e-4, 1.1
# epochs of (a) a program: the bf16 run is long enough for a steady-state
# rate over many steps (4 steps an epoch), the f32 one only checks
RD_EPOCHS = {"bf16": 5, "float32": 1}
PKG = "multimodal_brain_pattern_identification_xai_tpu_torch"
#: (Cin, Cout) of the wide kernel's instantiations: blocks 3-5
WIDE_SHAPES = ((32, 64), (64, 128), (128, 256))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls captured in one
    CUDA graph (the host's launch time left out), CUDA events over five
    replays; warmed up on a side stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def bound_ms(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def signal(shape, scale, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32, device=dev)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def norm_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / (b.norm() + 1e-30))


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return smi


def _iir_ptxas(log: str) -> None:
    """ptxas on csrc/iir.cu (84 instantiations: K = 1..12 × variant): the
    register range, then the serving path's kernels — sosfilt K=5 (NaN
    route, zero init), rolldec K=11 and K=6, sosfilt K=1 with zi (filtfilt's
    notch) — and the ops API's sosfilt K=5 from a given state, with their
    registers and spills; the 24 given-state instantiations must not
    spill."""
    stats, func = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            func = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and func:
            stats.setdefault(func, {})["stack/spill st/ld B"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            stats.setdefault(func, {})["registers"] = int(m.group(1))
    regs = [v["registers"] for v in stats.values() if "registers" in v]
    require(len(regs) == 84, f"iir.cu: {len(regs)} kernels in ptxas's log")
    print(f"[build] iir: {len(regs)} chunked_scan_kernel and "
          f"given_scan_kernel instantiations, {min(regs)}-{max(regs)} "
          f"registers")
    # chunked_scan_kernel<K, start (0 zero, 1 steady), VEC, Out>,
    # given_scan_kernel<K, VEC>
    path = {"sosfilt K=5": r"ILi5ELi0ELb1ENS_8StoreOutILb1E",
            "rolldec K=11": r"ILi11ELi0ELb1ENS_7MeanOut",
            "rolldec K=6": r"ILi6ELi0ELb1ENS_7MeanOut",
            "sosfilt K=1 zi": r"ILi1ELi1ELb0ENS_8StoreOutILb0E",
            "sosfilt K=5 given state": r"given_scan_kernelILi5ELb1E"}
    for what, pat in path.items():
        found = [v for f, v in stats.items() if re.search(pat, f)]
        require(len(found) == 1, f"iir.cu: no single kernel for {what}")
        print(f"[build] iir {what}: {found[0]}")
    given = {f: v for f, v in stats.items()
             if re.search(r"given_scan_kernelILi\d+ELb", f)}
    require(len(given) == 24, f"iir.cu: {len(given)} given-state kernels")
    spilled = {f: v["stack/spill st/ld B"] for f, v in given.items()
               if v.get("stack/spill st/ld B", ("0", "0", "0"))[1:]
               != ("0", "0")}
    require(not spilled, f"iir.cu: given-state kernels spill: {spilled}")
    print(f"[build] iir given state: 24 instantiations, "
          f"{min(v['registers'] for v in given.values())}-"
          f"{max(v['registers'] for v in given.values())} registers, "
          f"no spills")


def phase_build(card: str) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch import _build
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_duty, cuda_specblock)
    t0 = time.perf_counter()
    _build.build(["iir", "specblock", "duty"])
    print(f"[build] nvcc iir.cu + specblock.cu + duty.cu in "
          f"{time.perf_counter() - t0:.1f} s (all in parallel; empty log "
          f"= already built)")
    for name, log in sorted(_build.build_logs.items()):
        if name == "iir":
            _iir_ptxas(log)
            continue
        func = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"[build] {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            tc = func and re.search(
                r"specblock_(bf16_)?tc_kernel|wide_(bf16|tf32)_conv_kernel"
                r"|duty_kernel", func)
            if m and tc:
                print(f"[build] {tc.group(0)} ({func}): spill stores "
                      f"{m.group(1)} B, spill loads {m.group(2)} B")
                require(m.group(1) == m.group(2) == "0",
                        f"{func} spills registers")
    lib = cuda_specblock._lib()
    for cin, co in ((3, 16), (16, 32)):
        print(f"[build] specblock dynamic smem (cin={cin}, cout={co}): f32 "
              f"(3xTF32) {lib.specblock_smem_bytes(cin, co, 0)} bytes, "
              f"bf16 (bf16 tensor cores) "
              f"{lib.specblock_smem_bytes(cin, co, 1)} bytes")
    for cin, co in WIDE_SHAPES:
        print(f"[build] specblock wide smem (cin={cin}, cout={co}), static, "
              f"each of three launches: f32 (wide_tf32_conv_kernel) "
              f"{lib.specblock_smem_bytes(cin, co, 0)} bytes, bf16 "
              f"(wide_bf16_conv_kernel) {lib.specblock_smem_bytes(cin, co, 1)}"
              f" bytes")
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    if Path(cuobjdump).exists():
        counts, func = {}, None
        for name in ("specblock", "duty"):
            sass = subprocess.run([cuobjdump, "-sass",
                                   str(_build._target(name))],
                                  capture_output=True, text=True, timeout=120,
                                  check=True).stdout
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    func = m.group(1)
                m = re.search(r"HMMA\.(\w+)\.F32\.(TF32|BF16)|HGMMA\.\w+"
                              r"\.F32\.BF16", line)
                if m and func:
                    key = (func, m.group(0))
                    counts[key] = counts.get(key, 0) + 1
        for (func, op), n in sorted(counts.items()):
            print(f"[build] SASS {func}: {n} {op} instructions")
        # the bf16 kernel: Cout 8/16/32, each fused (conv x3 + pool) and
        # whole (the block's epilogue too)
        for kern, op, n in (("specblock_tc_kernel", "TF32", 3),
                            ("specblock_bf16_tc_kernel", "BF16", 6),
                            ("wide_bf16_conv_kernel", "BF16", 3),
                            ("wide_tf32_conv_kernel", "TF32", 3)):
            found = {f for f, o in counts if kern in f and o.endswith(op)}
            require(len(found) == n, f"{kern}: {len(found)} of {n} "
                    f"instantiations contain {op} HMMA")
        # the duty kernel: every instantiation a wgmma loop, no mma.sync
        hgmma, hmma = ({f for f, o in counts if "duty_kernel" in f
                        and o.startswith(op)} for op in ("HGMMA", "HMMA"))
        require(len(hgmma) == len(cuda_duty.SHAPES) and not hmma,
                f"duty_kernel: {len(hgmma)} of {len(cuda_duty.SHAPES)} "
                f"instantiations contain HGMMA, {len(hmma)} HMMA")
    else:
        print("[build] cuobjdump not found: SASS not inspected")
    log = _build.build_logs.get("duty", "")
    require("serializ" not in log, "ptxas serialized the duty kernel's "
            "wgmma: " + "; ".join(ln for ln in log.splitlines()
                                  if "serializ" in ln))
    if log:
        print(f"[build] duty: no wgmma serialized; ptxas injected "
              f"warpgroup.arrive (C7519) {log.count('C7519')} times over "
              f"{len(cuda_duty.SHAPES)} kernels")
    for co, k in cuda_duty.SHAPES:
        lay = cuda_duty.kernel_layout(co, k)
        require(lay == cuda_duty.smem_layout(co, k),
                f"duty ({co}, {k}): the kernel's layout {lay} differs from "
                f"smem_layout's {cuda_duty.smem_layout(co, k)}")
        print(f"[build] duty (co={co}, k={k}): dynamic smem "
              f"{lay['smem_bytes']} bytes; layout "
              f"(kernel = smem_layout) A 128-byte swizzle, tile "
              f"{lay['a_tile']} B, LBO {lay['a_lbo']}, SBO {lay['a_sbo']}; B "
              f"32-byte swizzle at {lay['b_offset']}, SBO {lay['b_sbo']}, "
              f"k16 step {lay['b_kstep']} B")


def _cudnn_chain(x, ks, bs, pool, dtype):
    """The library yardstick of the fused block: cuDNN conv×3 + pool on
    NCHW in ``dtype`` (never used by the port)."""
    import torch.nn.functional as F
    xn = x.permute(0, 3, 1, 2).contiguous().to(dtype)
    wn = [k.permute(3, 2, 0, 1).contiguous().to(dtype) for k in ks]
    bn = [b.to(dtype) for b in bs]

    def run():
        h = xn
        for wk, bk in zip(wn, bn):
            h = F.relu(F.conv2d(h, wk, bk, padding=1))
        return F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return run


def specblock_case(card, dev, what, b, h, w, cin, co, pool, dtype, reps,
                   wscale=None, graph=False) -> dict:
    """The fused block at one shape and storage type on the card: held
    against its plain version (float32: rtol = atol = 1e-5; bf16: the
    JAX package's tensor-scale bound against the float32 chain, max 0.03,
    mean 0.003, and BF16_PLAIN_REL against the plain bf16 chain), then
    timed beside the plain chain and the cuDNN chain in the same type, on
    x already in that type (as the serving path passes it); ``graph``:
    ``reps`` calls captured in one CUDA graph, for sizes where the host's
    launches would outlast the device (then also timed eagerly,
    ``ms_eager``).  Weights ~ N(0, wscale²), by default at the He scale so
    that activations stay O(1).  Bound: x, weights and the output moved
    once against the useful operations at the rate of the kernel's
    datapath: 3xTF32 (three tensor-core products per useful one at 495
    TFLOP/s; the pool on the CUDA cores) for float32, 989 TFLOP/s for
    bf16."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    name = cuda_specblock.kernel_name(co, dtype)
    rng = np.random.default_rng(4)
    mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh),
                                     dtype=torch.float32, device=dev)
    if wscale is None:
        wscale = float(np.sqrt(2 / (9 * cin)))
    ks = [mk(3, 3, ci, co) * wscale for ci in (cin, co, co)]
    bs = [mk(co) * 0.1 for _ in range(3)]
    x = mk(b, h, w, cin)
    xs = x.to(dtype)
    fused = lambda: cuda_specblock.fused_specblock_convpool(
        xs, ks, bs, pool=pool, dtype=dtype)
    plain = lambda: cuda_specblock._plain_convpool(xs, ks, bs, pool, dtype)
    y, y_plain = fused(), plain()
    truth = cuda_specblock._plain_convpool(x, ks, bs, pool, torch.float32)
    err = max_abs(y.float(), y_plain.float())
    if dtype == torch.float32:
        torch.testing.assert_close(y, truth, rtol=1e-5, atol=1e-5)
        held = f"max abs {err:.2e} (bound rtol = atol = 1e-5)"
    else:
        e = (y.float() - truth).abs() / truth.abs().max()
        e_plain = rel(y.float(), y_plain.float())
        require(float(e.max()) < 0.03 and float(e.mean()) < 0.003,
                f"specblock {what} bf16 err max {float(e.max())} mean "
                f"{float(e.mean())}")
        require(e_plain < BF16_PLAIN_REL, f"specblock {what} bf16 vs the "
                f"plain bf16 chain: {e_plain}")
        held = (f"vs the float32 chain max {float(e.max()):.2e} mean "
                f"{float(e.mean()):.2e} (tensor scale, bounds 0.03 / 0.003)"
                f"; vs the plain bf16 chain max abs {err:.2e}, "
                f"{e_plain:.2e} of its max (bound {BF16_PLAIN_REL})")
    del y, y_plain, truth
    timer = graph_ms if graph else cuda_ms
    ms = timer(fused, reps)
    ms_eager = cuda_ms(fused, reps) if graph else ms
    plain_ms = timer(plain, reps)
    lib_ms = timer(_cudnn_chain(x, ks, bs, pool, dtype), reps)
    es = 4 if dtype == torch.float32 else 2
    nbytes = (x.numel() + b * (h // 2) * (w // 2) * co) * es + (
        sum(k.numel() for k in ks) + 3 * co) * 4
    conv_flops = 2 * 9 * (cin * co + 2 * co * co) * b * h * w
    pool_flops = (3 if pool == "max" else 4) * b * (h // 2) * (w // 2) * co
    flops = conv_flops + pool_flops
    if dtype == torch.float32:
        t_ops = max(3 * conv_flops / TF32_FLOP_PER_S,
                    pool_flops / F32_FLOP_PER_S) * 1e3
    else:
        t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bnd = max(t_bytes, t_ops)
    print(f"[kernels] {name} "
          f"{what} ({b},{h},{w},{cin})->{co} {pool}: {held}; "
          f"{'one CUDA graph: ' if graph else ''}{ms:.4f} ms = "
          f"{flops / ms / 1e9:.2f} useful TFLOP/s"
          f"{f' (eager {ms_eager:.4f} ms)' if graph else ''}; plain chain "
          f"{plain_ms:.4f}"
          f" ms; cuDNN chain {lib_ms:.4f} ms; bound {bnd:.4f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} [{card}]")
    return dict(err=err, ms=ms, ms_eager=ms_eager, plain_ms=plain_ms,
                library_ms=lib_ms, t_bytes=t_bytes, t_ops=t_ops)


def whole_block_case(card, dev, what, b, h, w, cin, co, pool, reps) -> dict:
    """The whole bf16 block (``cuda_specblock.whole_block_bf16``, one
    launch of ``specblock_bf16_tc_kernel<C, true>``) on the card, x in the
    layout the program passes it: a [0, 1] plane expanded to Cin 3
    (channel stride 0, NCHW: block 1) or ReLU outputs in channels-last
    (block 2).  Held against the block on the path autograd takes (the
    fused-only launch on an NHWC copy, then the module's stock BatchNorm,
    bilinear resize, 1x1 conv and add) at BF16_PLAIN_REL of its max: both
    share the conv core, so this holds the epilogue and the strided read;
    and against the stock eval block in float32 (the module unfused, on
    the same bf16 input) at the JAX package's tensor-scale bound, max 0.03
    and mean 0.003, beside the stock bf16 block's own distance to it.  The
    stock bf16 block is not a bound: a conv stage's one-unit flip passes
    BatchNorm's gain |weight| / sqrt(var + 1e-5) (up to ~1.8 here) before
    two more roundings, two bf16 units near the maximum, over
    BF16_PLAIN_REL; its distance is printed.  Timed beside the stock bf16 block
    (the library time) and beside the plain version (the fused kernel's
    plain chain on an NHWC copy, then the stock tail).  Weights at the
    benchmark's scales: convs N(0, 1.4/fan_in), biases and running means
    sd 0.1, BatchNorm scales 1 + N(0, 0.1), running variances U(0.5,
    1.5).  Bound: x's storage, the parameters and the output moved once
    against the block's operations (the convs and the pool as
    :func:`specblock_case` counts them; BatchNorm 4, the 1x1 conv 2 Cin and
    the add 1 an output value; the 2x2 mean 4 a pooled pixel and input
    channel) at 989 TFLOP/s."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        layers)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    rng = np.random.default_rng(5)
    mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh),
                                     dtype=torch.float32)
    blk = layers.SpectrogramBlock(cin, co, pool_type=pool,
                                  dtype=torch.bfloat16)
    with torch.no_grad():
        for m in (blk.conv1, blk.conv2, blk.conv3, blk.conv1x1):
            m.weight.copy_(mk(*m.weight.shape)
                           * (1.4 / m.weight[0].numel()) ** 0.5)
            m.bias.copy_(mk(co) * 0.1)
        blk.bn.weight.copy_(1 + 0.1 * mk(co))
        blk.bn.bias.copy_(0.1 * mk(co))
        blk.bn.running_mean.copy_(0.1 * mk(co))
        blk.bn.running_var.copy_(0.5 + torch.as_tensor(rng.random(co),
                                                       dtype=torch.float32))
    blk = blk.to(dev).eval()
    blk32 = copy.deepcopy(blk)
    blk32.dtype = None
    if cin == 3:
        base = torch.as_tensor(rng.random((b, 1, h, w)), dtype=torch.float32,
                               device=dev).to(torch.bfloat16)
        x = base.expand(b, 3, h, w)
    else:
        base = mk(b, h, w, cin).to(dev).relu().to(torch.bfloat16)
        x = base.permute(0, 3, 1, 2)
    convs = (blk.conv1, blk.conv2, blk.conv3)
    ks = [c.weight.permute(2, 3, 1, 0) for c in convs]
    bs = [c.bias for c in convs]
    bn = blk.bn
    whole = lambda: cuda_specblock.whole_block_bf16(
        x, ks, bs, pool, (bn.weight, bn.bias, bn.running_mean,
                          bn.running_var),
        (blk.conv1x1.weight, blk.conv1x1.bias)).permute(0, 3, 1, 2)

    def tail(convpool):
        y = bn(convpool(x.permute(0, 2, 3, 1).contiguous(), ks, bs, pool,
                        torch.bfloat16).permute(0, 3, 1, 2))
        return y + layers._conv(blk.conv1x1,
                                layers.bilinear_resize(x, y.shape[2:]))

    todays = lambda: tail(cuda_specblock.fused_specblock_convpool)
    plain = lambda: tail(cuda_specblock._plain_convpool)
    with torch.no_grad():
        k0 = cuda_specblock.fused_specblock_convpool.kernel_launches[
            cuda_specblock.WHOLE_KERNEL]
        y = whole().float()
        require(cuda_specblock.fused_specblock_convpool.kernel_launches[
            cuda_specblock.WHOLE_KERNEL] == k0 + 1,
            f"whole block {what}: not counted")
        e_todays = rel(y, todays().float())
        y_plain = plain().float()
        err, e_plain = max_abs(y, y_plain), rel(y, y_plain)
        del y_plain
        stock = blk(x).float()
        e_stock = rel(y, stock)
        truth = blk32(x.float())
        scale = truth.abs().max()
        e = (y - truth).abs() / scale
        e_lib = (stock - truth).abs() / scale
        require(e_todays < BF16_PLAIN_REL, f"whole block {what} vs the "
                f"block on the fused-only path: {e_todays}")
        require(float(e.max()) < 0.03 and float(e.mean()) < 0.003,
                f"whole block {what} vs the float32 block: max "
                f"{float(e.max())} mean {float(e.mean())}")
        held = (f"vs the fused-only path {e_todays:.2e} of its max (bound "
                f"{BF16_PLAIN_REL}); vs the float32 block max "
                f"{float(e.max()):.2e} mean {float(e.mean()):.2e} (tensor "
                f"scale, bounds 0.03 / 0.003; the stock bf16 block "
                f"{float(e_lib.max()):.2e} / {float(e_lib.mean()):.2e}); vs "
                f"the stock bf16 block {e_stock:.2e}, vs the plain chain + "
                f"stock tail max abs {err:.2e}, {e_plain:.2e} of its max")
        del y, stock, truth, e, e_lib
        ms = cuda_ms(whole, reps)
        plain_ms = cuda_ms(plain, reps)
        lib_ms = cuda_ms(lambda: blk(x), reps)
    ho, wo = h // 2, w // 2
    nbytes = (x.untyped_storage().nbytes() + b * ho * wo * co * 2
              + 4 * sum(p.numel() for p in blk.parameters())
              + 4 * 2 * co)                      # running mean, variance
    flops = (2 * 9 * (cin * co + 2 * co * co) * b * h * w
             + (3 if pool == "max" else 4) * b * ho * wo * co
             + (5 + 2 * cin) * b * ho * wo * co + 4 * b * ho * wo * cin)
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    layout = "expanded NCHW" if cin == 3 else "channels-last"
    print(f"[kernels] {cuda_specblock.WHOLE_KERNEL} {what} ({b},{cin},{h},"
          f"{w}) {layout} -> {co} {pool}: {held}; {ms:.4f} ms = "
          f"{flops / ms / 1e9:.2f} useful TFLOP/s; plain {plain_ms:.4f} ms; "
          f"stock block {lib_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} [{card}]")
    return dict(err=err, ms=ms, ms_eager=ms, plain_ms=plain_ms,
                library_ms=lib_ms, t_bytes=t_bytes, t_ops=t_ops)


def sum_cases(cases) -> dict:
    """One kernel record over several shapes: times and bounds summed
    (the bound of the sum is the larger of the summed byte and operation
    times), the largest error."""
    t_bytes = sum(c["t_bytes"] for c in cases)
    t_ops = sum(c["t_ops"] for c in cases)
    return dict(err=max(c["err"] for c in cases),
                ms=sum(c["ms"] for c in cases),
                ms_eager=sum(c["ms_eager"] for c in cases),
                plain_ms=sum(c["plain_ms"] for c in cases),
                library_ms=sum(c["library_ms"] for c in cases),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(card: str, dev) -> dict:
    """Kernel vs plain version on the card; returns per-kernel records
    with the error and the timings at B_TIME main-path shapes."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import config
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, iir, preprocess)

    bp5 = iir.butter_bandpass(0.5, 20.0, 200.0, 5)
    bp6 = iir.butter_bandpass(0.5, 20.0, 200.0, 6)
    casc = iir.cascade(bp5, bp6)
    notch = iir.iirnotch(60.0, 30.0, 200.0)
    rec = {}
    T = 10_000

    # --- #1 sosfilt (K=5, zero init: the NaN route's first bandpass, B·20
    # lanes) and #2 rolldec (K=11: the finite route's cascade, B·20 lanes;
    # K=6: the NaN route's second bandpass, B·38 lanes), at B_TIME and
    # B_MAIN.  Plain version: the sequential scan on the card (host clock).
    # Library yardstick: the block-Toeplitz matmul route (a few torch
    # calls, the JAX package's route on its own chip; never used by the
    # port's kernels).  Bound: x read once and y written once against 9 flop
    # per biquad step (+1 per sample for the mean).
    rolldec_map = preprocess._rolldec_map(128)
    for batch, reps in ((B_TIME, 5), (B_MAIN, 50)):
        for name, coeffs, per in (("iir_sosfilt", bp5, 20),
                                  ("iir_sosfilt_rolldec", casc, 20),
                                  ("iir_sosfilt_rolldec", bp6, 38)):
            k, lanes = len(coeffs.sos), batch * per
            roll = name == "iir_sosfilt_rolldec"
            x = signal((lanes, T), 20 if roll else 40, k, dev)
            run = (lambda: cuda_iir.sosfilt_rolldec(coeffs, x)) if roll else \
                (lambda: cuda_iir.sosfilt(coeffs, x))
            y = run()
            t0 = time.perf_counter()
            y_plain = iir._sos_scan(x, coeffs.sos)
            if roll:
                y_plain = y_plain.reshape(lanes, T // 4, 4).mean(-1)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            r = rel(y, y_plain)
            require(r < 2e-4, f"{name} K={k} ({lanes} lanes) rel err {r}")
            ms = cuda_ms(run, reps)
            lib_ms = cuda_ms(lambda: iir._cascade_block_matmul(
                x, coeffs.sos, 128, out_map=rolldec_map if roll else None),
                max(3, reps // 5))
            b, b_by = bound_ms(lanes * T * 4 * (1.25 if roll else 2),
                               (9 * k + roll) * lanes * T)
            L, C, G = cuda_iir.launch_shape(lanes, T, k)
            print(f"[kernels] {name} K={k} ({lanes}, {T}) B={batch}: rel "
                  f"{r:.2e}, {ms:.4f} ms (chunks of {L}, {C} a lane, {G} "
                  f"lanes a CTA); block-matmul route {lib_ms:.4f} ms; plain "
                  f"scan {plain_ms:.1f} ms (host clock); bound {b:.4f} ms by "
                  f"{b_by} [{card}]")
            if batch == B_TIME and k != 6:
                rec[name] = dict(err=max_abs(y, y_plain), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b, bound_by=b_by,
                                 library_ms=lib_ms)
            if batch == B_MAIN and k != 6:
                rec[name].update(ms_b4=ms, library_ms_b4=lib_ms)
            del x, y, y_plain

    # --- DC offset at B_MAIN's shortest chunk: ×20 noise on 500 µV plus a
    # slow drift; sosfilt K=5 from the steady state (a zero-seeded chunk
    # would miss the bound here) and rolldec K=11
    t = torch.arange(T, device=dev) / 200.0
    x = signal((B_MAIN * 20, T), 20, 5, dev) + 500 \
        + 100 * torch.sin(2 * np.pi * 0.05 * t)
    require(cuda_iir.launch_shape(B_MAIN * 20, T, 11)[0]
            == cuda_iir.MIN_CHUNK, "B=4 does not pick the shortest chunk")
    zi5 = torch.as_tensor(iir._sos_zi(bp5), dtype=torch.float32, device=dev)
    for what, got, want in (
            ("sosfilt K=5 steady-state init",
             cuda_iir.sosfilt(bp5, x, steady_state_init=True),
             iir._sos_scan(x, bp5.sos, zi5 * x[..., :1, None])),
            ("rolldec K=11", cuda_iir.sosfilt_rolldec(casc, x),
             iir._sos_scan(x, casc.sos).reshape(-1, T // 4, 4).mean(-1))):
        r = rel(got, want)
        require(r < 2e-4, f"DC offset, {what}: rel err {r}")
        print(f"[kernels] DC offset 500 µV + drift, {what} ({B_MAIN * 20}, "
              f"{T}), chunks of {cuda_iir.MIN_CHUNK}: rel {r:.2e} (bound "
              f"2e-4)")
    del x, got, want

    # --- #1 with zi: filtfilt (#1') of the spectrogram notch, 400-sample
    # lanes, held at B_MAIN and timed there and at B_TIME, beside the same
    # two passes on the block-Toeplitz route (z0 = the steady state).
    # Bound: both passes read and write the odd-extended lanes, against
    # their f32 operations (9 per biquad step)
    pad = 3 * max(len(notch.a), len(notch.b))          # scipy's default
    zi = torch.as_tensor(iir._sos_zi(notch), dtype=torch.float32, device=dev)

    def two_pass_filtfilt(xs, block):
        ext = torch.cat([2 * xs[..., :1] - xs[..., 1:pad + 1].flip(-1), xs,
                         2 * xs[..., -1:] - xs[..., -pad - 1:-1].flip(-1)],
                        -1)
        for _ in range(2):
            if block:
                ext = iir._cascade_block_matmul(
                    ext, notch.sos, 128, z0=zi.reshape(-1) * ext[..., :1])
            else:
                ext = iir._sos_scan(ext, notch.sos, zi * ext[..., :1, None])
            ext = ext.flip(-1)
        return ext[..., pad:pad + xs.shape[-1]]

    for lanes in (B_MAIN * 300, B_TIME * 300):
        xs = signal((lanes, 400), 5, 2, dev)
        got = cuda_iir.filtfilt(notch, xs)
        n_plain = cuda_iir.sosfilt.launches
        t0 = time.perf_counter()
        want = two_pass_filtfilt(xs, block=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(cuda_iir.sosfilt.launches == n_plain, "plain filtfilt launched")
        r = rel(got, want)
        require(r < 1e-3, f"filtfilt (zi mode) rel err {r}")
        ms = cuda_ms(lambda: cuda_iir.filtfilt(notch, xs), 10)
        lib_ms = cuda_ms(lambda: two_pass_filtfilt(xs, block=True), 5)
        t_ext = 400 + 2 * pad
        b, b_by = bound_ms(2 * 2 * lanes * t_ext * 4,
                           2 * 9 * len(notch.sos) * lanes * t_ext)
        print(f"[kernels] filtfilt notch (sosfilt zi mode) ({lanes}, 400): "
              f"rel {r:.2e}, {ms:.4f} ms (two sosfilt launches; "
              f"block-matmul route {lib_ms:.4f} ms; plain two-pass scan "
              f"{plain_ms:.1f} ms, host clock), bound {b:.5f} ms by {b_by} "
              f"[{card}]")
        key = "b4" if lanes == B_MAIN * 300 else "b256"
        rec["iir_sosfilt"].update({f"filtfilt_ms_{key}": ms,
                                   f"filtfilt_bound_ms_{key}": b,
                                   f"filtfilt_library_ms_{key}": lib_ms})
    del xs, got, want

    # --- #3 fused spec block: block 1 (max) and block 2 (avg), float32
    # (the 3xTF32 kernel) and bf16 (the bf16 tensor-core kernel's fused-only
    # launch, the bf16 program's blocks 1-2 where autograd records), at the
    # serving size; bf16 also at B_MAIN (kept beside the record as *_b4)
    for dt, name in ((torch.float32, "specblock_convpool"),
                     (torch.bfloat16, "specblock_convpool_bf16")):
        rec[name] = sum_cases([
            specblock_case(card, dev, "block1", B_TIME, 400, 300, 3, 16,
                           "max", dt, 3, wscale=0.2),
            specblock_case(card, dev, "block2", B_TIME, 200, 150, 16, 32,
                           "avg", dt, 3, wscale=0.2)])
        torch.cuda.empty_cache()
    b4 = sum_cases([
        specblock_case(card, dev, "block1", B_MAIN, 400, 300, 3, 16, "max",
                       torch.bfloat16, 20, wscale=0.2, graph=True),
        specblock_case(card, dev, "block2", B_MAIN, 200, 150, 16, 32, "avg",
                       torch.bfloat16, 20, wscale=0.2, graph=True)])
    rec["specblock_convpool_bf16"].update(
        ms_b4=b4["ms"], bound_ms_b4=b4["bound_ms"],
        library_ms_b4=b4["library_ms"])
    # the whole bf16 block (the bf16 program's blocks 1 and 2 in serving:
    # #3 with BatchNorm, skip and add in its epilogue), x as the program
    # passes it, at the serving size
    rec["specblock_convpool_whole_bf16"] = sum_cases([
        whole_block_case(card, dev, "block1", B_TIME, 400, 300, 3, 16, "max",
                         3),
        whole_block_case(card, dev, "block2", B_TIME, 200, 150, 16, 32, "avg",
                         3)])
    torch.cuda.empty_cache()
    # the 200x150 preset's only fused block (kept as *_preset, *_preset_b4)
    h, w = config.SPEC_RES_PRESET.image_size
    for batch, reps, graph, key in ((B_TIME, 3, False, "preset"),
                                    (B_MAIN, 20, True, "preset_b4")):
        c = sum_cases([specblock_case(
            card, dev, "preset block1", batch, h, w, 3, 16, "max",
            torch.bfloat16, reps, wscale=0.2, graph=graph)])
        rec["specblock_convpool_bf16"].update(
            {f"ms_{key}": c["ms"], f"bound_ms_{key}": c["bound_ms"],
             f"library_ms_{key}": c["library_ms"]})

    # --- the wide block (Cout 64/128/256; three launches of one
    # tensor-core conv, 3xTF32 in f32, bf16 in bf16) on the planes of a
    # 64x48 input (blocks 3 and 4) and Cout 256 on 8x6, each width kept in
    # *_by_width; then on a 100x76 plane (kept as *_large).  Timed as one
    # CUDA graph (and eagerly, ms_eager): the device work is below the
    # eager wrapper's host time at the small planes
    for dt, name in ((torch.float32, "specblock_convpool_wide"),
                     (torch.bfloat16, "specblock_convpool_wide_bf16")):
        graph, reps = True, 20
        cases = [
            specblock_case(card, dev, "block3 of 64x48", B_TIME, 16, 12, 32,
                           64, "max", dt, reps, graph=graph),
            specblock_case(card, dev, "block4 of 64x48", B_TIME, 8, 6, 64,
                           128, "avg", dt, reps, graph=graph),
            specblock_case(card, dev, "Cout 256 on 8x6", B_TIME, 8, 6, 128,
                           256, "max", dt, reps, graph=graph)]
        rec[name] = sum_cases(cases)
        large = sum_cases([specblock_case(card, dev, "100x76 plane", B_TIME,
                                          100, 76, 32, 64, "max", dt, 2,
                                          graph=graph)])
        rec[name].update(ms_large=large["ms"], bound_ms_large=large["bound_ms"],
                         library_ms_large=large["library_ms"],
                         ms_eager_large=large["ms_eager"])
        widths = [c[1] for c in WIDE_SHAPES]
        rec[name].update(
            ms_by_width=dict(zip(widths, (c["ms"] for c in cases))),
            library_ms_by_width=dict(zip(widths, (c["library_ms"]
                                                  for c in cases))))
        torch.cuda.empty_cache()
    return rec


def _counters():
    """Every kernel's launch counter, by the kernels line's names."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, cuda_specblock)
    fused = cuda_specblock.fused_specblock_convpool

    def reset():
        cuda_iir.sosfilt.launches = cuda_iir.sosfilt_rolldec.launches = 0
        cuda_iir.sosfilt.given_launches = 0
        fused.kernel_launches.update(dict.fromkeys(fused.kernel_launches, 0))

    def read():
        return {"iir_sosfilt": cuda_iir.sosfilt.launches,
                "iir_sosfilt_given": cuda_iir.sosfilt.given_launches,
                "iir_sosfilt_rolldec": cuda_iir.sosfilt_rolldec.launches,
                **fused.kernel_launches}
    return reset, read


def _tag(sig) -> str:
    """The print prefix of a serving path: the main path (400x300) or
    path A (the 200x150 preset, phase 7)."""
    return "[main]" if sig is None else (
        f"[routes] A: preset {sig.image_size[0]}x{sig.image_size[1]},")


def phase_main(card: str, sig=None, fused_blocks: int = 2) -> dict:
    """The serving entry at B_MAIN on cuda with ``sig`` (None: the 400x300
    main path; the 200x150 preset for path A), both routes, float32 then
    the bf16 program; launch counts set to 0 just before each program's
    run and read just after, held to one forward a route: ``sosfilt``
    once (the NaN route's first bandpass), ``rolldec`` twice (one a
    route) and the program's fused block ``fused_blocks`` times a
    forward.  The NaN route carries a NaN run in one EEG channel of one
    window, a lone NaN pixel and an all-NaN spectrogram row.  Log-probs
    against the CPU run, bf16 probabilities against the float32 program's.
    Returns the launches by kernel name, each kernel's from the program
    that serves it (the IIR kernels' from the float32 program)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    reset, read = _counters()
    bf16 = torch.bfloat16
    tag = _tag(sig)

    def runs(dtype, device):
        out = {}
        for route in ("nan", "finite"):
            fwd, (eeg, spec) = entry(device=device, batch=B_MAIN,
                                     assume_finite=route == "finite",
                                     serving_dtype=dtype, signal=sig)
            if route == "nan":
                eeg[1, 5, 2000:2300] = float("nan")  # one channel, one window
                spec[0, 37, 121] = float("nan")      # a lone pixel
                spec[1, 200, :] = float("nan")       # an all-NaN row
            out[route] = (fwd, eeg, spec)
        return out

    outs, launches = {}, {}
    for dtype, kernels in ((None, ("iir_sosfilt", "iir_sosfilt_rolldec",
                                   "specblock_convpool")),
                           (bf16, ("specblock_convpool_bf16",
                                   "specblock_convpool_whole_bf16"))):
        prog = "float32" if dtype is None else "bf16"
        cuda_runs = runs(dtype, "cuda")
        reset()
        outs[prog] = {route: fwd(eeg, spec)
                      for route, (fwd, eeg, spec) in cuda_runs.items()}
        torch.cuda.synchronize()
        counts = read()
        print(f"{tag} launches, {prog} program (B={B_MAIN}, both routes): "
              f"{counts}")
        want = {"iir_sosfilt": 1, "iir_sosfilt_rolldec": 2,
                kernels[-1]: 2 * fused_blocks}
        require(all(counts[k] == n for k, n in want.items()),
                f"{tag} {prog} program: launches {counts}, expected {want}")
        launches.update({k: counts[k] for k in kernels})
        del cuda_runs

        # the same forward on the CPU: plain PyTorch versions throughout.
        # float32 bound: sums in other orders (cuDNN vs CPU convolutions;
        # the kernels vs the sequential scan) through a random-weight
        # network — 1e-3 on log-probs, as tests/test_torch_slice.py.  bf16:
        # the two sides round in other places, so probabilities within
        # BF16_PROB_ATOL
        for route, (cfwd, ceeg, cspec) in runs(dtype, "cpu").items():
            want = cfwd(ceeg, cspec)
            got = outs[prog][route].cpu()
            require(got.shape == (B_MAIN, 6), f"{route}: shape {got.shape}")
            require(bool(torch.isfinite(got).all()), f"{route}: non-finite")
            if dtype is None:
                err, bound = float((got - want).abs().max()), LOGP_ATOL
                what = "log-probs"
            else:
                err = float((got.exp() - want.exp()).abs().max())
                bound, what = BF16_PROB_ATOL, "probabilities"
            require(err < bound, f"{tag} {prog} {route} route: GPU vs CPU "
                    f"{what} {err}")
            print(f"{tag} {prog} program, {route} route: log-probs "
                  f"{tuple(got.shape)} finite; GPU vs CPU {what} max abs "
                  f"{err:.2e} (bound {bound})")
    for route in ("nan", "finite"):
        err = float((outs["bf16"][route].exp()
                     - outs["float32"][route].exp()).abs().max())
        require(err < BF16_PROB_ATOL, f"{tag} bf16 vs float32 program, "
                f"{route} route: probabilities {err}")
        print(f"{tag} bf16 vs float32 program, {route} route: probabilities "
              f"max abs {err:.2e} (bound {BF16_PROB_ATOL}) [{card}]")
    return launches


def phase_wide(card: str, dev) -> dict:
    """The fused block at Cout 64/128/256 inside SpectrogramCNN: fused
    blocks 3 and 4 on a 64x48 input (planes 16x12, 8x6; block 5's 4x3 is
    odd and stays unfused, as in the JAX package) and 5 on 64x64 (4x4),
    float32 and bf16, against the unfused model in the same type: float32
    log-probs within LOGP_ATOL, bf16 probabilities within BF16_PROB_ATOL.
    The wide kernel's launches are read around the fused models' run."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        SpectrogramCNN, seeded_state_dict)
    reset, read = _counters()
    cases = []
    for dtype in (None, torch.bfloat16):
        for fb, hw in ((3, (64, 48)), (4, (64, 48)), (5, (64, 64))):
            fused = SpectrogramCNN(fused_blocks=fb, dtype=dtype)
            fused.load_state_dict(seeded_state_dict(fused, 4))
            plain = SpectrogramCNN(dtype=dtype)
            plain.load_state_dict(fused.state_dict())
            x = signal((B_MAIN, 3) + hw, 1.0, 7, dev)
            cases.append((dtype, fb, hw, fused.to(dev).eval(),
                          plain.to(dev).eval(), x))
    reset()
    with torch.no_grad():
        got = [fused(x) for _, _, _, fused, _, x in cases]
    torch.cuda.synchronize()
    counts = read()
    names = ("specblock_convpool_wide", "specblock_convpool_wide_bf16")
    print(f"[wide] launches in the fused models' run: "
          f"{ {k: counts[k] for k in names} }")
    for name in names:
        require(counts[name] > 0, f"kernel {name} was not launched")
    for (dtype, fb, hw, _, plain, x), y in zip(cases, got):
        with torch.no_grad():
            want = plain(x)
        require(bool(torch.isfinite(y).all()), "wide: non-finite")
        if dtype is None:
            err, bound, what = max_abs(y, want), LOGP_ATOL, "log-probs"
        else:
            err = max_abs(y.exp(), want.exp())
            bound, what = BF16_PROB_ATOL, "probabilities"
        require(err < bound, f"fused_blocks={fb} {hw} {dtype}: {err}")
        print(f"[wide] SpectrogramCNN(fused_blocks={fb}, dtype={dtype}) on "
              f"{(B_MAIN, 3) + hw} vs unfused: {what} max abs {err:.2e} "
              f"(bound {bound}) [{card}]")
    return {k: counts[k] for k in names}


def phase_timing(card: str, sig=None, beside=None) -> dict:
    """Serving forward with ``sig`` (None: the 400x300 main path; the
    200x150 preset for path A) at B_TIME (throughput) and B_MAIN
    (on-demand latency), both routes, float32 and bf16, eager and captured
    as one CUDA graph (held equal to eager on two inputs; a failed capture
    raises), with the kernels launched per forward on the finite route
    (profiler); ``beside``: an earlier call's times, printed alongside.
    Returns {(program, route, batch): (eager ms, graph ms)}."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        capture_forward, entry)
    tag = "[timing]" if sig is None else _tag(sig)
    times = {}
    for route in ("finite", "nan"):
        for dtype in (None, torch.bfloat16):
            prog = "float32" if dtype is None else "bf16"
            for batch, reps in ((B_TIME, 10), (B_MAIN, 50)):
                fwd, (eeg, spec) = entry(device="cuda", batch=batch,
                                         assume_finite=route == "finite",
                                         serving_dtype=dtype, signal=sig)
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: fwd(eeg, spec), reps, warmup=2)
                peak = peak_gib()
                graph = capture_forward(fwd, (eeg, spec))
                diff = max(max_abs(graph(e, s), fwd(e, s)) for e, s in (
                    (eeg, spec), (eeg * 0.5 + 1.0, spec.flip(0))))
                require(diff <= GRAPH_ATOL, f"{tag} captured vs eager {prog} "
                        f"{route} B={batch}: {diff}")
                gms = cuda_ms(lambda: graph(eeg, spec), reps, warmup=2)
                count = ""
                if route == "finite":
                    pe = profiling.profile_kernels(lambda: fwd(eeg, spec),
                                                   reps=2, warmup=0)
                    pg = profiling.profile_kernels(lambda: graph(eeg, spec),
                                                   reps=2, warmup=0)
                    count = (f"; kernels a forward: eager {pe.kernels:.0f} "
                             f"(+{pe.copies:.0f} copies), graph "
                             f"{pg.kernels:.0f} (+{pg.copies:.0f})")
                if beside is not None:
                    b_ms, b_gms = beside[prog, route, batch]
                    count += (f"; the 400x300 program: eager {b_ms:.3f} ms = "
                              f"{batch / b_ms * 1e3:.1f} windows/s, captured "
                              f"{b_gms:.3f} ms = {batch / b_gms * 1e3:.1f} "
                              f"windows/s")
                print(f"{tag} serving forward, {prog} program, {route} "
                      f"route, B={batch}: eager {ms:.3f} ms/batch = "
                      f"{batch / ms * 1e3:.1f} windows/s (peak {peak:.2f} "
                      f"GiB); captured {gms:.3f} ms/batch = "
                      f"{batch / gms * 1e3:.1f} windows/s; captured vs eager "
                      f"max abs {diff:.1e} (bound {GRAPH_ATOL}){count} "
                      f"[{card}]")
                times[prog, route, batch] = ms, gms
                del fwd, graph, eeg, spec
                torch.cuda.empty_cache()
    return times


def phase_routes(card: str, dev) -> dict:
    """Paths B and C of phase 7 (path A, the 200x150 preset, runs through
    phase_main and phase_timing); launch counts set to 0 just before each
    call and read just after.  Returns each path's launches by kernel
    name, summed over its calls: {"B": {...}, "C": {...}}.

    B: ``hms_spectrogram_preprocess(linear_ops=False)``, the op-by-op
    reference that holds the dense route (no serving program takes it), on
    raw (B_MAIN, 400, 300) planes with NaNs, both resize modes, float32
    and bf16: two IIR launches a call; against the CPU within 1e-5
    (float32; the tests' bound against the JAX chain) or 2e-2 (bf16, the
    JAX package's bf16 bound on the [0, 1] output), and, float32, against
    the dense route within 1e-5 (the JAX package's pin of the two routes);
    then what the reference costs beside the dense route at B_TIME,
    400x300.
    C: ``eeg_transform`` on (B_MAIN, 10000, C) windows (C = 19, default
    chain; C = 20, magic-8 and mu-law) with a NaN run: one IIR launch a
    call, rel 1e-4 against the CPU (the JAX package's bound); then timed
    at B_TIME, beside its IIR launch alone and that launch's bound."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, eeg_transform, hms_spectrogram_preprocess, iir)
    reset, read = _counters()
    bf16 = torch.bfloat16
    preset = C.SPEC_RES_PRESET.image_size
    paths = {"B": {}, "C": {}}

    def count(path, counts):
        for k, n in counts.items():
            paths[path][k] = paths[path].get(k, 0) + n

    # --- B: the op-by-op reference chain ----------------------------------
    spec = signal((B_MAIN, 400, 300), 5, 11, dev)
    spec[0, 37, 121] = float("nan")
    spec[1, 200, :] = float("nan")
    cspec = spec.cpu()
    for mode, size in (("pad", (400, 300)), ("resample", preset)):
        sig = C.SignalConfig(image_size=size, resize_mode=mode)
        dense = hms_spectrogram_preprocess(spec, signal=sig)
        for dtype in (None, bf16):
            reset()
            got = hms_spectrogram_preprocess(spec, signal=sig,
                                             serving_dtype=dtype,
                                             linear_ops=False)
            torch.cuda.synchronize()
            counts = read()
            count("B", counts)
            require(counts["iir_sosfilt"] == 2, f"op-by-op {mode}: "
                    f"{counts['iir_sosfilt']} IIR launches, expected 2")
            want = hms_spectrogram_preprocess(cspec, signal=sig,
                                              serving_dtype=dtype,
                                              linear_ops=False)
            require(got.dtype == want.dtype and got.shape == want.shape
                    == (B_MAIN, 3) + size, f"op-by-op {mode}: {got.shape}")
            err = max_abs(got.float().cpu(), want.float())
            bound = 1e-5 if dtype is None else 2e-2
            require(err < bound, f"op-by-op {mode} {dtype}: GPU vs CPU {err}")
            line = (f"[routes] B: op-by-op reference chain, {mode} -> {size}, "
                    f"{'float32' if dtype is None else 'bf16'}: "
                    f"{counts['iir_sosfilt']} iir_sosfilt launches; GPU vs "
                    f"CPU max abs {err:.2e} (bound {bound})")
            if dtype is None:
                e_dense = max_abs(got, dense)
                require(e_dense < 1e-5, f"op-by-op {mode} vs dense {e_dense}")
                line += f"; vs the dense route max abs {e_dense:.2e} (1e-5)"
            print(line)
    del spec, cspec, dense, got, want
    x = signal((B_TIME, 400, 300), 5, 12, dev)
    op_ms = cuda_ms(lambda: hms_spectrogram_preprocess(x, linear_ops=False),
                    5)
    dense_ms = cuda_ms(lambda: hms_spectrogram_preprocess(x), 5)
    print(f"[routes] B: spectrogram chain ({B_TIME}, 400, 300), float32: the "
          f"op-by-op reference {op_ms:.3f} ms, the dense route (served) "
          f"{dense_ms:.3f} ms [{card}]")
    del x
    torch.cuda.empty_cache()

    # --- C: eeg_transform -------------------------------------------------
    for cfg, n_cols in ((C.EEGTransformConfig(), 19),
                        (C.EEGTransformConfig(apply_chris_magic_ch8=True,
                                              apply_mu_law_encoding=True),
                         20)):
        x = signal((B_MAIN, 10_000, n_cols), 300, 13, dev)
        x[0, 100:140, 3] = float("nan")
        reset()
        got = eeg_transform(x, cfg)
        torch.cuda.synchronize()
        counts = read()
        count("C", counts)
        require(counts["iir_sosfilt"] == 1, f"eeg_transform: "
                f"{counts['iir_sosfilt']} IIR launches, expected 1")
        want = eeg_transform(x.cpu(), cfg)
        require(got.shape == want.shape, f"eeg_transform: {got.shape}")
        r = rel(got.cpu(), want)
        require(r < 1e-4, f"eeg_transform ({n_cols} columns): rel {r}")
        print(f"[routes] C: eeg_transform {tuple(x.shape)} -> "
              f"{tuple(got.shape)}, magic-8 {cfg.apply_chris_magic_ch8}: 1 "
              f"iir_sosfilt launch; GPU vs CPU rel {r:.2e} (bound 1e-4)")
    x = signal((B_TIME, 10_000, 19), 300, 14, dev)
    lowpass = iir.butter_lowpass(20.0, 200.0, 4)
    lanes = x.movedim(-2, -1).contiguous()
    ms = cuda_ms(lambda: eeg_transform(x), 10)
    k_ms = cuda_ms(lambda: cuda_iir.sosfilt(lowpass, lanes), 10)
    b, b_by = bound_ms(2 * lanes.numel() * 4,
                       9 * len(lowpass.sos) * lanes.numel())
    print(f"[routes] C: eeg_transform {tuple(x.shape)}: {ms:.3f} ms; its "
          f"sosfilt K={len(lowpass.sos)} launch on {B_TIME * 19} lanes alone "
          f"{k_ms:.4f} ms, bound {b:.4f} ms by {b_by} [{card}]")
    del x, lanes
    torch.cuda.empty_cache()
    print(f"[routes] launches of paths B and C: {paths}")
    return paths


def phase_stem(card: str) -> None:
    """The EEGNet stem reassociated (as served) against canonical on the
    float32 finite route: log-probs within LOGP_ATOL, the EEG branch's
    time alone (CUDA events) and cuDNN's FFT-convolution share of the
    forward's device time (profiler), at B_TIME and B_MAIN; then the FFT
    convolution's time in each branch alone, to say which layer runs it."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        make_forward, seeded)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        preprocess_multimodal)
    for batch in (B_TIME, B_MAIN):
        model, eeg, spec = seeded("cuda", batch)
        fwd = make_forward(model, assume_finite=True)
        with torch.inference_mode():
            eeg_in, spec_in = preprocess_multimodal(eeg, spec,
                                                    assume_finite=True)
            for name, branch, x in (("EEG", model.eeg_model, eeg_in),
                                    ("spectrogram", model.spectrogram_model,
                                     spec_in)):
                prof = profiling.profile_kernels(lambda: branch(x), reps=3)
                print(f"[stem] {name} branch alone, B={batch}: device busy "
                      f"{prof.busy_ms:.3f} ms, cuDNN FFT conv "
                      f"{profiling.fft_conv_ms(prof):.3f} ms [{card}]")
        outs = {}
        for stem in ("reassociated", "canonical"):
            model.eeg_model.fused_inference = stem == "reassociated"
            outs[stem] = fwd(eeg, spec)
            with torch.inference_mode():
                eeg_ms = cuda_ms(lambda: model.eeg_model(eeg_in), 10, warmup=2)
            prof = profiling.profile_kernels(lambda: fwd(eeg, spec), reps=3)
            fft = profiling.fft_conv_ms(prof)
            top = sorted(((ms, n) for n, ms in prof.kernel_ms.items()
                          if profiling.FFT_CONV.search(n)), reverse=True)[:4]
            print(f"[stem] {stem} stem, B={batch}: EEG branch {eeg_ms:.3f} "
                  f"ms; forward device busy {prof.busy_ms:.3f} ms of "
                  f"{prof.wall_ms:.3f} ms wall (profiler on), cuDNN FFT conv "
                  f"{fft:.3f} ms = {100 * fft / prof.busy_ms:.1f}% of busy; "
                  f"top FFT kernels {[(n[:40], round(ms, 3)) for ms, n in top]}"
                  f" [{card}]")
        err = max_abs(outs["reassociated"], outs["canonical"])
        require(err < LOGP_ATOL, f"stems differ by {err} at B={batch}")
        print(f"[stem] reassociated vs canonical, B={batch}: log-probs max "
              f"abs {err:.2e} (bound {LOGP_ATOL})")
        del model, fwd, eeg, spec, eeg_in, spec_in
        torch.cuda.empty_cache()


def _held(what: str, got, want, kink: bool = False) -> None:
    """Hold an attribution against its reference: max |diff| over the
    reference's max |value| and ||diff|| / ||ref|| below XAI_REL
    (XAI_KINK_REL and XAI_KINK_NORM where ReLU and max-pool ties may
    flip)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    require(got.shape == want.shape, f"{what}: shape {got.shape}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    scale = float(want.abs().max())
    require(scale > 0, f"{what}: the reference is all zero")
    e_max, e_norm = rel(got, want), norm_rel(got, want)
    b_max, b_norm = (XAI_KINK_REL, XAI_KINK_NORM) if kink else (XAI_REL,
                                                                XAI_REL)
    print(f"[xai] {what} {tuple(got.shape)}: max|diff|/max|ref| {e_max:.2e} "
          f"(bound {b_max}), ||diff||/||ref|| {e_norm:.2e} (bound "
          f"{b_norm}); max|ref| {scale:.3e}")
    require(e_max < b_max and e_norm < b_norm,
            f"{what}: {e_max:.3e} / {e_norm:.3e}")


def phase_xai(card: str, dev, serving_ms: float) -> dict:
    """Attribution through the fused serving model: correctness on the
    card against the CPU and the unfused model, the fused block's launches
    and backward calls read around that run, then times at B_TIME."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import xai
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        explain_entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        SpectrogramCNN)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    import torch.nn.functional as F
    fused = cuda_specblock.fused_specblock_convpool

    def unfused_twin(m):
        twin = copy.deepcopy(m)
        twin.spectrogram_model = SpectrogramCNN(fused_blocks=0)
        twin.spectrogram_model.load_state_dict(
            m.spectrogram_model.state_dict())
        return twin.to(dev).eval().requires_grad_(False)

    # --- correctness, B_MAIN (B=2 for the spectrogram sweeps) ------------
    model, (eeg, spec) = explain_entry(device="cuda", batch=B_MAIN)
    cpu = copy.deepcopy(model).cpu()
    ceeg, cspec = eeg.cpu(), spec.cpu()
    unfused = unfused_twin(model)
    with torch.no_grad():        # targets from the CPU, given to both sides
        t_mm = cpu(ceeg, cspec).argmax(-1)
        t_eeg = cpu.forward_eeg(ceeg).argmax(-1)
        t_spec = cpu.forward_spectrogram(cspec).argmax(-1)
    fused.launches = fused.backward_calls = 0
    ge, gs = xai.multimodal_saliency(model, eeg, spec, target=t_mm.to(dev))
    ue, us = xai.multimodal_saliency(unfused, eeg, spec, target=t_mm.to(dev))
    ce, cs = xai.multimodal_saliency(cpu, ceeg, cspec, target=t_mm)
    _held("multimodal saliency, EEG, card vs CPU", ge, ce)
    _held("multimodal saliency, spectrogram, card vs CPU", gs, cs, kink=True)
    _held("multimodal saliency, EEG, fused vs unfused (card)", ge, ue)
    _held("multimodal saliency, spectrogram, fused vs unfused (card)", gs, us,
          kink=True)
    for name, x, cx, tgt, size in (
            ("eeg_model", eeg, ceeg, t_eeg, (1, 3000)),
            ("spectrogram_model", spec, cspec, t_spec, (400, 300))):
        got = xai.grad_cam(getattr(model, name), x, target=tgt.to(dev),
                           upsample_to=size)
        require(float(got.min()) >= 0 and float(got.max()) <= 1 + 1e-6,
                f"grad_cam {name}: not in [0, 1]")
        _held(f"grad_cam {name}, card vs CPU", got,
              xai.grad_cam(getattr(cpu, name), cx, target=tgt,
                           upsample_to=size))
    _held("integrated_gradients, spectrogram, steps 8 chunk 4, card vs CPU",
          xai.integrated_gradients(model.forward_spectrogram, spec[:2],
                                   target=t_spec[:2].to(dev), steps=8,
                                   chunk=4),
          xai.integrated_gradients(cpu.forward_spectrogram, cspec[:2],
                                   target=t_spec[:2], steps=8, chunk=4),
          kink=True)
    for branch, x, cx, tgt in (("eeg", eeg, ceeg, t_eeg),
                               ("spectrogram", spec[:2], cspec[:2],
                                t_spec[:2])):
        fwd, cfwd = (getattr(m, f"forward_{branch}") for m in (model, cpu))
        _held(f"expected_gradients, {branch}, nsamples 8 chunk 4, card vs CPU "
              f"(same draws)",
              xai.expected_gradients(fwd, x, x, torch.Generator().manual_seed(0),
                                     tgt.to(dev), nsamples=8, chunk=4),
              xai.expected_gradients(cfwd, cx, cx,
                                     torch.Generator().manual_seed(0), tgt,
                                     nsamples=8, chunk=4),
              kink=branch == "spectrogram")
    torch.cuda.synchronize()
    counts = {"launches": fused.launches, "backward_calls": fused.backward_calls}
    print(f"[xai] fused_specblock_convpool during the attribution run: {counts}")
    require(counts["launches"] > 0, "the fused block was not launched under "
            "attribution")
    require(counts["backward_calls"] > 0, "the fused block's VJP never ran")
    del model, cpu, unfused, eeg, spec, ceeg, cspec
    torch.cuda.empty_cache()

    # --- times, B_TIME ---------------------------------------------------
    model, (e256, s256) = explain_entry(device="cuda", batch=B_TIME)
    x = signal((B_TIME, 1, 37, 3000), 1.0, 0, dev)
    eeg_m = model.eeg_model

    def infer():
        with torch.no_grad():
            return eeg_m(x)
    t_inf = cuda_ms(infer, 10, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    t_cam = cuda_ms(lambda: xai.grad_cam(eeg_m, x), 10, warmup=2)
    print(f"[xai] gradcam_cost_vs_inference (EEGNetAttentionRegularized, "
          f"B={B_TIME}): {t_cam / t_inf:.4f}x (grad_cam {t_cam:.3f} ms, "
          f"inference {t_inf:.3f} ms); peak {peak_gib():.2f} GiB [{card}]")

    steps, nsamples = 50, 32           # bench.py:737-759's sweep and chunks
    chunk_ig = max(1, 2048 // B_TIME)
    while steps % chunk_ig:
        chunk_ig -= 1
    chunk_eg = max(1, 1024 // B_TIME)
    while nsamples % chunk_eg:
        chunk_eg -= 1
    fwd = model.forward_eeg
    with torch.no_grad():
        tgt = fwd(x).argmax(-1)
    torch.cuda.reset_peak_memory_stats()
    t_ig = cuda_ms(lambda: xai.integrated_gradients(
        fwd, x, target=tgt, steps=steps, chunk=chunk_ig), 2)
    print(f"[xai] IG, EEG branch, B={B_TIME}, steps {steps}, chunk "
          f"{chunk_ig}: {t_ig:.3f} ms, {B_TIME / t_ig * 1e3:.1f} maps/s; peak "
          f"{peak_gib():.2f} GiB [{card}]")
    gen = torch.Generator().manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    t_shap = cuda_ms(lambda: xai.gradient_shap_values(
        fwd, x, x[:16], gen, nsamples=nsamples, chunk=chunk_eg), 1)
    print(f"[xai] gradient SHAP, EEG branch, B={B_TIME}, 6 classes x "
          f"nsamples {nsamples}, chunk {chunk_eg}: {t_shap:.3f} ms, "
          f"{B_TIME / t_shap * 1e3:.2f} maps/s; peak {peak_gib():.2f} GiB "
          f"[{card}]")
    del x, tgt

    unfused = unfused_twin(model)
    times = {}
    for name, m in (("fused", model), ("unfused", unfused)):
        torch.cuda.reset_peak_memory_stats()
        times[name] = cuda_ms(lambda: xai.multimodal_saliency(m, e256, s256),
                              3)
        print(f"[xai] multimodal saliency, {name} model, B={B_TIME}: "
              f"{times[name]:.3f} ms ({times[name] / serving_ms:.3f}x the "
              f"serving forward's {serving_ms:.3f} ms); peak "
              f"{peak_gib():.2f} GiB [{card}]")
    del unfused
    xs32, fwd, chunk = s256[:32], model.forward_spectrogram, 10
    with torch.no_grad():
        tgt = fwd(xs32).argmax(-1)
    torch.cuda.reset_peak_memory_stats()
    t_igs = cuda_ms(lambda: xai.integrated_gradients(
        fwd, xs32, target=tgt, steps=steps, chunk=chunk), 1)
    print(f"[xai] IG, fused spectrogram branch, B=32, steps {steps}, chunk "
          f"{chunk}: {t_igs:.3f} ms, {32 / t_igs * 1e3:.2f} maps/s; peak "
          f"{peak_gib():.2f} GiB [{card}]")
    del model, e256, s256, xs32, tgt
    torch.cuda.empty_cache()

    # --- the fused block's VJP (#3') at B_TIME: backward = fused forward +
    # backward minus fused forward; library = the backward alone of the
    # cuDNN chain's kept graph; bound = the recomputed forward's and the
    # data-gradient's f32 operations against x, g and dx moved once
    vjp = dict(ms=0.0, library_ms=0.0, t_bytes=0.0, t_ops=0.0)
    for name, cin, co, h, w, pool in (("block1", 3, 16, 400, 300, "max"),
                                      ("block2", 16, 32, 200, 150, "avg")):
        rng = np.random.default_rng(4)
        mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh),
                                         dtype=torch.float32, device=dev)
        ks = [mk(3, 3, ci, co) * 0.2 for ci in (cin, co, co)]
        bs = [mk(co) * 0.1 for _ in range(3)]
        x = mk(B_TIME, h, w, cin)
        g = mk(B_TIME, h // 2, w // 2, co)
        xr = x.clone().requires_grad_()
        t_f = cuda_ms(lambda: fused(x, ks, bs, pool=pool, dtype=torch.float32),
                      5)
        t_fb = cuda_ms(lambda: torch.autograd.grad(
            fused(xr, ks, bs, pool=pool, dtype=torch.float32), xr, g), 5)
        xn = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
        hh = xn
        for k, b in zip(ks, bs):
            hh = F.relu(F.conv2d(hh, k.permute(3, 2, 0, 1), b, padding=1))
        out = F.max_pool2d(hh, 2) if pool == "max" else F.avg_pool2d(hh, 2)
        gn = g.permute(0, 3, 1, 2)
        t_lib = cuda_ms(lambda: torch.autograd.grad(out, xn, gn,
                                                    retain_graph=True), 5)
        nbytes = (2 * x.numel() + g.numel()) * 4
        flops = 2 * 2 * 9 * (cin * co + 2 * co * co) * B_TIME * h * w
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"[xai] fused block VJP {name} (B={B_TIME}): fused fwd+bwd "
              f"{t_fb:.3f} ms - fwd {t_f:.3f} ms = {t_fb - t_f:.3f} ms; cuDNN "
              f"chain backward alone {t_lib:.3f} ms; bound {b_ms:.3f} ms by "
              f"{b_by} [{card}]")
        vjp["ms"] += t_fb - t_f
        vjp["library_ms"] += t_lib
        vjp["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        vjp["t_ops"] += flops / F32_FLOP_PER_S * 1e3
        del x, xr, xn, hh, out, g, gn
        torch.cuda.empty_cache()
    print(f"[xai] fused block VJP, blocks 1+2: {vjp['ms']:.3f} ms, cuDNN "
          f"backward {vjp['library_ms']:.3f} ms, bound "
          f"{max(vjp['t_bytes'], vjp['t_ops']):.3f} ms [{card}]")
    return counts


def _train_snapshot(state):
    """Bitwise copies of what the NaN sentinel must keep: the model's
    state_dict (BatchNorm buffers included) and the optimizer state."""
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.opt_state.items()})


def _same(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _train_timing(card: str, dtype, assume_finite: bool, reset, read,
                  top: bool) -> tuple:
    """``bench_train``'s measurement of the training program at B_TIME: 2
    warm-up steps, then TRAIN_STEPS steps between CUDA events; the IIR
    kernels' launches a step read around the timed steps; peak memory;
    the step's device busy share and, with ``top``, its top device ops
    (profiler over 2 steps).  Returns (ms/step, windows/s, peak GiB)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        train_entry)
    prog = "bf16" if dtype is not None else "float32"
    route = "finite" if assume_finite else "nan"
    torch.cuda.reset_peak_memory_stats()
    step, st, (eeg, spec, y) = train_entry(device="cuda", batch=B_TIME,
                                           dtype=dtype,
                                           assume_finite=assume_finite)
    box = [st]

    def one():
        box[0], m = step(box[0], eeg, spec, y)
        return m
    ms = cuda_ms(one, TRAIN_STEPS, warmup=2)
    reset()
    m = one()
    torch.cuda.synchronize()
    counts = read()
    require(not bool(m["nonfinite"]), f"train {prog} {route}: skipped step")
    peak = peak_gib()
    prof = profiling.profile_kernels(one, reps=2, warmup=0)
    # summed kernel time can exceed the wall when kernels overlap (cuDNN
    # runs some on its own streams): then no idle time is measurable
    idle = max(0.0, 1.0 - prof.busy_ms / prof.wall_ms)
    print(f"[train] {prog} program, {route} route, B={B_TIME}: "
          f"{ms:.3f} ms/step = {B_TIME / ms * 1e3:.1f} training windows/s "
          f"(CUDA events, {TRAIN_STEPS} steps after 2 warm-ups); peak "
          f"{peak:.2f} GiB; profiler: busy {prof.busy_ms:.3f} of "
          f"{prof.wall_ms:.3f} ms wall a step = idle {100 * idle:.1f} %, "
          f"{prof.kernels:.0f} kernels + {prof.copies:.0f} copies a step; "
          f"launches a step: iir_sosfilt_rolldec "
          f"{counts['iir_sosfilt_rolldec']}, iir_sosfilt "
          f"{counts['iir_sosfilt']}; loss {float(m['loss']):.4f} [{card}]")
    require(counts["iir_sosfilt_rolldec"] == 1
            and counts["iir_sosfilt"] == (0 if assume_finite else 1),
            f"train {prog} {route}: IIR launches a step {counts}")
    if top:
        ops = sorted(prof.kernel_ms.items(), key=lambda kv: -kv[1])[:8]
        print(f"[train] {prog} {route}: top device ops a step: "
              + "; ".join(f"{n[:100]} x{prof.kernel_calls[n]:.0f} {v:.3f} ms"
                          for n, v in ops))
    del step, st, box, eeg, spec, y
    torch.cuda.empty_cache()
    return ms, B_TIME / ms * 1e3, peak


def phase_train(card: str, dev) -> dict:
    """The training path (``entry.train_entry``, the JAX bench's ``--train``
    program, and ``entry.train_multimodal``, the JAX CLI's
    ``train-multimodal --demo`` loop) on the card:

    * one float32 step at B_MAIN, dropout off, finite route, against the
      same seeded weights on the CPU, both on the batch the card
      preprocessed (the IIR kernels are held in phase 3): loss within
      TRAIN_LOSS_REL, global gradient norm within TRAIN_NORM_REL, each
      gradient within TRAIN_GRAD_REL of its tensor's max |g| (plus 1e-6 of
      the largest |g| of the model: gradients that are zero in exact
      arithmetic, BatchNorm 1's affine and the attention key's bias, are
      rounding noise on both sides), the BatchNorm running statistics
      within TRAIN_BN_REL of each tensor's max; and all gradients, normwise
      against the CPU's float64 step, within TRAIN_F64_FACTOR times the CPU
      float32's distance;
    * the training path's launch counts: set to 0 just before one step of
      the entry (preprocessing included) on the finite route and one on the
      NaN route (the ``--demo`` data's route, with its NaNs), read just
      after: one ``rolldec`` a step and one ``sosfilt`` on the NaN route;
    * a NaN batch on the card: ``nonfinite`` set, parameters, optimizer
      state and BatchNorm buffers bitwise unchanged, the step advanced;
    * the loss falls over 10 steps on one batch, float32 and bf16;
    * ``train_multimodal`` for two epochs (24 rows, B=8, 80x60 planes, 600
      samples) writes best-kldiv, last and step_N; a run of one epoch
      resumed to two reaches bitwise the parameters of the uninterrupted
      run (cuDNN's deterministic algorithms on for this check);
    * the timing of ``_train_timing``: bf16 and float32 on the finite
      route, bf16 on the NaN route.

    Returns the training path's launches by kernel name."""

    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        preprocess_batch, train_entry, train_multimodal)
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        Dropout)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        steps as train_steps)
    reset, read = _counters()

    # --- card vs CPU, one float32 step on one preprocessed batch ---------
    c_step, c_st, c_raw = train_entry(device="cuda", batch=B_MAIN, dtype=None)
    _, h_st, _ = train_entry(device="cpu", batch=B_MAIN, dtype=None)
    for st in (c_st, h_st):
        for m in st.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    c_batch = preprocess_batch(*c_raw)
    h_batch = {k: v.cpu() for k, v in c_batch.items()}
    grads = {}
    for where, model, batch in (
            ("cuda", c_st.model, c_batch), ("cpu", h_st.model, h_batch),
            ("cpu64", h_st.model,
             {k: v.double() for k, v in h_batch.items()})):
        model = copy.deepcopy(model)
        if where == "cpu64":
            model = model.double()
        _, _, g = train_steps.loss_and_grads(model, batch, None,
                                             l2_lambda=TRAIN_L2)
        grads[where] = [t.detach().cpu().double() for t in g]
    flat64 = torch.cat([g.reshape(-1) for g in grads["cpu64"]])
    e64 = {w: float((torch.cat([g.reshape(-1) for g in grads[w]]) - flat64
                     ).norm() / flat64.norm()) for w in ("cuda", "cpu")}
    print(f"[train] gradients against the CPU in float64, normwise: card "
          f"{e64['cuda']:.2e}, CPU float32 {e64['cpu']:.2e} (bound "
          f"{TRAIN_F64_FACTOR}x the CPU's) [{card}]")
    require(e64["cuda"] < TRAIN_F64_FACTOR * e64["cpu"],
            "training step: the card is further from float64 than the CPU")
    inner = train_steps.make_train_step(l2_lambda=TRAIN_L2)
    c_st, c_m = inner(c_st, c_batch)
    h_st, h_m = inner(h_st, h_batch)
    e_loss = abs(float(c_m["loss"]) - float(h_m["loss"])) / abs(
        float(h_m["loss"]))
    e_norm = abs(float(c_m["grad_norm"]) - float(h_m["grad_norm"])) / float(
        h_m["grad_norm"])
    scale = max(float(g.abs().max()) for g in grads["cpu"])
    e_grad = max(float((g - w).abs().max())
                 / (float(w.abs().max()) + 1e-6 * scale / TRAIN_GRAD_REL)
                 for g, w in zip(grads["cuda"], grads["cpu"]))
    c_sd, h_sd = c_st.model.state_dict(), h_st.model.state_dict()
    e_bn = max(float((c_sd[k].cpu() - v).abs().max() / v.abs().max())
               for k, v in h_sd.items()
               if k.endswith(("running_mean", "running_var")))
    print(f"[train] float32 step, B={B_MAIN}, card vs CPU on one batch: loss "
          f"{float(c_m['loss']):.6f} rel {e_loss:.2e} (bound "
          f"{TRAIN_LOSS_REL}); grad norm {float(c_m['grad_norm']):.4f} rel "
          f"{e_norm:.2e} (bound {TRAIN_NORM_REL}); worst gradient "
          f"{e_grad:.2e} of its tensor's max (bound {TRAIN_GRAD_REL}); "
          f"BatchNorm statistics {e_bn:.2e} (bound {TRAIN_BN_REL}) [{card}]")
    require(e_loss < TRAIN_LOSS_REL and e_norm < TRAIN_NORM_REL
            and e_grad < TRAIN_GRAD_REL and e_bn < TRAIN_BN_REL,
            "training step: card vs CPU out of bounds")
    del h_st, h_batch, grads

    # --- the training path's launches: the entry's step, both routes -----
    n_step, n_st, n_raw = train_entry(device="cuda", batch=B_MAIN,
                                      assume_finite=False)
    require(bool(torch.isnan(n_raw[0]).any()), "NaN route: no NaN in input")
    reset()
    c_st, c_m = c_step(c_st, *c_raw)
    n_st, n_m = n_step(n_st, *n_raw)
    torch.cuda.synchronize()
    launches = read()
    print(f"[train] launches in the training path's run (the entry's step: "
          f"float32 finite route + bf16 NaN route, B={B_MAIN}): {launches}")
    require(launches["iir_sosfilt_rolldec"] == 2
            and launches["iir_sosfilt"] == 1,
            f"training path: IIR launches {launches}")
    require(not bool(c_m["nonfinite"]) and not bool(n_m["nonfinite"]),
            "training path: a step was skipped")

    # --- the NaN sentinel on the card -------------------------------------
    bad = c_raw[0].clone()
    bad[1, 7, 4000:4010] = float("nan")
    before, step_no = _train_snapshot(c_st), c_st.step
    c_st, b_m = c_step(c_st, bad, c_raw[1], c_raw[2])
    torch.cuda.synchronize()
    kept = _same(_train_snapshot(c_st), before)
    print(f"[train] NaN batch on the card: nonfinite "
          f"{bool(b_m['nonfinite'])}, loss {float(b_m['loss'])}, state "
          f"bitwise kept {kept}, step {step_no} -> {c_st.step}")
    require(bool(b_m["nonfinite"]) and kept and c_st.step == step_no + 1,
            "NaN sentinel on the card")
    del c_step, c_st, c_raw, n_step, n_st, n_raw

    # --- the loss falls over 10 steps, float32 and bf16 -------------------
    for dtype in (None, torch.bfloat16):
        step, st, raw = train_entry(device="cuda", batch=8, dtype=dtype)
        losses = []
        for _ in range(10):
            st, m = step(st, *raw)
            losses.append(float(m["loss"]))
        prog = "bf16" if dtype is not None else "float32"
        print(f"[train] {prog} program, B=8, 10 steps on one batch: losses "
              f"{[round(x, 4) for x in losses]}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{prog}: the loss did not fall")
        del step, st, raw
    torch.cuda.empty_cache()

    # --- train_multimodal: checkpoints and a bitwise resume ---------------
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a, best_a = train_multimodal(f"{tmp}/a", device="cuda", epochs=2)
            names = sorted(p.name
                           for p in Path(f"{tmp}/a/multimodal").iterdir())
            for want in ("best-kldiv", "last", "step_1", "step_2"):
                require(want in names, f"train_multimodal: no {want}")
            train_multimodal(f"{tmp}/b", device="cuda", epochs=1)
            b, best_b = train_multimodal(f"{tmp}/b", device="cuda", epochs=2,
                                         resume=True)
            last = [torch.load(f"{tmp}/{d}/multimodal/last/state.pt",
                               map_location="cpu", weights_only=True)
                    for d in ("a", "b")]
            same = (all(torch.equal(v, last[1]["model"][k])
                        for k, v in last[0]["model"].items())
                    and all(torch.equal(v, b.state.model.state_dict()[k])
                            for k, v in a.state.model.state_dict().items())
                    and a.history == b.history)
            print(f"[train] train_multimodal, 2 epochs: {names}; best kldiv "
                  f"{best_a:.4f}; resumed from step_1: best {best_b:.4f}, "
                  f"parameters and history bitwise equal {same} [{card}]")
            require(same and best_a == best_b,
                    "train_multimodal: the resumed run differs")
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    torch.cuda.empty_cache()

    # --- timing at B_TIME -------------------------------------------------
    times = {}
    for dtype, finite, top in ((torch.bfloat16, True, True),
                               (None, True, True),
                               (torch.bfloat16, False, False)):
        times[dtype, finite] = _train_timing(card, dtype, finite, reset, read,
                                             top)
    return {k: launches[k] for k in ("iir_sosfilt", "iir_sosfilt_rolldec")}


def _sustained(fn, ms: float):
    """``fn``'s mean device time (CUDA events) over back-to-back launches
    (``ms`` each, a first estimate), and the SM clock (MHz) nvidia-smi
    reports meanwhile: the median of the readings a polling thread finished
    before the launches drained, and how many there were.  The launches go
    in rounds of ~1 s until at least one reading has finished (one
    nvidia-smi call may itself take a second or more), for at most
    ``SUSTAIN_MAX_S``.  Under a sustained tensor-core load the card may
    hold its clock below the maximum to stay within its power limit, so
    time and clock come from one window."""
    samples, busy = [], threading.Event()

    def poll():
        while busy.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,"
                 "noheader,nounits", "-i", str(torch.cuda.current_device())],
                capture_output=True, text=True, timeout=60, check=True).stdout
            samples.append(float(out.split()[0]))
    reps = max(1, min(5000, int(1000 / max(ms, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    busy.set()
    thread = threading.Thread(target=poll)
    thread.start()
    t0, n, done = time.perf_counter(), 0, 0
    start.record()
    while True:
        for _ in range(reps):
            fn()
        n += reps
        torch.cuda.synchronize()
        done = len(samples)
        waited = time.perf_counter() - t0
        if (done > 0 and waited >= 1.0) or waited > SUSTAIN_MAX_S:
            break
    end.record()
    torch.cuda.synchronize()
    busy.clear()
    thread.join()
    require(done > 0, f"no SM clock reading in {waited:.1f} s of the duty "
            "kernel's launches")
    return (start.elapsed_time(end) / n, float(np.median(samples[:done])),
            done)


def phase_convprobe(card: str, dev) -> dict:
    """The duty kernel against its plain version at the probe's four
    shapes (N=16384): exactly on integer operands (R = 0, 1, 3), within
    DUTY_REL on Gaussian ones; the probe's run at R=512 with its launches
    counted; then each shape's time and TFLOP/s beside its bounds by
    operations and by shared memory (at the SM clock read during its run),
    the plain version, and the R library products as one CUDA graph (and
    eagerly).  A shape's ms is the mean over at least ~1 s of back-to-back
    launches, with the SM clock read in that window (:func:`_sustained`)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_duty)
    n, r_check, r_run = 16384, 4, 512
    ops = {}
    for co, k in cuda_duty.SHAPES:
        rng = np.random.default_rng(co + k)
        wi = torch.as_tensor(rng.integers(-4, 5, (co, k)),
                             dtype=torch.bfloat16).to(dev)
        pi = torch.as_tensor(rng.integers(-4, 5, (k, n)),
                             dtype=torch.bfloat16).to(dev)
        for r in (0, 1, 3):
            require(torch.equal(cuda_duty.duty(wi, pi, r),
                                cuda_duty._plain_duty(wi, pi, r)),
                    f"duty ({co}, {k}) R={r}: not exact on integer operands")
        w = torch.as_tensor(rng.standard_normal((co, k)),
                            dtype=torch.bfloat16).to(dev)
        p = torch.as_tensor(rng.standard_normal((k, n)) * 0.1,
                            dtype=torch.bfloat16).to(dev)
        got, want = cuda_duty.duty(w, p, r_check), cuda_duty._plain_duty(
            w, p, r_check)
        e = rel(got, want)
        require(e < DUTY_REL, f"duty ({co}, {k}) rel err {e}")
        ops[(co, k)] = (w, p, max_abs(got, want), e)
    print(f"[convprobe] duty exact (torch.equal) on bf16 integers in [-4, 4] "
          f"at all {len(ops)} shapes, N={n}, R = 0, 1, 3")
    cuda_duty.duty.launches = 0
    for w, p, _, _ in ops.values():
        cuda_duty.duty(w, p, r_run)
    torch.cuda.synchronize()
    launches = cuda_duty.duty.launches
    require(launches > 0, "the duty kernel was not launched by the probe")
    keys = ("ms", "plain_ms", "bound_ms", "smem_bound_ms", "library_ms",
            "library_eager_ms")
    tot = dict(err=0.0, **{key: 0.0 for key in keys}, shapes=[])
    for (co, k), (w, p, err, e) in ops.items():
        run = lambda: cuda_duty.duty(w, p, r_run)
        ms, mhz, readings = _sustained(run, cuda_ms(run, 3))
        plain_ms = cuda_ms(lambda: cuda_duty._plain_duty(w, p, r_run), 5)
        mm = lambda: torch.mm(w, p, out_dtype=torch.float32)
        lib_ms = r_run * graph_ms(mm, r_run)
        lib_eager_ms = r_run * cuda_ms(mm, 20)
        flops = 2 * r_run * co * k * n
        b_ms = flops / BF16_FLOP_PER_S * 1e3
        # each m64n{co}k16 reads 2048 bytes of P and 32*co of W
        smem = r_run * (n // 64) * (k // 16) * (2048 + 32 * co)
        s_ms = smem / (SMEM_BYTES_PER_CLK * N_SMS * mhz * 1e6) * 1e3
        print(f"[convprobe] duty ({co}, {k}) N={n}: rel {e:.2e} at R="
              f"{r_check} (bound {DUTY_REL}); R={r_run}: {ms:.4f} ms = "
              f"{flops / ms / 1e9:.2f} TFLOP/s ({b_ms / ms:.4f} of 989); "
              f"bound {b_ms:.4f} ms by operations, {s_ms:.4f} ms by shared "
              f"memory at {mhz:.0f} MHz SM clock ({readings} readings); "
              f"plain f32 {plain_ms:.4f} ms; torch.mm bf16->f32 x R as one "
              f"graph {lib_ms:.4f} ms, "
              f"eager {lib_eager_ms:.4f} ms [{card}]")
        shape = dict(co=co, k=k, ms=ms, tflops=flops / ms / 1e9,
                     bound_ms=b_ms, smem_bound_ms=s_ms, sm_clock_mhz=mhz,
                     sm_clock_readings=readings,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     library_eager_ms=lib_eager_ms, max_abs_err=err)
        tot["shapes"].append(shape)
        tot["err"] = max(tot["err"], err)
        for key in keys:
            tot[key] += shape[key]
    tot["bound_by"] = "operations"
    tot["launches"] = launches
    print(f"[convprobe] duty total {tot['ms']:.4f} ms; bound "
          f"{tot['bound_ms']:.4f} ms by operations (reached "
          f"{tot['bound_ms'] / tot['ms']:.4f}), {tot['smem_bound_ms']:.4f} "
          f"ms by shared memory")
    print(f"[convprobe] duty launches during the probe's run: {launches}")
    return tot


def _no_dropout(model) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        Dropout)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _diff_batch(seed: int, shape, dev):
    """Seeded micro-batches ``shape`` = (..., B, C, T) of unit-scale EEG
    and their one-hot labels, on ``dev``."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    lab = torch.as_tensor(rng.integers(0, 6, shape[:-2]))
    return x.to(dev), torch.eye(6)[lab].to(dev)


def _layer_dtypes(model, run) -> dict:
    """The output types of ``model``'s dense, conv and GroupNorm layers in
    one ``run()``, counted by type name."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        diffeeg)
    kinds = (diffeeg.Linear, diffeeg.Conv1d, diffeeg.GroupNorm1)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, str(o.dtype)[6:]))
        for n, m in model.named_modules() if isinstance(m, kinds)]
    run()
    for h in hooks:
        h.remove()
    out = {}
    for dt in seen.values():
        out[dt] = out.get(dt, 0) + 1
    return dict(sorted(out.items()))


def _diff_step_vs_cpu(card: str, dev, cfg) -> None:
    """(c), first part: one full-width step (K=DIFF_K, B=DIFF_B, dropout
    off) on the card and on the CPU from the same seeded weights, batch and
    injected draws; then the NaN sentinel on the card."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        DiffEEGTrainer)
    K, B = DIFF_K, DIFF_B
    shape = (K, B, cfg.n_channels, cfg.input_length)
    xs, ys = _diff_batch(21, shape, torch.device("cpu"))
    g = torch.Generator().manual_seed(22)
    draws = [(torch.rand(B, generator=g),
              torch.randint(0, cfg.n_diffusion_steps, (B,), generator=g),
              torch.randn(shape[1:], generator=g)) for _ in range(K)]
    trs, metrics = {}, {}
    for where, on in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = entry.diffeeg_model(cfg, 3)
        _no_dropout(model)
        tr = DiffEEGTrainer(model, cfg, seed=3, device=on)
        t0 = time.perf_counter()
        m = tr.train_step(xs.to(on), ys.to(on),
                          [tuple(a.to(on) for a in d) for d in draws])
        metrics[where] = {k: v.cpu() for k, v in m.items()}
        trs[where] = tr
        torch.cuda.synchronize()
        print(f"[diffusion] step K={K}, B={B} on the {where}: "
              f"{time.perf_counter() - t0:.2f} s (host clock, first call)")
    mc, mh = metrics["cuda"], metrics["cpu"]
    e_loss = abs(float(mc["loss"]) - float(mh["loss"])) / float(mh["loss"])
    e_norm = abs(float(mc["grad_norm"]) - float(mh["grad_norm"])) / float(
        mh["grad_norm"])
    mu_c, mu_h = (trs[w].state.opt_state["mu"].cpu() for w in ("cuda", "cpu"))
    e_mu = norm_rel(mu_c, mu_h)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.state \
        import flat
    p_c, p_h = (flat([p.detach() for p in trs[w].model.parameters()]).cpu()
                for w in ("cuda", "cpu"))
    dp = (p_c - p_h).abs()
    far = mu_h.abs() > DIFF_FAR * mu_h.abs().max()
    lr = cfg.lr
    e_far = float((dp[far] - 2.4e-7 * p_h[far].abs()).max()) / lr
    e_all = float(dp.max()) / lr
    print(f"[diffusion] full-width step, K={K}, B={B}, dropout off, card vs "
          f"CPU on the same draws: loss {float(mc['loss']):.6f} rel "
          f"{e_loss:.2e} (bound {DIFF_LOSS_REL}); grad norm "
          f"{float(mc['grad_norm']):.4e} rel {e_norm:.2e} (bound "
          f"{DIFF_NORM_REL}); Adam's first moment (0.1 g) normwise "
          f"{e_mu:.2e} (bound {DIFF_NORM_REL}); parameters after Adam: "
          f"{e_far:.2e} lr beyond float32 rounding where |g| > {DIFF_FAR} "
          f"of its max ({int(far.sum())} of {far.numel()}; bound 1e-3), "
          f"{e_all:.3f} lr anywhere (not bounded) [{card}]")
    require(e_loss < DIFF_LOSS_REL and e_norm < DIFF_NORM_REL
            and e_mu < DIFF_NORM_REL and e_far < 1e-3,
            "DiffEEG step: card vs CPU out of bounds")
    del trs["cpu"]

    # --- the NaN sentinel on the card --------------------------------------
    tr = trs["cuda"]
    bad = xs.clone()
    bad[K // 2, B // 2, 5, 100:110] = float("nan")
    before = ([p.detach().clone() for p in tr.model.parameters()],
              {k: v.clone() for k, v in tr.state.opt_state.items()},
              tr.state.ema.clone())
    step_no = tr.state.step
    m = tr.train_step(bad.to(dev), ys.to(dev))
    torch.cuda.synchronize()
    kept = (all(torch.equal(a, b) for a, b in
                zip(tr.model.parameters(), before[0]))
            and all(torch.equal(tr.state.opt_state[k], v)
                    for k, v in before[1].items())
            and torch.equal(tr.state.ema, before[2]))
    print(f"[diffusion] NaN in micro-batch {K // 2} on the card: nonfinite "
          f"{bool(m['nonfinite'])}, loss {float(m['loss'])}, parameters, "
          f"optimizer state and EMA bitwise kept {kept}, step {step_no} -> "
          f"{tr.state.step}")
    require(bool(m["nonfinite"]) and kept and tr.state.step == step_no + 1,
            "DiffEEG NaN sentinel on the card")


def _diff_step_timing(card: str, dev, cfg, amp: bool) -> dict:
    """(c) the loss falling over 10 steps at K=2 (lr 1e-3), then (f) the
    full-width step's ms at K=DIFF_K, B=DIFF_B (CUDA events over 3 steps
    after one), peak memory, and its device busy share and top ops
    (profiler over one step)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        entry, profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        DiffEEGTrainer)
    prog = "amp (bf16)" if amp else "float32"
    dtype = torch.bfloat16 if amp else None
    fall = dataclasses.replace(cfg, gradient_accumulate_every=2, lr=1e-3)
    tr = DiffEEGTrainer(entry.diffeeg_model(fall, 4, dtype), fall, seed=4,
                        device=dev)
    xs, ys = _diff_batch(
        23, (2, DIFF_B, cfg.n_channels, cfg.input_length), dev)
    losses = [float(tr.train_step(xs, ys)["loss"]) for _ in range(10)]
    print(f"[diffusion] {prog}, K=2, B={DIFF_B}, lr 1e-3, 10 steps on one "
          f"batch: losses {[round(v, 4) for v in losses]}")
    require(all(np.isfinite(losses))
            and np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"DiffEEG {prog}: the loss did not fall")
    require(all(p.dtype == torch.float32 for p in tr.model.parameters()),
            f"DiffEEG {prog}: parameters left float32")
    del tr, xs, ys
    torch.cuda.empty_cache()

    tr = DiffEEGTrainer(entry.diffeeg_model(cfg, 5, dtype), cfg, seed=5,
                        device=dev)
    xs, ys = _diff_batch(
        24, (DIFF_K, DIFF_B, cfg.n_channels, cfg.input_length), dev)
    torch.cuda.reset_peak_memory_stats()
    one = lambda: tr.train_step(xs, ys)
    ms = cuda_ms(one, 3, warmup=1)
    peak = peak_gib()
    prof = profiling.profile_kernels(one, reps=1, warmup=0)
    # the profiler slows the host; the device's busy time against the
    # unprofiled step time is the idle share that run had
    idle = max(0.0, 1.0 - prof.busy_ms / ms)
    wps = DIFF_K * DIFF_B / ms * 1e3
    ops = sorted(prof.kernel_ms.items(), key=lambda kv: -kv[1])[:6]
    print(f"[diffusion] {prog} step, K={DIFF_K}, B={DIFF_B}: {ms:.3f} "
          f"ms/step = {wps:.1f} training windows/s (CUDA events, 3 steps "
          f"after 1); peak {peak:.2f} GiB; profiler: device busy "
          f"{prof.busy_ms:.3f} ms a step = idle {100 * idle:.1f} % of the "
          f"step (of the profiled step's {prof.wall_ms:.3f} ms wall: "
          f"{100 * max(0.0, 1 - prof.busy_ms / prof.wall_ms):.1f} %), "
          f"{prof.kernels:.0f} kernels a step [{card}]")
    print(f"[diffusion] {prog} step: top device ops: " + "; ".join(
        f"{n[:90]} x{prof.kernel_calls[n]:.0f} {v:.3f} ms" for n, v in ops))
    del tr, xs, ys
    torch.cuda.empty_cache()
    return {"ms": ms, "windows_per_s": wps, "peak_gib": peak, "idle": idle}


def phase_diffusion(card: str, dev) -> dict:
    """The DiffEEG diffusion path at full width (``DiffEEGConfig()``: 19
    channels × 2,000 samples, hidden 32, 1,000 diffusion steps, K=50
    micro-batches of 64, STFT 64/32), seeded weights, float32 with TF32
    off unless amp:

    (a) ``train_diffeeg``'s transform of DIFF_N raw (10000, 20) windows on
        the card (#1, chunks of 256) against the CPU port;
    (b) the denoiser at B=64: the STFT conditioner and ``DiffEEG`` (gathered
        conditioning + denoise) against the CPU; gathered against dense
        conditioning on the card; the amp forward against float32;
    (c) one step (K=50, B=64) against the CPU on the same draws (loss,
        gradient norm, Adam's moment and parameters); a NaN micro-batch
        keeps everything bitwise and advances the step; the loss falls in
        float32 and amp;
    (d) ``train_diffeeg`` on the raw windows (K=4, checkpoints every 2
        steps): 4 steps against 2 and a resume to 4, bitwise (cuDNN
        deterministic), with #1's launches read around the first run;
    (e) the reverse sampler (NaN guard on the card against the CPU with a
        denoiser that returns NaN at one step), then ``generate`` for all 6
        classes from the resumed run's checkpoint, 1,000 steps at B=50;
    (f) timings: the step in float32 and amp, the sampler's ms a reverse
        step, the conditioning gathered and dense, the metrics.

    Returns #1's launches in (d)'s first run, by kernel name."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        stft_log1p_interp)
    reset, read = _counters()
    cfg = C.DiffEEGConfig()
    L, CH = cfg.input_length, cfg.n_channels

    # --- (a) the transform --------------------------------------------------
    rng = np.random.default_rng(20)
    raw = (rng.standard_normal((DIFF_N, 10_000, 20)) * 40).astype(np.float32)
    raw[3, 500:600, 4] = np.nan
    y = rng.random((DIFF_N, 6)).astype(np.float32)
    y /= y.sum(1, keepdims=True)
    reset()
    win_c = entry.diffeeg_training_windows(raw, dev)
    torch.cuda.synchronize()
    counts = read()
    win_h = entry.diffeeg_training_windows(raw, "cpu")
    r = rel(torch.as_tensor(win_c), torch.as_tensor(win_h))
    n_chunks = -(-DIFF_N // 256)
    print(f"[diffusion] (a) train_diffeeg's transform {raw.shape} -> "
          f"{win_c.shape}: card vs CPU rel {r:.2e} (bound 1e-4); "
          f"iir_sosfilt launches {counts['iir_sosfilt']} ({n_chunks} chunks)")
    require(win_c.shape == (DIFF_N, CH, L) and r < 1e-4
            and counts["iir_sosfilt"] == n_chunks,
            "diffusion transform: card vs CPU or launches")

    # --- (b) the denoiser at B=64 -----------------------------------------
    x, yb = _diff_batch(25, (DIFF_B, CH, L), dev)
    t = torch.randint(0, cfg.n_diffusion_steps, (DIFF_B,),
                      generator=torch.Generator().manual_seed(25)).float()
    with torch.no_grad():
        spec = stft_log1p_interp(x)
        spec_h = stft_log1p_interp(x.cpu())
        e_spec = rel(spec.cpu(), spec_h)
        model = entry.diffeeg_model(cfg, 6).eval()
        model_c = copy.deepcopy(model).to(dev)
        got = model_c(x, yb, t.to(dev), spec)
        want = model(x.cpu(), yb.cpu(), t, spec.cpu())
        e_model = rel(got.cpu(), want)
        cond = model_c.conditioning(yb, spec, L)
        dense = model_c.conditioning_dense(yb, spec, L)
        e_dense = max_abs(cond, dense)
        amp = entry.diffeeg_model(cfg, 6, torch.bfloat16).eval().to(dev)
        amp_dtypes = _layer_dtypes(amp, lambda: amp(x, yb, t.to(dev), spec))
        e_amp = rel(amp(x, yb, t.to(dev), spec), got)
        cond_ms = cuda_ms(lambda: model_c.conditioning(yb, spec, L), 5)
        dense_ms = cuda_ms(lambda: model_c.conditioning_dense(yb, spec, L), 3)
        den_ms = cuda_ms(lambda: model_c.denoise(x, cond, t.to(dev)), 10)
    print(f"[diffusion] (b) B={DIFF_B}: STFT conditioner {tuple(spec.shape)} "
          f"card vs CPU rel {e_spec:.2e}; DiffEEG {tuple(got.shape)} card vs "
          f"CPU rel {e_model:.2e} (bound {DIFF_REL}); gathered vs dense "
          f"conditioning on the card max abs {e_dense:.2e} (bound "
          f"{DIFF_DENSE_ATOL}); amp vs float32 rel {e_amp:.2e} (bounds "
          f"{DIFF_AMP_FLOOR} below, {BF16_PROB_ATOL} above); amp's layers "
          f"return {amp_dtypes}")
    print(f"[diffusion] (f) conditioning at B={DIFF_B}: gathered "
          f"{cond_ms:.3f} ms, dense (the whole {CH}x33 -> 16x33x15991 "
          f"ConvTranspose plane) {dense_ms:.3f} ms; one denoise "
          f"{den_ms:.3f} ms [{card}]")
    require(e_spec < DIFF_REL and e_model < DIFF_REL
            and e_dense < DIFF_DENSE_ATOL
            and DIFF_AMP_FLOOR < e_amp < BF16_PROB_ATOL,
            "DiffEEG denoiser: out of bounds")
    require(amp_dtypes == {"bfloat16": 22, "float32": 7},
            f"DiffEEG amp: the layers' output types {amp_dtypes}, not 22 "
            f"bf16 dense/conv layers and 6 GroupNorms + the last conv f32")
    del x, yb, spec, spec_h, model, model_c, amp, got, want, cond, dense
    torch.cuda.empty_cache()

    # --- (c) the step ---------------------------------------------------------
    _diff_step_vs_cpu(card, dev, cfg)
    torch.cuda.empty_cache()
    steps = {amp: _diff_step_timing(card, dev, cfg, amp)
             for amp in (False, True)}

    # --- (d) train_diffeeg with a resume, (e) generate ----------------------
    run = dataclasses.replace(cfg, gradient_accumulate_every=4,
                              save_and_sample_every=2, evaluate_every=1000)
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(device=dev, raw=raw, y=y, cfg=run, seed=7)
            reset()
            a, ha = entry.train_diffeeg(f"{tmp}/a", steps=4, **kw)
            torch.cuda.synchronize()
            launches = read()
            entry.train_diffeeg(f"{tmp}/b", steps=2, **kw)
            b, hb = entry.train_diffeeg(f"{tmp}/b", steps=4, resume=True,
                                        **kw)
            same = (all(torch.equal(p, q) for p, q in
                        zip(a.model.parameters(), b.model.parameters()))
                    and torch.equal(a.state.ema, b.state.ema)
                    and hb["loss"] == ha["loss"][2:])
            names = sorted(p.name for p in Path(f"{tmp}/a/diffeeg").iterdir())
            print(f"[diffusion] (d) train_diffeeg on {DIFF_N} raw windows, "
                  f"K=4, B={DIFF_B}: {names}; losses {ha['loss']}; resumed "
                  f"from step_2: parameters, EMA and losses bitwise equal "
                  f"{same}; launches in the first run {launches} [{card}]")
            require(same and "step_4" in names,
                    "train_diffeeg: the resumed run differs")
            require(launches["iir_sosfilt"] == n_chunks,
                    f"train_diffeeg: iir_sosfilt launches {launches}")
            del a, b
            torch.cuda.empty_cache()
            gen_s = _diff_generation(card, dev, cfg, f"{tmp}/b", win_c)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    torch.cuda.empty_cache()
    print(f"[diffusion] summary: step f32 {steps[False]['ms']:.3f} ms = "
          f"{steps[False]['windows_per_s']:.1f} windows/s, amp "
          f"{steps[True]['ms']:.3f} ms = {steps[True]['windows_per_s']:.1f}; "
          f"generate {gen_s:.2f} s for 6 x {GEN_B} windows [{card}]")
    return {"iir_sosfilt": launches["iir_sosfilt"]}


def _diff_generation(card: str, dev, cfg, ckpt_dir: str, real) -> float:
    """(e) and the rest of (f): the NaN guard on the card, the sampler's
    time a reverse step at B=GEN_B, ``generate`` for all classes from the
    checkpoint under ``ckpt_dir`` (1,000 steps), the metrics of class 0's
    windows against GEN_B real ones.  Returns generate's seconds."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        diffusion, entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        make_cached_denoiser)
    L, CH = cfg.input_length, cfg.n_channels

    # --- the NaN guard on the card ------------------------------------------
    def bad(x, y, t, s):
        return torch.where(t[0] == 5, float("nan"), 0.0) * x + 0.01
    g = torch.Generator().manual_seed(30)
    shape = (GEN_B, CH, L)
    x0 = torch.randn(shape, generator=g)
    noise = [torch.randn(shape, generator=g) for _ in range(9)]
    out = {}
    for where, on in (("cuda", dev), ("cpu", torch.device("cpu"))):
        sched = diffusion.make_schedule(10, on)
        y0 = torch.zeros((GEN_B, 6), device=on)
        s0 = torch.zeros((GEN_B, CH, 50, 50), device=on)
        nz = [n.to(on) for n in noise]
        for guard in (True, False):
            out[where, guard] = diffusion.reverse_diffusion(
                sched, bad, (x0.to(on), lambda i: nz[i]), GEN_B, y0, s0,
                (CH, L), nan_guard=guard).cpu()
    e_guard = max_abs(out["cuda", True], out["cpu", True])
    print(f"[diffusion] (e) NaN guard on the card, a denoiser that returns "
          f"NaN at t=5 of 10: finite {bool(torch.isfinite(out['cuda', True]).all())}"
          f", card vs CPU max abs {e_guard:.2e}; unguarded all NaN "
          f"{bool(torch.isnan(out['cuda', False]).all())}")
    require(bool(torch.isfinite(out["cuda", True]).all()) and e_guard < 1e-5
            and bool(torch.isnan(out["cuda", False]).all()),
            "the sampler's NaN guard on the card")

    # --- the sampler's time a reverse step ------------------------------------
    model = entry.diffeeg_model(cfg, 8).to(dev).eval()
    y = torch.eye(6, device=dev)[torch.zeros(GEN_B, dtype=torch.long,
                                             device=dev)]
    spec = torch.zeros((GEN_B, CH, 50, 50), device=dev)
    den = make_cached_denoiser(model, y, spec, L)
    sched = diffusion.make_schedule(SAMPLER_STEPS, dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    ms = cuda_ms(lambda: diffusion.reverse_diffusion(
        sched, den, gen, GEN_B, y, spec, (CH, L)), 2) / SAMPLER_STEPS
    wps = GEN_B / (ms * cfg.n_diffusion_steps) * 1e3
    print(f"[diffusion] (f) reverse sampler, B={GEN_B}, cached conditioning: "
          f"{ms:.4f} ms a reverse step (CUDA events over 2 x "
          f"{SAMPLER_STEPS} steps) = {wps:.2f} generated windows/s at "
          f"{cfg.n_diffusion_steps} steps [{card}]")
    del model, den
    torch.cuda.empty_cache()

    # --- generate, all classes, 1,000 steps ----------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = entry.generate(ckpt_dir, device=dev, cfg=cfg, n_samples=GEN_B,
                           seed=9)
    gen_s = time.perf_counter() - t0
    outs = {c: np.load(p) for c, p in paths.items()}
    ok = (sorted(outs) == list(range(cfg.n_classes))
          and all(o.shape == (GEN_B, CH, L) and np.isfinite(o).all()
                  for o in outs.values()))
    print(f"[diffusion] (e) generate from {Path(ckpt_dir).name}'s step_4, "
          f"{cfg.n_classes} classes x {GEN_B} windows x "
          f"{cfg.n_diffusion_steps} steps: {gen_s:.2f} s (host clock) = "
          f"{cfg.n_classes * GEN_B / gen_s:.2f} generated windows/s; "
          f"shapes {sorted({o.shape for o in outs.values()})}, all finite "
          f"{ok} [{card}]")
    require(ok, "generate: missing, misshapen or non-finite output")

    # --- the metrics on the card ------------------------------------------------
    r_c = torch.as_tensor(real[:GEN_B]).to(dev)
    g_c = torch.as_tensor(outs[0]).to(dev)
    r64, g64 = r_c.cpu().double().flatten(1), g_c.cpu().double().flatten(1)
    sq = float(torch.cat([r64, g64]).square().sum(1).max())
    # MMD at σ² = median‖x−y‖²/2 over real×generated pairs, so that the
    # cross term is far from 0 and a wrong one shows.  Each kernel entry's
    # exponent carries the float32 error of ‖x‖² + ‖y‖² − 2x·y, at most
    # ~√d·eps·4·max‖x‖² (a d-long float32 sum's rounding grows as √d), over
    # 2σ²; the four kernel means' weights sum to 4
    d2 = torch.cdist(r64, g64).square()
    bw = float(d2.median() / 2) ** 0.5
    kxy = float(torch.exp(-d2 / (2 * bw ** 2)).mean())
    unit = r64.shape[1] ** 0.5 * np.finfo(np.float32).eps * sq / bw ** 2
    mmd_bound = 8 * unit
    print(f"[diffusion] (f) MMD bandwidth {bw:.6g} (median real x generated "
          f"distance / sqrt 2): mean cross kernel {kxy:.4f} (float64), "
          f"2 x that = {2 * kxy / mmd_bound:.3g} x the bound")
    require(2 * kxy > 10 * mmd_bound,
            "MMD's cross term within ten bounds of 0: the check cannot see it")
    parts, errs = [], []
    for name, fn in (("mmd", lambda a, b: diffusion.compute_mmd(a, b, bw)),
                     ("frechet", diffusion.compute_frechet_distance),
                     ("pearson", diffusion.pearson_correlation)):
        v = float(fn(r_c, g_c))
        v64 = float(fn(r_c.cpu().double(), g_c.cpu().double()))
        fn_ms = cuda_ms(lambda: fn(r_c, g_c), 3)
        bound = {"mmd": mmd_bound, "frechet": DIFF_METRIC_REL * abs(v64),
                 "pearson": PEARSON_ATOL}[name]
        errs.append((name, np.isfinite(v) and abs(v - v64) <= bound))
        if name == "mmd":
            mmd_err = abs(v - v64)
        parts.append(f"{name} {v:.6g} ({fn_ms:.3f} ms; against the CPU in "
                     f"float64 {v64:.6g}, |diff| {abs(v - v64):.2e}, bound "
                     f"{bound:.2e})")
    print(f"[diffusion] (f) metrics, {GEN_B} real vs {GEN_B} generated "
          f"(19x2000, max |x|² {sq:.4g}): " + "; ".join(parts) + f"; MMD's "
          f"|diff| = {mmd_err / unit:.3g} x sqrt(d) eps max|x|²/σ² [{card}]")
    for name, ok in errs:
        require(ok, f"{name} on the card against float64: out of bounds")
    return gen_s


def _write_numpy_tree(root: str, seed: int) -> None:
    """A synthetic HMS tree in numpy form, with no pandas: ``train.csv``
    (the Kaggle schema's columns, written by ``csv``), the window cache
    ``cache/eeg_cache.npz`` (each recording cropped by the port's
    ``crop_eeg_window`` into its ``EEGRecordCache``) and
    ``npy/<spectrogram_id>.npy`` planes stored (F, T).  Ids, patients,
    offsets and votes follow the JAX package's ``write_synthetic_hms_tree``;
    recordings carry a few NaN runs."""
    import csv

    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, data)
    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/cache")
    os.makedirs(f"{root}/npy")
    cache = data.EEGRecordCache(f"{root}/cache/eeg_cache.npz")
    header = ["eeg_id", "eeg_sub_id", "eeg_label_offset_seconds",
              "spectrogram_id", "spectrogram_sub_id",
              "spectrogram_label_offset_seconds", "label_id", "patient_id",
              "expert_consensus", *C.TGT_VOTE_COLS]
    rows = []
    for i in range(RD_IDS):
        eeg_id, spec_id, patient = 1000 + i, 2000 + i, 100 + i // 2
        rec = rng.standard_normal((RD_EEG_LEN, 20), np.float32) * 40
        rec[rng.integers(0, RD_EEG_LEN - 50):][:50, i % 20] = np.nan
        cache[eeg_id] = data.crop_eeg_window(rec, 10_000)
        np.save(f"{root}/npy/{spec_id}.npy",
                rng.random((400, RD_SPEC_T), np.float32) * 10)
        for r in range(RD_ROWS):
            votes = rng.integers(0, 8, 6)
            votes[i % 6] += 8
            rows.append([eeg_id, r, float(r * 2), spec_id, r, float(r * 4),
                         i * 10 + r, patient, C.CLASSES[i % 6],
                         *votes.tolist()])
    cache.save()
    with open(f"{root}/train.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


class _StepClock:
    """Times every call of the epoch trainer's train step with CUDA events:
    ``train.trainer.make_train_step`` is wrapped while the context is open.
    ``ms()`` gives each step's device time; ``span_ms(i, j)`` the device
    timeline from step i's start to step j's end (the host gather, the
    copies and the preprocessing between steps included); ``gaps_ms(i,
    j)`` the device time between consecutive steps i..j, from one step's
    end to the next one's start."""

    def __enter__(self):
        from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
            trainer)
        self.events, self._mod = [], trainer
        self._orig = trainer.make_train_step

        def make(**kw):
            inner = self._orig(**kw)

            def step(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*args, **kwargs)
                end.record()
                self.events.append((start, end))
                return out
            return step
        trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        self._mod.make_train_step = self._orig
        torch.cuda.synchronize()

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]

    def span_ms(self, i: int = 0, j: int = -1) -> float:
        return self.events[i][0].elapsed_time(self.events[j][1])

    def gaps_ms(self, i: int, j: int) -> list:
        return [self.events[k][1].elapsed_time(self.events[k + 1][0])
                for k in range(i, j)]


class _FirstLoss:
    """A trainer logger keeping the logged losses (the first step's
    among them)."""

    def __init__(self):
        self.losses = []

    def log_loss(self, loss, step):
        self.losses.append(loss)

    def log_evaluation(self, result, epoch):
        pass


def _rd_multimodal(card: str, dev, tree: str, work: str, dtype, reset,
                   read) -> dict:
    """(a) ``RD_EPOCHS[prog]`` epochs of ``train_multimodal(data_root=...)``
    at B=256 in ``dtype``: its step times, the pipeline's training
    windows/s inside each epoch (from the first step's end to the last
    one's, pooled over the epochs) and over epochs 2.. whole (validation
    and epoch starts included), the device time between steps, the host
    gather's ms a batch (library and numpy) and the producer's (the gather
    and the pinned copy to the card, as the run's prefetch thread does them,
    with no step to hide behind), peak memory; the first step's loss
    against the same step run by hand on the first batch gathered by
    ``gather_multimodal_numpy``; #2's launches, held to one a
    preprocessed batch."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, entry, train)
    from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
        prefetch_to_device)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        spectrogram_augment)
    from multimodal_brain_pattern_identification_xai_tpu_torch.runtime import (
        gather_multimodal_numpy)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        steps as train_steps)
    B = C.TrainerConfig().batch_size
    prog = "bf16" if dtype is not None else "float32"
    epochs = RD_EPOCHS[prog]
    # each run checkpoints in a directory of its own, beside the tree's cache
    os.makedirs(f"{work}/{prog}")
    os.symlink(f"{tree}/cache/eeg_cache.npz", f"{work}/{prog}/eeg_cache.npz")
    log = _FirstLoss()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        tr, best = entry.train_multimodal(
            f"{work}/{prog}", device=dev, epochs=epochs, seed=RD_SEED,
            dtype=dtype, data_root=tree, npy_dir=f"{tree}/npy",
            loggers=[log], workers=8)
    wall = time.perf_counter() - t0
    counts = read()
    peak = peak_gib()
    steps = clock.ms()
    src, tr_idx, va_idx = entry.multimodal_fold0(
        tree, f"{work}/{prog}", RD_SEED, npy_dir=f"{tree}/npy")
    n_val = -(-len(va_idx) // B)
    n = len(tr_idx) // B                              # steps an epoch
    spans = [(e * n, e * n + n - 1) for e in range(epochs)]
    inside = [clock.span_ms(i, j) - steps[i] for i, j in spans]
    gaps = [g for i, j in spans for g in clock.gaps_ms(i, j)]
    # the host gather alone: the library into the two-slot ring, and numpy
    t1 = time.perf_counter()
    for _ in src.batches(tr_idx, B, shuffle=True, seed=RD_SEED,
                         reuse_buffers=True):
        pass
    gather_ms = (time.perf_counter() - t1) * 1e3 / n
    # the producer alone: the gather and the copy to the card, as the run
    t1 = time.perf_counter()
    for _ in prefetch_to_device(src.batches(tr_idx, B, shuffle=True,
                                            seed=RD_SEED, reuse_buffers=True),
                                device=dev, sync_transfers=True):
        pass
    producer_ms = (time.perf_counter() - t1) * 1e3 / n
    t1 = time.perf_counter()
    first = next(src.batches(tr_idx, B, shuffle=True, seed=RD_SEED,
                             gather=gather_multimodal_numpy))
    numpy_ms = (time.perf_counter() - t1) * 1e3
    # the first step by hand on the numpy gather's batch
    model = entry.build_train_model(dtype=dtype)
    train.initialize_kaiming_weights(model,
                                     torch.Generator().manual_seed(RD_SEED))
    state = train.create_train_state(model.to(dev), train.make_optimizer(
        C.TrainerConfig().lr))
    state.rng.manual_seed(RD_SEED)
    pb = entry.preprocess_batch(*(torch.from_numpy(first[k]).to(dev)
                                  for k in ("eeg", "spec", "y")))
    key = train_steps.fold_in(train_steps.fold_in(
        torch.Generator().manual_seed(RD_SEED + 1), 0, torch.device("cpu")),
        0, dev)
    s, yb = spectrogram_augment(key, pb["spec"], pb["y"], pb["spec"], pb["y"])
    _, m = train.make_train_step()(state, {"eeg": pb["eeg"], "spec": s,
                                           "y": yb}, state.rng)
    ref = float(m["loss"])
    out = {"epochs": epochs, "steps": len(steps), "val_rows": len(va_idx),
           "step_ms": steps, "step_ms_after_first": float(np.mean(steps[1:])),
           "train_windows_per_s": B * (n - 1) * epochs / sum(inside) * 1e3,
           "epoch_windows_per_s": [B * (n - 1) / ms * 1e3 for ms in inside],
           # from the end of epoch 1's last step to the end of the last one
           "run_windows_per_s": (B * n * (epochs - 1) * 1e3
                                 / (clock.span_ms(n - 1, -1) - steps[n - 1])
                                 if epochs > 1 else None),
           "gap_ms": gaps, "gap_ms_mean": float(np.mean(gaps)),
           "gather_ms_a_batch": gather_ms, "numpy_gather_ms_a_batch": numpy_ms,
           "producer_ms_a_batch": producer_ms,
           "peak_gib": peak, "run_s": wall, "first_loss": log.losses[0],
           "first_loss_numpy_gather": ref,
           "train_loss": tr.history["train_loss"], "best_kldiv": best,
           "launches": counts}
    run_rate = ("" if epochs == 1 else
                f", by epoch {[round(r, 1) for r in out['epoch_windows_per_s']]}"
                f", {out['run_windows_per_s']:.1f} over epochs 2-{epochs} "
                f"whole (validation and epoch starts included)")
    print(f"[realdata] (a) train_multimodal {prog}, fold 0, B={B}, "
          f"{epochs} epoch(s): {len(steps)} steps, ms a step "
          f"{[round(x, 3) for x in steps]} (CUDA events); "
          f"{out['train_windows_per_s']:.1f} training windows/s inside the "
          f"epochs (steps 2-{n} of each: host gather, copies and "
          f"preprocessing included){run_rate}; between steps "
          f"{out['gap_ms_mean']:.3f} ms on average, "
          f"{[round(g, 3) for g in gaps]}; host gather {gather_ms:.2f} ms a "
          f"batch (library, ring), {numpy_ms:.2f} ms (numpy); the producer "
          f"alone (gather and pinned copy to the card) {producer_ms:.2f} ms "
          f"a batch; peak {peak:.2f} GiB; run {wall:.2f} s; first loss "
          f"{log.losses[0]!r} vs {ref!r} by hand on the numpy gather's "
          f"batch; best kldiv {best:.4f}; launches {counts} [{card}]")
    require(all(np.isfinite(tr.history["train_loss"])) and np.isfinite(best),
            f"(a) {prog}: a loss is not finite")
    require(log.losses[0] == ref,
            f"(a) {prog}: first step's loss {log.losses[0]!r} differs from "
            f"the numpy gather's {ref!r}")
    require(len(steps) == n * epochs
            and counts["iir_sosfilt_rolldec"]
            == len(steps) + (epochs + 1) * n_val
            and counts["iir_sosfilt"] == 0,
            f"(a) {prog}: launches {counts}, {len(steps)} steps, {n_val} "
            f"validation batches (evaluated once an epoch and at the end)")
    del tr, state, model, src
    torch.cuda.empty_cache()
    return out


def _rd_grid(card: str, dev, tree: str, x, y, reset, read) -> dict:
    """(c) ``grid_search`` with the default grid (3 learning rates), one
    epoch at B=16: each candidate's final loss against the same candidate
    trained alone with the port's Adam (RD_GRID_REL); a grid step's time
    beside a single step's, held to RD_GRID_RATIO times the 3 single
    steps, and each one's device busy time and top kernels (profiler)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        entry, profiling, train)
    from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
        batch_iterator)
    reset()
    t0 = time.perf_counter()
    best, results = entry.grid_search(tree, f"{tree}/cache", device=dev,
                                      epochs=1, batch_size=RD_WAVENET_B,
                                      seed=RD_SEED)
    wall = time.perf_counter() - t0
    counts = read()
    lrs = entry.DEFAULT_GRID["lr"]
    errs = []
    for g, lr in enumerate(lrs):
        state = train.create_train_state(
            entry.wavenet_model(RD_SEED + g).to(dev),
            train.make_optimizer(np.float32(lr)))
        step = train.make_train_step()
        for b in batch_iterator({"x": x, "y": y}, RD_WAVENET_B, shuffle=True,
                                seed=RD_SEED):
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in b.items()})
        got = next(r["loss"] for r in results
                   if abs(r["lr"] - lr) <= 1e-6 * lr)
        errs.append(abs(got - float(m["loss"])) / abs(float(m["loss"])))
    # a grid step of the 3 candidates beside one candidate's step
    model = entry.wavenet_model(RD_SEED).to(dev)
    params, opt = train.init_candidates(model, len(lrs), RD_SEED)
    gstep = train.make_grid_step(model, train.kldiv_with_logits, 0)
    hp = torch.tensor([[lr] for lr in lrs], device=dev)
    bx = torch.from_numpy(x[:RD_WAVENET_B]).to(dev)
    by = torch.from_numpy(y[:RD_WAVENET_B]).to(dev)
    box = [params, opt]

    def grid():
        box[0], box[1], _ = gstep(box[0], box[1], hp, bx, by)
    g_ms = cuda_ms(grid, 3)
    single = train.create_train_state(model, train.make_optimizer(1e-3))
    one = train.make_train_step()
    s_ms = cuda_ms(lambda: one(single, {"x": bx, "y": by}), 5)
    # where a step's time goes: one candidate's step and the grid step
    profs = {"single": profiling.profile_kernels(
        lambda: one(single, {"x": bx, "y": by}), reps=2, warmup=0),
        "grid": profiling.profile_kernels(grid, reps=1, warmup=0)}
    for what, prof in profs.items():
        ops = sorted(prof.kernel_ms.items(), key=lambda kv: -kv[1])[:5]
        print(f"[realdata] (c) {what} WaveNet step, B={RD_WAVENET_B}, "
              f"profiler: busy {prof.busy_ms:.3f} of {prof.wall_ms:.3f} ms "
              f"wall, {prof.kernels:.0f} kernels; top: "
              + "; ".join(f"{n[:90]} x{prof.kernel_calls[n]:.0f} "
                          f"{v:.3f} ms" for n, v in ops))
    ratio = g_ms / (len(lrs) * s_ms)
    out = {"results": results, "best": best, "candidate_rel": errs,
           "grid_step_ms": g_ms, "single_step_ms": s_ms,
           "grid_over_single_steps": ratio,
           "steps": len(x) // RD_WAVENET_B, "wall_s": wall,
           "launches": counts,
           "profile": {what: {"busy_ms": p.busy_ms, "wall_ms": p.wall_ms,
                              "kernels": p.kernels}
                       for what, p in profs.items()}}
    print(f"[realdata] (c) grid_search, {len(lrs)} candidates, 1 epoch at "
          f"B={RD_WAVENET_B} ({out['steps']} grid steps, {wall:.2f} s): "
          f"{results}; each candidate vs trained alone rel "
          f"{[f'{e:.2e}' for e in errs]} (bound {RD_GRID_REL}); grid "
          f"step {g_ms:.3f} ms vs {len(lrs)} x single {s_ms:.3f} ms = "
          f"{len(lrs) * s_ms:.3f} ms ({ratio:.3f}x, bound "
          f"{RD_GRID_RATIO}x); launches {counts} [{card}]")
    require(max(errs) < RD_GRID_REL, f"(c) grid candidates differ: {errs}")
    require(ratio <= RD_GRID_RATIO,
            f"(c) the grid step takes {ratio:.3f}x {len(lrs)} single steps")
    require(counts["iir_sosfilt"] == 1, f"(c) launches {counts}")
    return out


def phase_realdata(card: str, dev, tmp: str) -> dict:
    """The real-data training paths at full width, from a synthetic HMS
    tree in numpy form (``_write_numpy_tree``: RD_IDS eeg_ids × RD_ROWS
    rows, no pandas):

    (a) ``entry.train_multimodal(data_root=...)``, bf16 and float32
        (``_rd_multimodal``);
    (b) ``entry.train_wavenet``: fold 0 of 5, one epoch at B=16 of the full
        ``DilatedInceptionWaveNet``; the magic-8 transform (#1) timed for
        the RD_IDS windows;
    (c) ``entry.grid_search`` (``_rd_grid``);
    (d) ``entry.train_diffeeg(data_root=...)``: two steps at K=4 off the
        host library's queue.

    Then the host library's ``gather_multimodal`` and ``NativeBatchQueue``
    bitwise against their numpy versions on the tree.  Each path's launch
    counts are set to 0 just before it and read just after; #1 runs once a
    256-window chunk in (b), (c) and (d), #2 once a preprocessed batch in
    (a).  The tree is written under ``tmp`` (``tmp/hms``), where phase 14
    reads it again.  Prints the ``{"realdata": ...}`` line; returns the
    launches by kernel name summed over the paths."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, data, entry, runtime)
    reset, read = _counters()
    t_phase = time.perf_counter()
    rec = {"eeg_ids": RD_IDS, "rows": RD_IDS * RD_ROWS, "card": card}
    tree = f"{tmp}/hms"
    t0 = time.perf_counter()
    _write_numpy_tree(tree, RD_SEED)
    rec["tree_s"] = time.perf_counter() - t0
    print(f"[realdata] tree in numpy form: {RD_IDS} eeg_ids x {RD_ROWS} "
          f"rows, {RD_EEG_LEN}-sample recordings cropped to 10000, "
          f"(400, {RD_SPEC_T}) planes, written in {rec['tree_s']:.2f} s")
    t_paths = time.perf_counter()

    # (a) -----------------------------------------------------------------
    rec["a"] = {prog: _rd_multimodal(card, dev, tree, f"{tmp}/a", dtype,
                                     reset, read)
                for prog, dtype in (("bf16", torch.bfloat16),
                                    ("float32", None))}

    # (b) -----------------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        oof, scores = entry.train_wavenet(
            tree, f"{tree}/cache", device=dev, epochs=1,
            batch_size=RD_WAVENET_B, seed=RD_SEED, one_fold=True)
    wall = time.perf_counter() - t0
    counts = read()
    steps = clock.ms()
    raw = data.wavenet_arrays(C.PathsConfig.at(tree), f"{tree}/cache")
    x_ms = cuda_ms(lambda: entry.transform_windows(
        raw["x"], entry.WAVENET_TRANSFORM, dev), 3)
    x = entry.transform_windows(raw["x"], entry.WAVENET_TRANSFORM, dev)
    y = raw["y"]
    rec["b"] = {"steps": len(steps), "step_ms": steps,
                "step_ms_after_first": float(np.mean(steps[1:])),
                "transform_ms": x_ms, "fold_score": scores[0],
                "wall_s": wall, "launches": counts}
    print(f"[realdata] (b) train_wavenet, fold 0 of {C.N_FOLDS}, 1 epoch "
          f"at B={RD_WAVENET_B}: {len(steps)} steps, "
          f"{rec['b']['step_ms_after_first']:.3f} ms a step after the "
          f"first ({steps[0]:.3f}); fold kldiv {scores[0]:.4f}; the "
          f"magic-8 transform of {RD_IDS} windows {x_ms:.3f} ms; "
          f"{wall:.2f} s in all; launches {counts} [{card}]")
    require(np.isfinite(scores[0]) and np.isfinite(oof).all()
            and x.shape == (RD_IDS, 2000, 8),
            "(b) train_wavenet: not finite or wrong shape")
    require(counts["iir_sosfilt"] == 1
            and counts["iir_sosfilt_rolldec"] == 0,
            f"(b) launches {counts}")

    # (c) -----------------------------------------------------------------
    rec["c"] = _rd_grid(card, dev, tree, x, y, reset, read)

    # (d) -----------------------------------------------------------------
    cfg = dataclasses.replace(C.DiffEEGConfig(),
                              gradient_accumulate_every=4)
    reset()
    t0 = time.perf_counter()
    tr, hist = entry.train_diffeeg(f"{tree}/cache", device=dev, cfg=cfg,
                                   steps=2, seed=RD_SEED, data_root=tree)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    rec["d"] = {"losses": hist["loss"], "wall_s": wall,
                "launches": counts}
    print(f"[realdata] (d) train_diffeeg, K=4, B={cfg.batch_size}, 2 "
          f"steps: losses {hist['loss']}, {wall:.2f} s with the "
          f"transform; launches {counts} [{card}]")
    require(len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
            and tr.state.step == 2, "(d) train_diffeeg")
    require(counts["iir_sosfilt"] == 1, f"(d) launches {counts}")
    del tr

    # the host library against numpy on the tree ------------------------
    src, tr_idx, _ = entry.multimodal_fold0(tree, f"{tree}/cache",
                                            RD_SEED,
                                            npy_dir=f"{tree}/npy")
    rows = tr_idx[:C.TrainerConfig().batch_size]
    lib = src.gather(rows)
    plain = src.gather(rows, gather=runtime.gather_multimodal_numpy)
    same_g = all(np.array_equal(lib[k], plain[k])
                 for k in ("eeg", "spec", "y"))
    store = src._eeg_stack.copy()
    store[3, 2, 100:400] = np.nan
    store[9, 0, :] = np.nan
    q = [{k: v.copy() for k, v in b.items()} for b in
         runtime.NativeBatchQueue(store, src.y[:len(store)], 64,
                                  seed=RD_SEED, pop_ring=12)]
    ref = list(runtime.batch_queue_numpy(store, src.y[:len(store)], 64,
                                         seed=RD_SEED))
    same_q = len(q) == len(ref) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(q, ref)
        for k in ("x", "y"))
    print(f"[realdata] host library vs numpy on the tree: "
          f"gather_multimodal of {len(rows)} rows bitwise {same_g}; "
          f"NativeBatchQueue ({len(q)} batches of 64 over {len(store)} "
          f"windows with NaN runs) bitwise {same_q}")
    require(same_g and same_q, "host library differs from numpy")
    rec["paths_s"] = time.perf_counter() - t_paths
    rec["phase_s"] = time.perf_counter() - t_phase
    launches = {
        "iir_sosfilt": sum(rec[p]["launches"]["iir_sosfilt"]
                           for p in ("b", "c", "d")),
        "iir_sosfilt_rolldec": sum(rec["a"][p]["launches"]
                                   ["iir_sosfilt_rolldec"]
                                   for p in ("bf16", "float32"))}
    rec["launches"] = launches
    print(f"[realdata] phase {rec['phase_s']:.1f} s: tree {rec['tree_s']:.1f}"
          f" s, paths and holds {rec['paths_s']:.1f} s")
    print(json.dumps({"realdata": rec}, default=float))
    return launches


# Zoo (phase 14): the 10 models of the zoo beyond the serving pair, at full
# width: forwards at ZOO_B against the CPU (float32, TF32 off) and timed at
# ZOO_TIME_B; branch pretraining at B=256 (EEG) and ZOO_SPEC_B
# (spectrograms), one epoch of fold 0 each; rollout card vs CPU;
# retrain_on_top_channels on ZOO_RETRAIN_ROWS windows
ZOO_EEG = ("eegnet", "eegnet_attention_deep", "eegnet_residual",
           "eegnet_residual_lstm", "eegnet_transformer",
           "eeg_seizure_detection", "deepconvnet")
ZOO_SPEC = ("spectrogram_vit", "efficientnet_b0", "efficientnetv2_b2")
ZOO_B, ZOO_TIME_B, ZOO_SPEC_B = 4, 64, 64
ZOO_ROLLOUT_ATOL = 1e-4
ZOO_RETRAIN_N, ZOO_RETRAIN_ROWS, ZOO_SHAP_ROWS = 5, 256, 16


def _zoo_forward(card: str, dev, name: str) -> dict:
    """(a) ``build(name)`` at full width with seeded weights: log-probs at
    ZOO_B on the card against the CPU (LOGP_ATOL), a forward's time at
    ZOO_TIME_B and the peak memory around it; (e) for the models with
    attention layers, ``rollout_from_model`` on the card against the CPU
    (ZOO_ROLLOUT_ATOL)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import models
    from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
        rollout)
    model = models.build(name)
    model.load_state_dict(models.seeded_state_dict(model, RD_SEED))
    model.eval()
    shape = (1, 37, 3000) if name in ZOO_EEG else (3, 400, 300)
    x = signal((ZOO_B, *shape), 1.0, RD_SEED, "cpu")
    with torch.no_grad():
        want = model(x)
    attn = name in ("spectrogram_vit", "eegnet_transformer")
    want_roll = rollout.rollout_from_model(model, x) if attn else None
    model.to(dev)
    with torch.no_grad():
        got = model(x.to(dev)).cpu()
    err = max_abs(got, want)
    out = {"max_abs_err": err, "shape": list(got.shape)}
    if attn:
        roll = rollout.rollout_from_model(model, x.to(dev)).cpu()
        out["rollout_max_abs_err"] = max_abs(roll, want_roll)
        out["rollout_shape"] = list(roll.shape)
    xb = signal((ZOO_TIME_B, *shape), 1.0, RD_SEED + 1, dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out["ms_b64"] = cuda_ms(lambda: model(xb), 3)
    out["peak_gib"] = peak_gib()
    out["params_m"] = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"[zoo] (a) {name}: {out['params_m']:.2f} M parameters; B={ZOO_B} "
          f"log-probs vs CPU max abs {err:.3e} (bound {LOGP_ATOL})"
          + (f"; (e) rollout {out['rollout_shape']} vs CPU max abs "
             f"{out['rollout_max_abs_err']:.3e} (bound {ZOO_ROLLOUT_ATOL})"
             if attn else "")
          + f"; forward at B={ZOO_TIME_B} {out['ms_b64']:.3f} ms, peak "
          f"{out['peak_gib']:.2f} GiB [{card}]")
    require(torch.isfinite(got).all() and got.shape == (ZOO_B, 6)
            and err < LOGP_ATOL, f"(a) {name}: log-probs differ by {err}")
    if attn:
        require(out["rollout_max_abs_err"] < ZOO_ROLLOUT_ATOL,
                f"(e) {name}: rollout differs by {out['rollout_max_abs_err']}")
    del model, xb
    torch.cuda.empty_cache()
    return out


def _workdir(tree: str, path: str) -> str:
    """A checkpoint directory that reads the tree's window cache."""
    if not os.path.isdir(path):
        os.makedirs(path)
        os.symlink(f"{tree}/cache/eeg_cache.npz", f"{path}/eeg_cache.npz")
    return path


def _zoo_branch(card: str, dev, tree: str, ckpt: str, which: str, arch: str,
                n_val_rows: int, reset, read) -> dict:
    """(b)/(c) one epoch of ``train_branch(which, arch=arch)`` on fold 0
    (B=256 for EEG, ZOO_SPEC_B for spectrograms): ms a step, training
    windows/s from step 2's start to the last step's end (host gather,
    copies and preprocessing included), peak memory, a finite best kldiv;
    #2 once a preprocessed EEG batch (steps + 2 validation passes), #1
    never."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, entry)
    bs = C.TrainerConfig().batch_size if which == "eeg" else ZOO_SPEC_B
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        hist, best = entry.train_branch(
            which, _workdir(tree, ckpt), arch=arch, device=dev, epochs=1,
            batch_size=bs, seed=RD_SEED, data_root=tree,
            npy_dir=f"{tree}/npy")
    wall = time.perf_counter() - t0
    counts = read()
    steps = clock.ms()
    n = len(steps)
    span = clock.span_ms(1, -1)
    n_val = -(-n_val_rows // bs)
    out = {"batch": bs, "steps": n, "step_ms": steps,
           "step_ms_after_first": float(np.mean(steps[1:])),
           "train_windows_per_s": bs * (n - 1) / span * 1e3,
           "peak_gib": peak_gib(), "best_kldiv": best,
           "train_loss": hist["train_loss"], "wall_s": wall,
           "launches": counts}
    tag = "(b)" if which == "eeg" else "(c)"
    print(f"[zoo] {tag} train_branch {which} {arch}, B={bs}, 1 epoch: {n} "
          f"steps, {out['step_ms_after_first']:.3f} ms a step after the "
          f"first ({steps[0]:.3f}); {out['train_windows_per_s']:.1f} "
          f"training windows/s over steps 2-{n}; peak "
          f"{out['peak_gib']:.2f} GiB; best kldiv {best:.4f}; {wall:.2f} s; "
          f"launches {counts} [{card}]")
    require(np.isfinite(best) and all(np.isfinite(hist["train_loss"])),
            f"{tag} {arch}: a loss is not finite")
    with open(f"{ckpt}/{which}/ARCH") as f:
        require(f.read().strip() == arch, f"{tag} {arch}: ARCH")
    want = n + 2 * n_val if which == "eeg" else 0
    require(counts["iir_sosfilt_rolldec"] == want
            and counts["iir_sosfilt"] == 0,
            f"{tag} {arch}: launches {counts}, {n} steps, {n_val} "
            "validation batches (evaluated at the epoch's end and from the "
            "best checkpoint)")
    torch.cuda.empty_cache()
    return out


class _FirstStepState:
    """The model's state dict (on the CPU) as the epoch trainer's first
    train step receives it: ``train.trainer.make_train_step`` is wrapped
    while the context is open."""

    def __enter__(self):
        from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
            trainer)
        self.state, self._mod = {}, trainer
        self._orig = trainer.make_train_step

        def make(**kw):
            inner = self._orig(**kw)

            def step(state, *args, **kwargs):
                if not self.state:
                    self.state.update({k: v.detach().cpu().clone() for k, v
                                       in state.model.state_dict().items()})
                return inner(state, *args, **kwargs)
            return step
        trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        self._mod.make_train_step = self._orig


def phase_zoo(card: str, dev, tmp: str) -> dict:
    """The rest of the model zoo and branch pretraining at full width, on
    phase 13's tree (``tmp/hms``):

    (a) the 10 ``REGISTRY`` models no other phase runs (all but the
        serving pair, the WaveNet and the DiffEEG denoisers): card vs CPU,
        timed (``_zoo_forward``);
    (b) ``entry.train_branch("eeg")`` for all 8 EEG archs and
    (c) ``train_branch("spectrogram")`` for all 4 spectrogram archs
        (``_zoo_branch``); the default archs write to one directory;
    (d) ``train_multimodal(data_root=..., init_from=...)`` from that
        directory, one epoch: the model at the first step bitwise equal to
        the branches' best checkpoints;
    (e) rollout of the ViT and the EEG transformer (in (a));
    (f) ``retrain_on_top_channels`` (N = 5, 2 epochs) on ZOO_RETRAIN_ROWS
        preprocessed windows, ranked by gradient SHAP of (b)'s default
        model.

    Each path's launch counts are set to 0 just before it and read just
    after.  Prints the ``{"zoo": ...}`` line; returns the launches by
    kernel name summed over the phase."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, entry, train, xai)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        hms_eeg_preprocess)
    from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
        channel_select)
    reset, read = _counters()
    t_phase = time.perf_counter()
    tree, work = f"{tmp}/hms", f"{tmp}/zoo"
    handoff = f"{work}/handoff"
    rec = {"card": card, "a": {}, "b": {}, "c": {}}

    # (a), (e) ------------------------------------------------------------
    for name in ZOO_EEG + ZOO_SPEC:
        rec["a"][name] = _zoo_forward(card, dev, name)
    rec["a_s"] = time.perf_counter() - t_phase

    # (b), (c) ------------------------------------------------------------
    src, tr_idx, va_idx = entry.multimodal_fold0(
        tree, _workdir(tree, handoff), RD_SEED, npy_dir=f"{tree}/npy")
    for which, key in (("eeg", "b"), ("spectrogram", "c")):
        for arch in entry.BRANCH_ARCHS[which]:
            ckpt = (handoff if arch == entry.BRANCH_DEFAULT[which]
                    else f"{work}/{arch}")
            rec[key][arch] = _zoo_branch(card, dev, tree, ckpt, which, arch,
                                         len(va_idx), reset, read)

    # (d) ------------------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    with _FirstStepState() as first:
        tr, best = entry.train_multimodal(
            _workdir(tree, f"{work}/mm"), device=dev, epochs=1,
            seed=RD_SEED, data_root=tree, npy_dir=f"{tree}/npy",
            init_from=handoff)
    counts = read()
    same = {}
    for which, sub in (("eeg", "eeg_model"),
                       ("spectrogram", "spectrogram_model")):
        branch = train.CheckpointManager(f"{handoff}/{which}").load(
            "best-kldiv")["model"]
        same[which] = bool(branch) and all(
            torch.equal(first.state[f"{sub}.{k}"], v.cpu())
            for k, v in branch.items())
    rec["d"] = {"best_kldiv": best, "steps": tr.state.step,
                "grafted_bitwise": same, "wall_s": time.perf_counter() - t0,
                "launches": counts}
    print(f"[zoo] (d) train_multimodal(init_from=...), 1 epoch at B=256: "
          f"{tr.state.step} steps, best kldiv {best:.4f}, the model at the "
          f"first step equal to the branches' best checkpoints {same}; "
          f"{rec['d']['wall_s']:.2f} s; launches {counts} [{card}]")
    require(all(same.values()) and np.isfinite(best),
            f"(d) the graft differs from the branch checkpoints: {same}")
    require(counts["iir_sosfilt_rolldec"] > 0 and counts["iir_sosfilt"] == 0,
            f"(d) launches {counts}")
    del tr

    # (f) ------------------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    raw = src.gather(tr_idx[:ZOO_RETRAIN_ROWS], want=("eeg",))
    with torch.no_grad():
        x = hms_eeg_preprocess(torch.from_numpy(raw["eeg"]).to(dev),
                               assume_finite=True)
    model = entry.branch_model("eeg").to(dev)
    model.load_state_dict(train.CheckpointManager(f"{handoff}/eeg").load(
        "best-kldiv")["model"])
    model.eval()
    sv = xai.gradient_shap_values(
        model, x[:ZOO_SHAP_ROWS], x[ZOO_SHAP_ROWS:4 * ZOO_SHAP_ROWS],
        torch.Generator(device=dev).manual_seed(RD_SEED), nsamples=8)
    report = channel_select.retrain_on_top_channels(
        x.cpu().numpy(), raw["y"], sv.cpu().numpy(),
        n_channels=ZOO_RETRAIN_N, epochs=2, batch_size=32, seed=RD_SEED,
        device=dev)
    counts = read()
    rec["f"] = {**report, "wall_s": time.perf_counter() - t0,
                "launches": counts}
    print(f"[zoo] (f) retrain_on_top_channels, N={ZOO_RETRAIN_N}, 2 epochs "
          f"on {ZOO_RETRAIN_ROWS} windows (gradient SHAP of (b)'s "
          f"{entry.BRANCH_DEFAULT['eeg']} on {ZOO_SHAP_ROWS}): top channels "
          f"{[channel_select.channel_names_37()[i] for i in report['top_channels']]}"
          f", fresh {report['fresh']}, retrained {report['retrained']}; "
          f"{rec['f']['wall_s']:.2f} s; launches {counts} [{card}]")
    require(len(report["top_channels"]) == ZOO_RETRAIN_N
            and np.isfinite(report["best_kldiv"])
            and all(np.isfinite(v) for v in report["retrained"].values()),
            f"(f) retrain: {report}")
    require(counts["iir_sosfilt_rolldec"] == 1, f"(f) launches {counts}")
    del model, x, sv

    rec["launches"] = {k: rec["d"]["launches"][k] + rec["f"]["launches"][k]
                       + sum(r["launches"][k] for part in ("b", "c")
                             for r in rec[part].values())
                       for k in ("iir_sosfilt", "iir_sosfilt_rolldec")}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[zoo] phase {rec['phase_s']:.1f} s: forwards {rec['a_s']:.1f} s")
    print(json.dumps({"zoo": rec}, default=float))
    return rec["launches"]

# The command line (phase 15), in-process through ``cli.main`` on phase
# 13's tree at full width: float32 with TF32 off.  Fused against unfused
# predictions and both against ``entry.make_forward`` of the same weights
# within CLI_PROB_ATOL in every probability; the argmax equal wherever the
# top two differ by more than CLI_ARGMAX_GAP; LIME's ridge weights with
# the branch fused against unfused within CLI_LIME_REL of the largest
# |weight|.  The probabilities pass five spectrogram blocks of float32
# convolutions in other algorithms (the fused kernel's 3xTF32 against
# cuDNN), ~1e-6 apart on the card (phase 4 holds log-probs to 1e-3).
CLI_PROB_ATOL, CLI_ARGMAX_GAP, CLI_LIME_REL = 1e-3, 2e-3, 1e-3
CLI_BATCH = 256


class _Recorder:
    """Wrap ``getattr(obj, name)`` while the context is open, keeping every
    call's arguments and result in ``calls``."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls = obj, name, []

    def __enter__(self):
        self.orig = getattr(self.obj, self.name)

        def wrapped(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out
        setattr(self.obj, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)


class _LogLines(logging.Handler):
    """The records a logger emits while the context is open."""

    def __init__(self, name: str):
        super().__init__()
        self.logger = logging.getLogger(name)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _cli(args: list, reset, read, echo: bool = True) -> tuple:
    """``cli.main(args)`` with its standard output kept (and echoed), the
    launch counts set to 0 just before and read just after.  Returns (the
    output, the counts, the wall seconds); a non-zero exit fails."""
    import contextlib
    import io

    from multimodal_brain_pattern_identification_xai_tpu_torch import cli
    buf = io.StringIO()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    out = buf.getvalue()
    for line in out.splitlines() if echo else ():
        print(f"[cli]   | {line}")
    require(rc == 0, f"cli {args[0]} exited {rc}")
    return out, counts, wall


def _read_predictions(path: str):
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray([[float(v) for v in r[1:7]] for r in rows[1:]]
                               ), [r[7] for r in rows[1:]]


def phase_cli(card: str, dev, tmp: str) -> dict:
    """The command line on phase 13's tree (``tmp/hms``; its window cache
    and ``.npy`` planes linked into the checkpoint directory), at full
    width, through ``cli.main``:

    (a) ``train-multimodal --epochs 1 --one-fold --lime-every 1`` (fold 0:
        4 steps at B=256 and one LIME snapshot of 150 perturbations), then
        ``predict`` over every row at B=256 with ``--fused-spec 2`` and
        ``--fused-spec 0``, both held against ``entry.make_forward`` of the
        best checkpoint on the same rows; rows/s end to end, the forward's
        ms a batch and the snapshot's ms;
    (b) ``predict --eval`` and its metrics line;
    (c) ``xai --fused-spec 2 --limit 8``: LIME's ridge weights against the
        same ``lime_explain`` run with the branch unfused; each method's
        ms (``xai_report.json``);
    (d) ``sanity-check --epochs 5``; ``dump-config`` where PyYAML imports;
        without matplotlib the "plot skipped" lines in place of the images.

    Each command's launch counts are set to 0 just before it and read just
    after (a captured graph's replays run no wrapper: a capture counts its
    warm-up and captured calls).  Prints the ``{"cli": ...}`` line;
    returns the launches by kernel name summed over the commands."""
    import importlib.util

    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        cli, config as C, entry, xai)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        CheckpointManager)
    from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
        callbacks)
    reset, read = _counters()
    t_phase = time.perf_counter()
    tree, work = f"{tmp}/hms", _workdir(f"{tmp}/hms", f"{tmp}/cli")
    os.symlink(f"{tree}/npy", f"{work}/spectrograms_npy")
    base = ["--ckpt-dir", work, "--set", f"paths.data_root={tree}",
            "--seed", str(RD_SEED)]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    rec, launches = {"card": card, "matplotlib": has_mpl}, []

    # (a) -----------------------------------------------------------------
    snap_ms = []
    orig_call = callbacks.LimeEpochSnapshot.__call__

    def timed_call(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_call(self, *a)
        torch.cuda.synchronize()
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    callbacks.LimeEpochSnapshot.__call__ = timed_call
    try:
        with _LogLines(f"{PKG}.utils.plotting") as skipped:
            out, counts, wall = _cli(["train-multimodal", *base, "--epochs",
                                      "1", "--one-fold", "--lime-every", "1"],
                                     reset, read)
    finally:
        callbacks.LimeEpochSnapshot.__call__ = orig_call
    launches.append(counts)
    rec["a_train"] = {"wall_s": wall, "lime_snapshot_ms": snap_ms,
                      "launches": counts}
    require("lime snapshots: 1" in out and len(snap_ms) == 1,
            "(a) train-multimodal: no LIME snapshot")
    require(has_mpl or any("multimodal_training_curves" in m
                           for m in skipped.lines),
            f"(a) no plot-skipped line: {skipped.lines}")

    src, _, _ = entry.multimodal_fold0(tree, work, RD_SEED,
                                       npy_dir=f"{tree}/npy")
    n = len(src)
    best = CheckpointManager(f"{work}/multimodal").load("best-kldiv")["model"]
    model = entry.build_model()
    model.load_state_dict(best)
    ref_fwd = entry.make_forward(model.to(dev), assume_finite=True)
    want = []
    for b in src.batches(np.arange(n), CLI_BATCH, drop_last=False):
        want.append(ref_fwd(torch.from_numpy(b["eeg"]).to(dev),
                            torch.from_numpy(b["spec"]).to(dev)
                            ).exp().cpu().numpy())
    want = np.concatenate(want)
    del model
    got, rates = {}, {}
    for fused in (2, 0):
        out, counts, wall = _cli(["predict", *base, "--fused-spec",
                                  str(fused)], reset, read)
        launches.append(counts)
        header, probs, names = _read_predictions(f"{work}/predictions.csv")
        m = re.search(r"predict: (\d+) rows in ([\d.]+) s \(([\d.]+) rows/s"
                      r".*forward ([\d.]+) ms a batch", out)
        require(m is not None and int(m.group(1)) == n,
                f"(a) predict --fused-spec {fused}: no rate line")
        rates[fused] = {"rows_per_s": float(m.group(3)),
                        "forward_ms_a_batch": float(m.group(4)),
                        "loop_s": float(m.group(2)), "wall_s": wall,
                        "launches": counts}
        got[fused] = probs
        require(header == ["eeg_id", *(f"p_{c}" for c in C.CLASSES),
                           "predicted_class"] and probs.shape == (n, 6)
                and np.isfinite(probs).all(),
                f"(a) predict --fused-spec {fused}: {header} {probs.shape}")
    top2 = np.sort(want, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > CLI_ARGMAX_GAP
    errs = {f"fused{k}_vs_make_forward": float(np.abs(v - want).max())
            for k, v in got.items()}
    errs["fused2_vs_fused0"] = float(np.abs(got[2] - got[0]).max())
    same_argmax = all(bool((v.argmax(1) == want.argmax(1))[clear].all())
                      for v in got.values())
    rec["a_predict"] = {**rates, "max_abs_err": errs,
                        "argmax_equal_where_clear": same_argmax,
                        "clear_rows": int(clear.sum())}
    print(f"[cli] (a) train-multimodal (fold 0, 1 epoch, B={CLI_BATCH}, "
          f"LIME snapshot {snap_ms[0]:.1f} ms) {rec['a_train']['wall_s']:.2f}"
          f" s; predict over {n} rows at B={CLI_BATCH}: --fused-spec 2 "
          f"{rates[2]['rows_per_s']:.1f} rows/s end to end, forward "
          f"{rates[2]['forward_ms_a_batch']:.3f} ms a batch; --fused-spec 0 "
          f"{rates[0]['rows_per_s']:.1f} rows/s, "
          f"{rates[0]['forward_ms_a_batch']:.3f} ms; probabilities max abs "
          f"{errs} (bound {CLI_PROB_ATOL}); argmax equal on the "
          f"{int(clear.sum())} rows whose top two differ by > "
          f"{CLI_ARGMAX_GAP}: {same_argmax} [{card}]")
    require(max(errs.values()) < CLI_PROB_ATOL and same_argmax,
            f"(a) predictions differ: {errs}, argmax {same_argmax}")

    # (b) -----------------------------------------------------------------
    with _LogLines(f"{PKG}.utils.plotting") as skipped:
        out, counts, wall = _cli(["predict", *base, "--fused-spec", "2",
                                  "--eval"], reset, read)
    launches.append(counts)
    m = re.search(r"eval over \d+ rows: .*", out)
    require(m is not None, "(b) predict --eval: no metrics line")
    rec["b"] = {"metrics": m.group(0), "wall_s": wall, "launches": counts}
    require(has_mpl or any("confusion_matrix" in x for x in skipped.lines),
            f"(b) no plot-skipped line: {skipped.lines}")

    # (c) -----------------------------------------------------------------
    # LIME's forwards: the model's share of its perturbed passes, timed
    # inside the predict function the command builds
    orig_pf, lime_models, model_ms = callbacks.spectrogram_predict_fn, [], []

    def timed_pf(model, device):
        lime_models.append(model)
        inner = orig_pf(model, device)

        def predict(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(batch)
            model_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return predict
    callbacks.spectrogram_predict_fn = timed_pf
    try:
        with _Recorder(xai, "lime_explain") as lime:
            out, counts, wall = _cli(["xai", *base, "--fused-spec", "2",
                                      "--limit", "8"], reset, read)
    finally:
        callbacks.spectrogram_predict_fn = orig_pf
    launches.append(counts)
    with open(f"{work}/xai_report.json") as f:
        report = json.load(f)
    (_, img), kw, res = lime.calls[0]
    fused_model = lime_models[0]
    unfused = entry.build_model(fused_blocks=0)
    unfused.load_state_dict(fused_model.state_dict())
    unfused.to(dev).requires_grad_(False)
    ref = xai.lime_explain(callbacks.spectrogram_predict_fn(unfused, dev),
                           img, segments=kw["segments"],
                           num_samples=kw["num_samples"], seed=kw["seed"])
    scale = float(np.abs(ref["weights"]).max())
    lime_err = float(np.abs(res["weights"] - ref["weights"]).max()) / scale
    rec["c"] = {**report, "lime_weights_rel_err": lime_err,
                "lime_label_unfused": ref["label"], "wall_s": wall,
                "lime_model_ms": sum(model_ms), "launches": counts}
    print(f"[cli] (c) xai --fused-spec 2 --limit 8: times (ms) "
          f"{report['times_ms']}, of LIME's forwards the model's "
          f"{sum(model_ms):.1f} ms ({len(model_ms)} calls, host images to "
          f"probabilities); LIME label {res['label']} (unfused "
          f"{ref['label']}), ridge weights fused vs unfused max abs "
          f"{lime_err:.3e} of the largest (bound {CLI_LIME_REL}); "
          f"{wall:.2f} s [{card}]")
    require(lime_err < CLI_LIME_REL and res["label"] == ref["label"]
            and report["explained"] == 8,
            f"(c) LIME fused vs unfused: {lime_err}, labels {res['label']} "
            f"{ref['label']}")
    del unfused, fused_model, lime, lime_models

    # (d) -----------------------------------------------------------------
    with _LogLines(f"{PKG}.utils.plotting") as skipped:
        out, counts, wall = _cli(["sanity-check", "--ckpt-dir", work,
                                  "--epochs", "5"], reset, read)
    mse = [float(v) for v in re.findall(r"mse ([\d.]+)", out)]
    rec["d"] = {"sanity_mse": mse, "wall_s": wall}
    require(len(mse) == 2 and all(np.isfinite(mse)) and mse[1] < mse[0],
            f"(d) sanity-check: {mse}")
    shots = [f"sanity_recon_epoch{e}" for e in (0, 4)]
    require(all(os.path.exists(f"{work}/{s}.png") for s in shots) if has_mpl
            else all(any(s in x for x in skipped.lines) for s in shots),
            f"(d) sanity-check images: {skipped.lines}")
    if importlib.util.find_spec("yaml") is not None:
        out, _, _ = _cli(["dump-config", "--set",
                          f"paths.data_root={tree}"], reset, read, echo=False)
        require(f"data_root: {tree}" in out, "(d) dump-config")
        rec["d"]["dump_config"] = "printed"
    else:
        rec["d"]["dump_config"] = "skipped: no PyYAML"
    print(f"[cli] (d) sanity-check --epochs 5: mse {mse}; dump-config "
          f"{rec['d']['dump_config']}; matplotlib "
          f"{'present' if has_mpl else 'absent (plot-skipped lines held)'}")

    # (e) -----------------------------------------------------------------
    rec["launches"] = {k: sum(c[k] for c in launches) for k in launches[0]}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[cli] (e) launches over the commands {rec['launches']}; phase "
          f"{rec['phase_s']:.1f} s")
    print(json.dumps({"cli": rec}, default=float))
    require(rec["launches"]["iir_sosfilt_rolldec"] > 0
            and rec["launches"]["specblock_convpool"] > 0,
            f"(e) launches {rec['launches']}")
    return rec["launches"]


# ---------------------------------------------------------------------------
# Parallel (phase 16): every parallel program of the port on a world of
# each size in PAR_WORLDS that the visible cards hold (NCCL, one card a
# rank; a world of one runs in this process).  Multimodal DP training at
# B=256, three steps, and at B=256 a card on the largest world; the
# full-width WaveNet's SGD step; the long-EEG encoder over one hour of
# 200-Hz EEG; sharded attribution at B=8; DiffEEG DP at full width; the
# command line's ``--mesh N``.
PAR_WORLDS = (1, 2, 4)
PAR_B, PAR_STEPS, PAR_XAI_B = 256, 3, 8
LONG_T = 200 * 3600              # one hour at 200 Hz: 3,600 patches of 200
# sharded vs unsharded attribution, relative to the unsharded max |value|;
# above one rank the spectrogram branch's whole batch, normwise (ReLU /
# max-pool ties where a rank's rows run other cuDNN shapes than the whole
# batch's: 1.15e-3-1.74e-3 read on four H100s)
PAR_XAI_REL, PAR_XAI_NORM = 1e-6, 5e-3
# rollout logits vs the single-card forward, rollout rows' sums vs 1
LONG_LOGIT_REL, LONG_ROW_ATOL = 1e-4, 1e-4
# the mesh step's loss vs the single-device replay, times max(1, |loss|)
PAR_REPLAY_REL = 1e-5
# a data-parallel step vs the single-device step (tests/test_parallel.py's
# bounds): the loss (absolute), the parameters (rtol, atol)
PAR_LOSS_ATOL, PAR_RTOL, PAR_ATOL = 1e-5, 2e-4, 1e-5
# the WaveNet step's global batch and window; DiffEEG's micro-batches,
# steps held against the single device, warm steps timed after them
PAR_WN_B, PAR_WN_L, PAR_DIFF_K, PAR_DIFF_STEPS = 16, 10_000, 4, 2
PAR_DIFF_TIMED = 5
# the halo conv over seq ranks: kernel sizes; its error vs the unsharded
# conv, forward and input gradient, relative to the unsharded max
PAR_HALO_K, PAR_HALO_REL = (3, 5, 7, 9), 1e-5
# the JAX dry run's mesh (data, model, seq) of each world
# (``__graft_entry__.py:161-166``)
PAR_MESHES = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 2, 2)}


def _par_launches(reset, read, fused):
    """(reset, read) of the kernel counters plus the fused block's VJP
    calls (#3', counted as ``specblock_convpool_vjp``)."""
    def reset_all():
        reset()
        fused.backward_calls = 0

    def read_all():
        return {**read(), "specblock_convpool_vjp": fused.backward_calls}
    return reset_all, read_all


def _par_counters():
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    return _par_launches(*_counters(), cuda_specblock.fused_specblock_convpool)


def _flat_state(model):
    return torch.cat([t.detach().reshape(-1).float()
                      for t in model.state_dict().values()
                      if t.is_floating_point()])


def _excess(got, want) -> float:
    """max(|got − want| − (PAR_ATOL + PAR_RTOL·|want|)): ≤ 0 where
    ``assert_allclose(got, want, PAR_RTOL, PAR_ATOL)`` holds."""
    return float(((got - want).abs()
                  - (PAR_ATOL + PAR_RTOL * want.abs())).max())


@contextlib.contextmanager
def _backend_flags(deterministic: bool):
    """cuDNN deterministic or not, TF32 off, restored on exit (a world of
    one runs in this process)."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _par_rank(dev, world: int, weak: bool) -> dict:
    """One rank of phase 16's world, on two meshes made once (``data`` of
    every rank; ``seq`` of every rank): the numerics flags the rank was
    started with; above one rank the halo conv under those flags; (a)
    data-parallel training, compared with
    deterministic cuDNN, timed with its usual algorithms (``weak``: also
    at PAR_B rows a card); (c) long EEG; (d) sharded attribution; (e)
    DiffEEG data parallel."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, parallel)
    flags = parallel.launch._flags()
    mesh = parallel.make_mesh(C.MeshConfig(data=world), dev)
    seq = parallel.make_mesh(C.MeshConfig(data=1, model=1, seq=world), dev)
    halo = _par_halo(dev, seq) if world > 1 else {}
    with _backend_flags(True):
        a = _par_train_compare(dev, mesh)
    torch.cuda.empty_cache()
    with _backend_flags(False):
        a.update(_par_train_time(dev, mesh, weak))
        torch.cuda.empty_cache()
        c = _par_long_eeg_run(dev, seq)
    torch.cuda.empty_cache()
    with _backend_flags(True):
        d = _par_xai_run(dev, mesh)
        torch.cuda.empty_cache()
        e = _par_diffeeg(dev, mesh)
    return {"flags": flags, "halo": halo, "a": a, "c": c, "d": d, "e": e}


def _par_train_setup(dev, tile: int = 1):
    """(batches(), trainer(mesh or None)) of (a): PAR_STEPS batches of
    PAR_B raw windows, each ``tile`` times over, preprocessed on the rank
    (NaN route) as they are drawn."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
        synthetic_raw_eeg, synthetic_raw_spectrogram)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        Trainer, TrainerConfig, create_train_state,
        initialize_kaiming_weights, make_optimizer)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.steps \
        import fold_in
    rng = np.random.default_rng(RD_SEED)
    raw = []
    for _ in range(PAR_STEPS):
        votes = rng.random((PAR_B, 6))
        raw.append(tuple(torch.as_tensor(a).to(dev).repeat(
            (tile,) + (1,) * (a.ndim - 1)) for a in (
            synthetic_raw_eeg(PAR_B, rng), synthetic_raw_spectrogram(PAR_B, rng),
            (votes / votes.sum(1, keepdims=True)).astype(np.float32))))

    def batches():
        for e, s, y in raw:
            yield entry.preprocess_batch(e, s, y, assume_finite=False)

    def trainer(m):
        model = entry.build_train_model()
        initialize_kaiming_weights(model, torch.Generator().manual_seed(0))
        state = create_train_state(model.to(dev), make_optimizer(1e-3))
        t = Trainer(state, TrainerConfig(epochs=1, seed=0, l2_lambda=TRAIN_L2),
                    mesh=m)
        if m is None:
            t.rng = fold_in(t.rng, 0, torch.device("cpu"))
        return t
    return batches, trainer


def _par_run(t, batches, steps: int = PAR_STEPS):
    """(mean loss, ms a step) of one epoch over ``batches()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = t.train_epoch(batches(), 0)
    torch.cuda.synchronize()
    return loss, (time.perf_counter() - t0) * 1e3 / steps


def _par_train_compare(dev, mesh) -> dict:
    """(a) PAR_STEPS steps of ``Trainer(mesh=...)`` (its first step's loss
    kept), then the same steps without a mesh (generator rank 0's,
    ``fold_in(rng, 0)``); at a world above one also the first step's loss
    replayed on this card (``replay_dp_loss_single_device``: each shard's
    dropout and BatchNorm statistics) and the WaveNet step (:func:`_par_
    wavenet`)."""
    import torch.distributed as dist

    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        train as ptrain)
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel.mesh \
        import axis_size
    world = axis_size(mesh, "data")
    reset, read = _par_counters()
    batches, trainer = _par_train_setup(dev)
    run = lambda t: _par_run(t, batches)
    t_mesh = trainer(mesh)
    before = ptrain.copy_state(t_mesh.state)
    log = _FirstLoss()
    t_mesh.loggers = [log]
    reset()
    loss_m, _ = run(t_mesh)
    counts = read()
    t_single = trainer(None)
    loss_s, _ = run(t_single)
    a, b = _flat_state(t_mesh.state.model), _flat_state(t_single.state.model)
    out = {"loss_mesh": loss_m, "loss_single": loss_s, "counts": counts,
           "bitwise": bool(torch.equal(a, b)),
           "max_abs_vs_single": float((a - b).abs().max()),
           "scale": float(b.abs().max())}
    ref = a.clone()
    dist.broadcast(ref, 0)
    spread = (a - ref).abs().max()
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    out["max_abs_across_ranks"] = float(spread)
    if world > 1:
        out["first_loss_mesh"] = log.losses[0]
        out["first_loss_replay"] = float(ptrain.replay_dp_loss_single_device(
            before, next(batches()), t_mesh.rng, world, l2_lambda=TRAIN_L2))
        del before, t_mesh, t_single
        out["wavenet"] = _par_wavenet(dev, mesh)
    return out


def _par_wavenet(dev, mesh) -> dict:
    """One SGD step (lr 1e-2) of the full-width ``DilatedInceptionWaveNet``
    (no BatchNorm, no dropout) on PAR_WN_B windows of PAR_WN_L samples,
    data parallel and on this card alone."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        entry, parallel, train)
    rng = np.random.default_rng(RD_SEED)
    votes = rng.random((PAR_WN_B, 6))
    batch = {"x": torch.as_tensor(rng.standard_normal(
                 (PAR_WN_B, PAR_WN_L, 8)).astype(np.float32)).to(dev),
             "y": torch.as_tensor((votes / votes.sum(1, keepdims=True)
                                   ).astype(np.float32)).to(dev)}
    state = lambda: train.create_train_state(
        entry.wavenet_model(RD_SEED).to(dev),
        train.make_optimizer(1e-2, optimizer="sgd"))
    key = torch.Generator().manual_seed(1)
    single, ma = train.make_train_step()(state(), batch, key)
    dp = state()
    dp, mb = parallel.make_parallel_train_step(mesh, dp)(
        dp, parallel.shard_batch(mesh, batch), key)
    a, b = _flat_state(dp.model), _flat_state(single.model)
    return {"loss_dp": float(mb["loss"]), "loss_single": float(ma["loss"]),
            "max_abs": float((a - b).abs().max()), "excess": _excess(a, b)}


def _par_train_time(dev, mesh, weak: bool) -> dict:
    """(a) timed with cuDNN's usual algorithms, each trainer warmed by a
    step first: ms a step on the mesh and without, preprocessing included; the mesh's step alone on batches
    preprocessed before; its device idle share (profiler over 2 steps);
    the all-reduce of the step's flat vector alone over ``data`` and over
    the default group, the ranks met at a barrier first; with ``weak``
    the mesh's steps again at PAR_B rows a card."""
    import torch.distributed as dist

    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel.mesh \
        import axis_size
    world = axis_size(mesh, "data")
    batches, trainer = _par_train_setup(dev)
    _par_run(trainer(None), batches)     # cuDNN's usual algorithms' first use
    t_mesh = trainer(mesh)
    # the mesh trainer's first step at the rank's shapes, untimed
    _par_run(t_mesh, lambda: itertools.islice(batches(), 1), 1)
    out = {"ms_mesh": _par_run(t_mesh, batches)[1],
           "ms_single": _par_run(trainer(None), batches)[1]}
    pre = list(batches())
    out["ms_step"] = _par_run(t_mesh, lambda: iter(pre))[1]
    dist.barrier()
    prof = profiling.profile_kernels(
        lambda: t_mesh.train_epoch(iter(pre[:1]), 0), reps=2, warmup=0)
    # NCCL's kernels count as busy while they wait for the other ranks
    out["idle"] = max(0.0, 1.0 - prof.busy_ms / prof.wall_ms)
    out["busy_ms"], out["wall_ms"] = prof.busy_ms, prof.wall_ms
    out["nccl_kernel_ms"] = sum(v for k, v in prof.kernel_ms.items()
                                if "nccl" in k.lower())
    model = t_mesh.state.model
    n = 1 + sum(p.numel() for p in model.parameters()) + sum(
        t.numel() for t in model.buffers() if t.is_floating_point())
    vec = torch.zeros(n, device=dev)
    for key, group in (("allreduce_ms", mesh.get_group("data")),
                       ("allreduce_default_group_ms", None)):
        dist.barrier()
        out[key] = cuda_ms(lambda: dist.all_reduce(vec, group=group), 50,
                           warmup=5)
    out["allreduce_bytes"] = 4 * n
    out["grad_bytes"] = 4 * sum(p.numel() for p in model.parameters())
    del t_mesh, pre
    if weak:
        torch.cuda.empty_cache()
        batches, trainer = _par_train_setup(dev, tile=world)
        t = trainer(mesh)
        pre = list(batches())
        _par_run(t, lambda: iter(pre[:1]), 1)      # the PAR_B-row shapes
        out["weak"] = {"global_b": PAR_B * world,
                       "ms_mesh": _par_run(t, batches)[1],
                       "ms_step": _par_run(t, lambda: iter(pre))[1]}
    return out


def _par_long_eeg_run(dev, mesh) -> dict:
    """(c) the full-width encoder over B=2 windows of LONG_T samples split
    over a seq axis of every rank, rollout included (timed on its second
    call), against the encoder's single-card forward of the whole
    sequence; this card's peak memory."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import parallel
    enc = parallel.LongEEGEncoder(
        n_channels=20, patch=200, d_model=128, depth=4, n_heads=4,
        generator=torch.Generator().manual_seed(RD_SEED)).to(dev)
    x = signal((2, 20, LONG_T), 1.0, RD_SEED, dev)
    parallel.long_eeg_rollout(enc, None, x, mesh)      # a rank's first call
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, roll = parallel.long_eeg_rollout(enc, None, x, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with torch.no_grad():
        ref = enc.local_forward(x, None)
    return {"ms": ms, "peak_gib": peak, "logit_rel": rel(logits, ref),
            "row_err": float((roll.sum(-1) - 1).abs().max()),
            "rollout": tuple(roll.shape), "finite": bool(
                torch.isfinite(logits).all() and torch.isfinite(roll).all())}


def _par_halo(dev, mesh) -> dict:
    """``halo_conv1d`` over the seq axis against the unsharded 'SAME'
    conv on the whole sequence: this rank's part of the output and of the
    input gradient, by kernel size (an odd K, as the JAX function takes)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        mesh as mesh_lib, seqparallel)
    group = mesh.get_group("seq")
    n, s = mesh_lib.axis_size(mesh, "seq"), mesh_lib.axis_index(mesh, "seq")
    tl = 256
    part = slice(s * tl, (s + 1) * tl)
    out = {}
    for k in PAR_HALO_K:
        gen = torch.Generator().manual_seed(k)
        x = torch.randn(2, tl * n, 16, generator=gen).to(dev)
        kern = torch.randn(k, 16, 8, generator=gen).to(dev)
        w = torch.randn(2, tl * n, 8, generator=gen).to(dev)
        xl = x[:, part].clone().requires_grad_(True)
        y = seqparallel.halo_conv1d(xl, kern, group)
        (y * w[:, part]).sum().backward()
        xr = x.clone().requires_grad_(True)
        yr = seqparallel.halo_conv1d(xr, kern, None)
        (yr * w).sum().backward()
        out[k] = max(rel(y.detach(), yr.detach()[:, part]),
                     rel(xl.grad, xr.grad[:, part]))
    return out


def _par_xai_run(dev, mesh) -> dict:
    """(d) sharded IG and gradient SHAP at B=PAR_XAI_B over the EEG branch
    (the CLI's xai) and over the fused spectrogram forward (#3 and its
    VJP), against the unsharded functions on the same inputs and draws
    (deterministic cuDNN); launches read around the first sharded run;
    both timed in a second run.  Above one rank also this rank's rows of
    the result against the unsharded arithmetic run on those rows alone
    (:func:`_par_rows_ref`), and the whole-batch differences normwise."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        parallel, xai)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        explain_entry)
    world = parallel.mesh.axis_size(mesh, "data")
    reset, read = _par_counters()
    sl = parallel.mesh.data_slice(mesh, PAR_XAI_B)
    model, (eeg, spec) = explain_entry(device=dev, batch=PAR_XAI_B)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    runs = {
        "eeg": (model.forward_eeg, eeg, 32, 16, None),
        "spectrogram": (model.forward_spectrogram, spec, 8, 4, 4),
    }
    out, counts = {}, []
    for name, (fwd, x, steps, ns, chunk) in runs.items():
        bg = x.flip(0)

        def sharded():
            return (xai.sharded_integrated_gradients(
                        mesh, fwd, x, steps=steps, chunk=chunk),
                    xai.sharded_gradient_shap_values(
                        mesh, fwd, x, bg, gen(), nsamples=ns, chunk=chunk))

        def unsharded():
            return (xai.integrated_gradients(fwd, x, steps=steps, chunk=chunk),
                    xai.gradient_shap_values(fwd, x, bg, gen(), nsamples=ns,
                                             chunk=chunk))

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        reset()
        ig, sv = sharded()
        torch.cuda.synchronize()
        counts.append(read())
        ig_u, sv_u = unsharded()
        out[name] = {"ms_sharded": timed(sharded),
                     "ms_unsharded": timed(unsharded),
                     "ig_rel": rel(ig, ig_u), "shap_rel": rel(sv, sv_u),
                     "steps": steps, "nsamples": ns,
                     "shap_shape": tuple(sv.shape)}
        if world > 1:
            ig_r, sv_r = _par_rows_ref(fwd, x, bg, gen(), steps, ns, chunk,
                                       sl)
            out[name].update(rows_ig_rel=rel(ig[sl], ig_r),
                             rows_shap_rel=rel(sv[:, sl], sv_r),
                             ig_norm_rel=norm_rel(ig, ig_u),
                             shap_norm_rel=norm_rel(sv, sv_u))
    out["counts"] = {k: sum(c[k] for c in counts) for k in counts[0]}
    return out


def _par_rows_ref(fwd, x, bg, gen, steps, nsamples, chunk, rows):
    """The unsharded IG and gradient SHAP arithmetic on ``x[rows]`` alone,
    at the shapes one rank runs: IG of those rows; SHAP from each class's
    draws over the whole batch (taken from ``gen`` in class order, as
    ``gradient_shap_values`` takes them), their columns ``rows``."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import xai
    ig = xai.integrated_gradients(fwd, x[rows], steps=steps, chunk=chunk)
    sv = []
    for c in range(6):
        bg_idx, alphas = xai.sample_draws(nsamples, x.shape[0], bg.shape[0],
                                          gen)
        tgt = torch.full((rows.stop - rows.start,), c, device=x.device)
        sv.append(xai.expected_gradients_from_draws(
            fwd, x[rows], bg, tgt, bg_idx[:, rows], alphas[:, rows], chunk))
    return ig, torch.stack(sv)


def _par_diffeeg(dev, mesh) -> dict:
    """(e) ``DiffEEGTrainer(mesh=..., decorrelate_shards=False)`` at
    ``DiffEEGConfig()``'s width, PAR_DIFF_STEPS steps of K=PAR_DIFF_K
    micro-batches of its B rows tiled ``world`` times over ``data`` (each
    rank's rows are the single device's batch), against the trainer
    without a mesh on that batch; ms a step of each, in those steps and
    in PAR_DIFF_TIMED warm steps after them."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, entry, parallel)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train import (
        DiffEEGTrainer)
    cfg = dataclasses.replace(C.DiffEEGConfig(),
                              gradient_accumulate_every=PAR_DIFF_K)
    world = parallel.mesh.axis_size(mesh, "data")
    cfg_dp = dataclasses.replace(cfg, batch_size=cfg.batch_size * world)
    xs, ys = _diff_batch(31, (PAR_DIFF_K, cfg.batch_size, cfg.n_channels,
                              cfg.input_length), dev)
    xt, yt = xs.repeat(1, world, 1, 1), ys.repeat(1, world, 1)
    single = DiffEEGTrainer(entry.diffeeg_model(cfg, 6), cfg, seed=6,
                            device=dev)
    dp = DiffEEGTrainer(entry.diffeeg_model(cfg_dp, 6), cfg_dp, seed=6,
                        device=dev, mesh=mesh, decorrelate_shards=False)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(fn()["loss"])
        return loss, (time.perf_counter() - t0) * 1e3
    ms_single, ms_dp = [], []
    for _ in range(PAR_DIFF_STEPS):
        la, t = timed(lambda: single.train_step(xs, ys))
        ms_single.append(t)
        lb, t = timed(lambda: dp.train_step(xt, yt))
        ms_dp.append(t)
    a, b = _flat_state(dp.model), _flat_state(single.model)
    out = {"loss_dp": lb, "loss_single": la, "ms_dp": ms_dp,
           "ms_single": ms_single, "k": PAR_DIFF_K, "b": cfg.batch_size,
           "params_max_abs": float((a - b).abs().max()),
           "params_excess": _excess(a, b),
           "ema_excess": _excess(dp.state.ema, single.state.ema)}
    del a, b
    warm_single, warm_dp = [], []
    for _ in range(PAR_DIFF_TIMED):
        warm_single.append(timed(lambda: single.train_step(xs, ys))[1])
        warm_dp.append(timed(lambda: dp.train_step(xt, yt))[1])
    out.update(ms_dp_warm=warm_dp, ms_single_warm=warm_single)
    return out


@contextlib.contextmanager
def _fd_stdout(path: str):
    """This process's standard output, at the descriptor (which spawned
    ranks inherit), into ``path`` while the block runs."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _cli_ranks(args: list, tmp: str) -> tuple:
    """``cli.main(args)`` with what it and its ranks print kept (and
    echoed); a non-zero exit fails.  Returns (output, wall seconds)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import cli
    path = f"{tmp}/stdout.txt"
    t0 = time.perf_counter()
    with _fd_stdout(path):
        rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(path) as f:
        out = f.read()
    for line in out.splitlines():
        print(f"[parallel]   | {line}")
    require(rc == 0, f"cli {' '.join(args)} exited {rc}")
    return out, wall


def _par_cli(card: str, tmp: str, world: int, ref, n_train: int) -> dict:
    """(f) the command line at ``--mesh world`` on phase 13's tree:
    ``predict`` over phase 15's checkpoint, against phase 15's one-card
    predictions ``ref``; ``train-multimodal`` one epoch of fold 0 at
    B=256 from fresh weights (``n_train`` windows)."""
    tree = f"{tmp}/hms"
    base = ["--set", f"paths.data_root={tree}", "--seed", str(RD_SEED),
            "--mesh", str(world)]
    out, wall = _cli_ranks(["predict", "--ckpt-dir", f"{tmp}/cli", *base,
                            "--fused-spec", "2"], tmp)
    _, probs, _ = _read_predictions(f"{tmp}/cli/predictions.csv")
    m = re.search(r"predict: (\d+) rows in ([\d.]+) s \(([\d.]+) rows/s"
                  r".*forward ([\d.]+) ms a batch", out)
    require(m is not None and int(m.group(1)) == len(ref)
            and f"serving over a {world}-device data mesh" in out,
            f"(f) predict --mesh {world}: no mesh or rate line")
    top2 = np.sort(ref, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > CLI_ARGMAX_GAP
    rec = {"predict": {
        "rows_per_s": float(m.group(3)), "forward_ms_a_batch":
        float(m.group(4)), "wall_s": wall,
        "max_abs_vs_one_card": float(np.abs(probs - ref).max()),
        "argmax_equal_where_clear": bool(
            (probs.argmax(1) == ref.argmax(1))[clear].all()),
        "clear_rows": int(clear.sum())}}
    p = rec["predict"]
    print(f"[parallel] world {world}: (f) predict --mesh {world} over "
          f"{len(ref)} rows at B={CLI_BATCH}: {p['rows_per_s']:.1f} rows/s "
          f"end to end, forward {p['forward_ms_a_batch']:.3f} ms a batch "
          f"of {CLI_BATCH // world} rows a rank; probabilities vs one card "
          f"max abs {p['max_abs_vs_one_card']:.3e} (bound {CLI_PROB_ATOL}), "
          f"argmax equal on the {p['clear_rows']} clear rows: "
          f"{p['argmax_equal_where_clear']}; {wall:.2f} s [{card}]")
    require(probs.shape == ref.shape
            and p["max_abs_vs_one_card"] < CLI_PROB_ATOL
            and p["argmax_equal_where_clear"], f"(f) predict: {p}")
    work = _workdir(tree, f"{tmp}/par_cli{world}")
    os.symlink(f"{tree}/npy", f"{work}/spectrograms_npy")
    out, wall = _cli_ranks(["train-multimodal", "--ckpt-dir", work, *base,
                            "--epochs", "1", "--one-fold"], tmp)
    require("best kldiv:" in out
            and f"training over a {world}-device data mesh" in out,
            f"(f) train-multimodal --mesh {world}: {out!r}")
    rec["train"] = {"wall_s": wall, "windows": n_train,
                    "windows_per_s": n_train / wall}
    print(f"[parallel] world {world}: (f) train-multimodal --mesh {world}, "
          f"fold 0, one epoch at B={CLI_BATCH} ({n_train} windows): "
          f"{wall:.2f} s = {n_train / wall:.1f} training windows/s end to "
          f"end (start-up, validation and checkpoints included) [{card}]")
    return rec


def _par_multihost(world: int) -> dict:
    """``initialize_multihost`` in ``world`` processes of this host with a
    coordinator address and no ``LOCAL_RANK``: each must take a card of
    its own and sum the ranks over NCCL."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (
        "import json, sys, torch, torch.distributed as dist\n"
        f"from {PKG}.parallel import initialize_multihost\n"
        "i, n, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]\n"
        "initialize_multihost(coordinator_address=addr, num_processes=n, "
        "process_id=i, device='cuda')\n"
        "t = torch.full((1,), float(i + 1), device='cuda')\n"
        "dist.all_reduce(t)\n"
        "print(json.dumps({'rank': dist.get_rank(), 'card': "
        "torch.cuda.current_device(), 'sum': float(t)}))\n"
        "dist.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items() if k not in (
        "LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), str(world), f"localhost:{port}"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(p.returncode == 0 for p in procs),
            "(g) initialize_multihost: " + " | ".join(
                err[-2000:] for p, (_, err) in zip(procs, outs)
                if p.returncode))
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    return {"ranks": ranks, "wall_s": time.perf_counter() - t0}


def _smi(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def _topology() -> str:
    """``nvidia-smi topo -m``, or where the machine refuses it, its message
    and each card's NVLink links and their speeds (``nvlink -s``)."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    if topo.returncode == 0:
        return topo.stdout.strip()
    links, gpu = {}, None
    for line in _smi("nvlink", "-s").splitlines():
        if line.startswith("GPU"):
            gpu = line.split(":")[0]
            links[gpu] = []
        elif gpu and "Link" in line:
            links[gpu].append(line.split(":")[-1].strip())
    return (f"topo -m: {(topo.stdout + topo.stderr).strip()!r}; nvlink -s: "
            + "; ".join(f"{g} {len(v)} links at {sorted(set(v))}"
                        for g, v in links.items()))


def _par_world(card: str, tmp: str, world: int, weak: bool, cli_ref):
    """Phase 16 at a world of ``world`` ranks: (a), (c), (d), (e) in one
    spawn, then (b), and (f) above one rank.  Returns (its record, the
    launches by kernel summed over the ranks' runs that can be read)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        launch)
    reset, read = _par_counters()
    tag = f"[parallel] world {world}:"
    t0 = time.perf_counter()
    res = launch.spawn(_par_rank, world, "cuda", (world, weak))
    rec = {"ranks_s": time.perf_counter() - t0}
    a, c, dd, e = (res[0][k] for k in "acde")
    flags = launch._flags()
    require(all(r["flags"] == flags for r in res),
            f"the ranks' numerics flags {[r['flags'] for r in res]} are not "
            f"this process's {flags}")
    launches = [r["a"]["counts"] for r in res] + [
        r["d"]["counts"] for r in res]

    # (a) ------------------------------------------------------------------
    rec["a"] = {k: v for k, v in a.items() if k != "counts"}
    rec["a"]["launches"] = {k: sum(r["a"]["counts"][k] for r in res)
                            for k in a["counts"]}
    rec["a"]["windows_per_s"] = PAR_B / a["ms_step"] * 1e3
    for key in ("allreduce_ms", "allreduce_default_group_ms"):
        # bus bandwidth: 2(n-1)/n of the bytes over the time (0 on one rank)
        rec["a"][key.replace("ms", "busbw_gb_per_s")] = (
            2 * (world - 1) / world * a["allreduce_bytes"] / a[key] / 1e6)
    print(f"{tag} (a) Trainer(mesh) multimodal f32, B={PAR_B} global, "
          f"{PAR_STEPS} steps: {a['ms_mesh']:.3f} ms a step on the mesh, "
          f"{a['ms_single']:.3f} ms without (preprocessing of all {PAR_B} "
          f"rows on each rank included); the mesh's step alone "
          f"{a['ms_step']:.3f} ms = {rec['a']['windows_per_s']:.1f} training "
          f"windows/s, device idle {100 * a['idle']:.1f} % (NCCL kernels "
          f"{a['nccl_kernel_ms']:.3f} ms a step); all-reduce of the step's "
          f"flat vector ({a['allreduce_bytes']} B, gradients "
          f"{a['grad_bytes']} B) over data {a['allreduce_ms']:.4f} ms = bus "
          f"{rec['a']['allreduce_busbw_gb_per_s']:.1f} GB/s, over the default "
          f"group {a['allreduce_default_group_ms']:.4f} ms = "
          f"{rec['a']['allreduce_default_group_busbw_gb_per_s']:.1f} GB/s; "
          f"loss {a['loss_mesh']:.6f} "
          f"vs {a['loss_single']:.6f}; params + BN buffers "
          f"{'bitwise equal' if a['bitwise'] else 'max abs ' + str(a['max_abs_vs_single'])}"
          f" to the single-device run, {a['max_abs_across_ranks']:.3g} "
          f"across ranks; launches {rec['a']['launches']} [{card}]")
    if "weak" in a:
        w = a["weak"]
        print(f"{tag} (a) at {PAR_B} rows a card (B={w['global_b']} "
              f"global): {w['ms_mesh']:.3f} ms a step (preprocessing of "
              f"all rows included), {w['ms_step']:.3f} ms the step alone = "
              f"{w['global_b'] / w['ms_step'] * 1e3:.1f} training "
              f"windows/s [{card}]")
    if world == 1:
        require(a["bitwise"], f"(a) DP at a world of one differs from the "
                f"single-device run: {a['max_abs_vs_single']}")
    else:
        wn = a["wavenet"]
        print(f"{tag} (a) first step's loss {a['first_loss_mesh']!r} vs the "
              f"single-device replay {a['first_loss_replay']!r} (bound "
              f"{PAR_REPLAY_REL} x max(1, |loss|)); WaveNet (full width, "
              f"B={PAR_WN_B}, SGD) DP step vs single: loss "
              f"{wn['loss_dp']!r} vs {wn['loss_single']!r}, parameters max "
              f"abs {wn['max_abs']:.3e}, excess over {PAR_RTOL}/{PAR_ATOL} "
              f"{wn['excess']:.3e} [{card}]")
        require(abs(a["first_loss_mesh"] - a["first_loss_replay"])
                <= PAR_REPLAY_REL * max(1.0, abs(a["first_loss_replay"])),
                f"(a) mesh loss vs replay: {a['first_loss_mesh']} "
                f"{a['first_loss_replay']}")
        require(abs(wn["loss_dp"] - wn["loss_single"]) <= PAR_LOSS_ATOL
                and wn["excess"] <= 0, f"(a) WaveNet DP step: {wn}")
    require(a["max_abs_across_ranks"] <= 1e-6 * a["scale"],
            f"(a) ranks disagree: {a['max_abs_across_ranks']}")
    require(rec["a"]["launches"]["iir_sosfilt_rolldec"] == PAR_STEPS * world
            and rec["a"]["launches"]["iir_sosfilt"] == PAR_STEPS * world,
            f"(a) IIR launches {rec['a']['launches']}")

    # (b) ------------------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    d = entry.dryrun_multichip(world, device="cuda")
    torch.cuda.synchronize()
    rec["b"] = {**d, "wall_s": time.perf_counter() - t0}
    if world == 1:                 # in this process: its launches readable
        launches.append(read())
    print(f"{tag} (b) dryrun_multichip({world}): mesh {d['mesh']}, loss "
          f"{d['dp_loss']!r} vs replay {d['replay_loss']!r}, "
          f"{rec['b']['wall_s']:.2f} s [{card}]")
    require(tuple(d["mesh"]) == PAR_MESHES[world]
            and abs(d["dp_loss"] - d["replay_loss"])
            < 1e-4 * max(1.0, abs(d["replay_loss"])), f"(b) {d}")

    # (c) ------------------------------------------------------------------
    rec["c"] = {**c, "ms_by_rank": [r["c"]["ms"] for r in res],
                "peak_gib_by_rank": [r["c"]["peak_gib"] for r in res]}
    if world > 1:
        # each K's worst rank, under the flags spawn handed the ranks (this
        # process's: TF32 off)
        rec["c"]["halo_rel"] = {k: max(r["halo"][k] for r in res)
                                for k in PAR_HALO_K}
    print(f"{tag} (c) long_eeg_rollout, B=2, T={LONG_T} "
          f"({LONG_T // 200 // 60} min, {LONG_T // 200} tokens), full width, "
          f"seq={world}: {c['ms']:.2f} ms, peak GiB by card "
          f"{[round(g, 3) for g in rec['c']['peak_gib_by_rank']]}; logits "
          f"vs local_forward(None) rel {c['logit_rel']:.2e} (bound "
          f"{LONG_LOGIT_REL}); rollout {c['rollout']} rows sum to 1 within "
          f"{c['row_err']:.2e} (bound {LONG_ROW_ATOL})"
          + (f"; halo conv vs unsharded rel by K, worst rank, under the "
             f"ranks' flags {rec['c']['halo_rel']} (bound {PAR_HALO_REL})"
             if world > 1 else "") + f" [{card}]")
    require(c["finite"] and c["rollout"] == (2, LONG_T // 200, LONG_T // 200)
            and c["logit_rel"] < LONG_LOGIT_REL
            and c["row_err"] < LONG_ROW_ATOL, f"(c) {c}")
    require(world == 1 or max(rec["c"]["halo_rel"].values()) <= PAR_HALO_REL,
            f"(c) halo conv: {rec['c'].get('halo_rel')}")

    # (d) ------------------------------------------------------------------
    # one rank explains the whole batch as the unsharded functions do; above
    # one, each rank's rows run other shapes than the whole batch's, where
    # the spectrogram branch's ReLU / max-pool ties may round the other way:
    # there each rank's rows are held to 1e-6 against the unsharded
    # arithmetic on those rows alone, the whole batch normwise (PAR_XAI_NORM)
    rec["d"] = {**dd, "counts_by_rank": [r["d"]["counts"] for r in res]}
    for name in ("eeg", "spectrogram"):
        r = dd[name]
        rows = [(x["d"][name]["rows_ig_rel"], x["d"][name]["rows_shap_rel"])
                for x in res] if world > 1 else []
        print(f"{tag} (d) sharded attribution, {name}, B={PAR_XAI_B}: "
              f"IG ({r['steps']} steps) + SHAP ({r['nsamples']} draws x 6 "
              f"classes) {r['ms_sharded']:.1f} ms sharded, "
              f"{r['ms_unsharded']:.1f} ms unsharded; vs unsharded rel IG "
              f"{r['ig_rel']:.2e}, SHAP {r['shap_rel']:.2e}" + (
                  f", normwise IG {r['ig_norm_rel']:.2e}, SHAP "
                  f"{r['shap_norm_rel']:.2e}; each rank's rows vs the "
                  f"unsharded arithmetic on those rows (IG, SHAP) {rows}"
                  if world > 1 else "") + f" (bound {PAR_XAI_REL}"
              + (f"; spectrogram whole batch {PAR_XAI_NORM} normwise"
                 if world > 1 else "") + f") [{card}]")
        require(r["shap_shape"][:2] == (6, PAR_XAI_B)
                and max(max(p) for p in rows or [(0.0,)]) <= PAR_XAI_REL,
                f"(d) {name} {r} {rows}")
        if world == 1 or name == "eeg":
            require(r["ig_rel"] <= PAR_XAI_REL
                    and r["shap_rel"] <= PAR_XAI_REL, f"(d) {name} {r}")
        else:
            require(r["ig_norm_rel"] <= PAR_XAI_NORM
                    and r["shap_norm_rel"] <= PAR_XAI_NORM,
                    f"(d) {name} {r}")
    print(f"{tag} (d) launches in the sharded runs by rank: "
          f"{rec['d']['counts_by_rank']} [{card}]")
    require(all(c["specblock_convpool"] > 0 and c["specblock_convpool_vjp"] > 0
                for c in rec["d"]["counts_by_rank"]),
            f"(d) #3 / #3' not run on every rank: {rec['d']['counts_by_rank']}")

    # (e) ------------------------------------------------------------------
    rec["e"] = e
    print(f"{tag} (e) DiffEEGTrainer(mesh, decorrelate_shards=False), "
          f"DiffEEGConfig() width, K={e['k']} x B={e['b']} a rank, "
          f"{PAR_DIFF_STEPS} steps: ms a step {[round(t, 3) for t in e['ms_dp']]}"
          f" (single device {[round(t, 3) for t in e['ms_single']]}), "
          f"{PAR_DIFF_TIMED} warm steps after them "
          f"{[round(t, 3) for t in e['ms_dp_warm']]} (single device "
          f"{[round(t, 3) for t in e['ms_single_warm']]}); loss "
          f"{e['loss_dp']!r} vs {e['loss_single']!r}; parameters max abs "
          f"{e['params_max_abs']:.3e}, excess over {PAR_RTOL}/{PAR_ATOL}: "
          f"parameters {e['params_excess']:.3e}, EMA {e['ema_excess']:.3e} "
          f"[{card}]")
    require(abs(e["loss_dp"] - e["loss_single"]) <= PAR_LOSS_ATOL
            and e["params_excess"] <= 0 and e["ema_excess"] <= 0,
            f"(e) DiffEEG DP vs single: {e}")

    # (f) ------------------------------------------------------------------
    if world > 1:
        rec["f"] = _par_cli(card, tmp, world, *cli_ref)
    return rec, {k: sum(c.get(k, 0) for c in launches) for k in launches[0]}


def phase_parallel(card: str, tmp: str) -> dict:
    """Phase 16: the parallel programs on a world of each size in
    PAR_WORLDS that the visible cards hold (``parallel.launch.spawn``;
    NCCL, one card a rank; a world of one runs in this process):

    (a) ``Trainer(mesh=...)`` on the multimodal training model, float32,
        TF32 off, B=256, 3 steps, against the same steps without a mesh
        (bitwise at a world of one; above one the first step's loss against
        ``replay_dp_loss_single_device`` to 1e-5·max(1, |loss|) and the
        full-width WaveNet's SGD step against the single device's); ranks
        agree to 1e-6; ms a step both ways and of the step alone, windows/s,
        idle share, the all-reduce's ms, bytes and bus bandwidth, #1/#2
        launches; on the largest world also B=256 a card;
    (b) ``entry.dryrun_multichip(world, device="cuda")``: the JAX mesh, the
        replay check inside;
    (c) ``long_eeg_rollout`` at full width over B=2 × one hour (T=720,000,
        3,600 tokens) at seq = world: logits against ``local_forward(None)``
        (1e-4), rows summing to 1 (1e-4), ms and each card's peak GiB; above
        one rank the halo conv across cards at K = 3, 5, 7, 9 (1e-5), under
        the numerics flags spawn handed the ranks (each rank's held equal to
        this process's);
    (d) ``sharded_integrated_gradients`` and
        ``sharded_gradient_shap_values`` at B=8 over the EEG branch and the
        fused spectrogram forward (#3, #3' on every rank), equal to the
        unsharded functions to 1e-6 of the maximum (above one rank: each
        rank's rows to 1e-6 against the unsharded arithmetic on them, the
        spectrogram branch's whole batch to PAR_XAI_NORM normwise);
    (e) ``DiffEEGTrainer(mesh=..., decorrelate_shards=False)`` at full
        width, 2 steps at K=4, against the single device; ms a step in those
        and in PAR_DIFF_TIMED warm steps;
    (f) above one rank, ``predict --mesh N`` against phase 15's one-card
        predictions (its 1e-3 and argmax rule) and ``train-multimodal
        --mesh N`` on phase 13's tree (``tmp/hms``; phase 15's checkpoint
        in ``tmp/cli``);

    then the command line's ``long-eeg`` over every card (rank 0's line
    read), and on more than one card ``initialize_multihost`` in as many
    processes with no ``LOCAL_RANK``.  Prints the worlds it ran and a
    ``{"parallel": ...}`` line with every world's record; returns the
    launches by kernel name of the largest world's runs."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import entry
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        launch)
    n_cards = torch.cuda.device_count()
    worlds = [w for w in PAR_WORLDS if w <= n_cards]
    t_phase = time.perf_counter()
    nccl = torch.cuda.nccl.version()
    rec = {"card": card, "worlds": worlds, "backend": launch.backend_for("cuda"),
           "cards": _smi("--query-gpu=index,name,power.limit",
                         "--format=csv,noheader").splitlines(),
           "nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple)
           else str(nccl)}
    print(f"[parallel] worlds {worlds} of {n_cards} visible card(s), over "
          f"{rec['backend']} {rec['nccl']}, one card a rank [{card}]")
    for line in rec["cards"]:
        print(f"[parallel] card {line}")
    if n_cards > 1:
        rec["topology"] = _topology()
        for line in rec["topology"].splitlines():
            print(f"[parallel] topo | {line}")
    cli_ref = None
    if len(worlds) > 1:
        _, ref, _ = _read_predictions(f"{tmp}/cli/predictions.csv")
        _, tr_idx, _ = entry.multimodal_fold0(
            f"{tmp}/hms", f"{tmp}/cli", RD_SEED, npy_dir=f"{tmp}/hms/npy")
        cli_ref = (ref, len(tr_idx) // CLI_BATCH * CLI_BATCH)
    launches = {}
    for world in worlds:
        rec[f"world{world}"], launches = _par_world(
            card, tmp, world, world == worlds[-1] > 1, cli_ref)
    one = rec["world1"]["a"]
    for world in worlds:
        r = rec[f"world{world}"]["a"]
        r["efficiency"] = {"mesh": one["ms_mesh"] / (world * r["ms_mesh"]),
                           "step": one["ms_step"] / (world * r["ms_step"])}
        if "weak" in r:
            r["weak"]["efficiency"] = {
                "mesh": one["ms_mesh"] / r["weak"]["ms_mesh"],
                "step": one["ms_step"] / r["weak"]["ms_step"]}
        print(f"[parallel] world {world}: DP scaling against one card at "
              f"B={PAR_B} global: efficiency {r['efficiency']['step']:.3f} "
              f"(the step alone), {r['efficiency']['mesh']:.3f} "
              f"(preprocessing included)" + (
                  f"; at {PAR_B} rows a card: {r['weak']['efficiency']['step']:.3f}"
                  f", {r['weak']['efficiency']['mesh']:.3f}"
                  if "weak" in r else "") + f" [{card}]")

    out, wall = _cli_ranks(["long-eeg", "--ckpt-dir", f"{tmp}/long_eeg"], tmp)
    rec["long_eeg_cli"] = {"wall_s": wall, "line": out.strip()}
    require(f"devices={n_cards} seq-sharded T={200 * 64 * n_cards}" in out,
            f"(c) cli long-eeg over {n_cards} card(s): {out!r}")
    if n_cards > 1:
        g = _par_multihost(worlds[-1])
        rec["multihost"] = g
        print(f"[parallel] initialize_multihost, {worlds[-1]} processes, no "
              f"LOCAL_RANK: {g['ranks']}; {g['wall_s']:.2f} s [{card}]")
        require(sorted(r["card"] for r in g["ranks"])
                == list(range(worlds[-1])) and all(
                    r["sum"] == worlds[-1] * (worlds[-1] + 1) / 2
                    for r in g["ranks"]), f"(g) {g}")
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[parallel] worlds run: {worlds}; launches at world {worlds[-1]} "
          f"{launches}; phase {rec['phase_s']:.1f} s [{card}]")
    print(json.dumps({"parallel": rec}, default=float))
    return launches


# The public DSP API (phase 17): ``ops.lfilter`` under every engine the JAX
# package names, from zero and from a given per-lane state, and
# ``ops.filtfilt`` under ``blockmm`` and the kernel, on OPS_LANES lanes of
# OPS_T samples (the CPU's plain versions run the same calls); then #1
# from a given state timed beside #1 from zero at the serving size
OPS_LANES, OPS_T, OPS_FF_T = 64, 2000, 400
OPS_ENGINES = ("auto", "pallas", "scan", "blockmm", "block", "xla")
OPS_REL, OPS_FF_REL = 2e-4, 1e-3     # tests/test_ops_iir.py's bounds


def phase_ops_api(card: str, dev) -> dict:
    """``lfilter(coeffs, x, axis, zi, block_size, engine)`` and
    ``filtfilt(..., engine)`` on the card: each engine with and without a
    random per-lane state (K=5, the NaN route's bandpass) and once along
    axis 0, held against float64 ``scipy.signal.sosfilt`` / ``filtfilt``
    and against the same call on the CPU; every kernel's launches read
    around that run and held to the dispatch rules (the sequential scan:
    ``auto``, ``pallas``, ``scan`` and every ``zi``; the kernel's
    given-state mode for every ``zi``; filtfilt under ``pallas`` two
    steady-state launches; nothing for ``blockmm`` and ``block``).  Then
    at 5,120 × 10,000: #1 from a given state against its plain version
    (the sequential scan from that state on the card), timed beside #1
    from zero (zero, given, given, zero), its bound, the block-Toeplitz
    route from that state, and the ``block`` and ``blockmm`` routes.
    Returns the given-state kernel's record and the phase's launches."""
    from scipy import signal as sps
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, iir)
    t_phase = time.perf_counter()
    reset, read = _counters()
    bp5 = iir.butter_bandpass(0.5, 20.0, 200.0, 5)
    notch = iir.iirnotch(60.0, 30.0, 200.0)
    K = len(bp5.sos)
    cpu = torch.device("cpu")
    x = signal((OPS_LANES, OPS_T), 40, 21, cpu)
    zi = signal((OPS_LANES, K, 2), 10, 22, cpu)
    xs = signal((OPS_LANES, OPS_FF_T), 5, 23, cpu)
    sos = np.asarray(bp5.sos)
    ref = {False: sps.sosfilt(sos, x.double().numpy(), axis=-1),
           True: sps.sosfilt(sos, x.double().numpy(), axis=-1,
                             zi=zi.double().numpy().transpose(1, 0, 2))[0]}
    ref_ff = np.ascontiguousarray(sps.filtfilt(
        np.asarray(notch.b), np.asarray(notch.a), xs.double().numpy(),
        axis=-1))
    cases = [(e, g) for e in OPS_ENGINES for g in (False, True)]
    want = {(e, g): iir.lfilter(bp5, x, zi=zi if g else None, engine=e)
            for e, g in cases}
    want_ff = {e: iir.filtfilt(notch, xs, engine=e)
               for e in ("blockmm", "pallas")}

    xd, zd, xsd = x.to(dev), zi.to(dev), xs.to(dev)
    torch.cuda.synchronize()
    reset()
    got = {(e, g): iir.lfilter(bp5, xd, zi=zd if g else None, engine=e)
           for e, g in cases}
    got_axis0 = iir.lfilter(bp5, xd.t(), axis=0, zi=zd, engine="auto")
    got_ff = {e: iir.filtfilt(notch, xsd, engine=e)
              for e in ("blockmm", "pallas")}
    torch.cuda.synchronize()
    counts = read()
    print(f"[ops api] launches over lfilter x {len(cases) + 1} and filtfilt "
          f"x 2: {counts}")
    expect = {"iir_sosfilt": 3 + 2, "iir_sosfilt_given": len(OPS_ENGINES) + 1,
              "iir_sosfilt_rolldec": 0}
    require(all(counts[k] == n for k, n in expect.items()),
            f"ops api: launches {counts}, expected {expect}")
    errs = {}
    for (e, g), y in got.items():
        r_ref = rel(y.cpu(), torch.as_tensor(ref[g]))
        r_cpu = rel(y.cpu(), want[e, g])
        require(y.shape == x.shape and bool(torch.isfinite(y).all())
                and r_ref < OPS_REL and r_cpu < OPS_REL,
                f"ops api: lfilter engine={e} zi={g}: rel {r_ref:.2e} to "
                f"float64, {r_cpu:.2e} to the CPU")
        errs[f"{e}{'+zi' if g else ''}"] = r_ref
    r = rel(got_axis0.t().cpu(), torch.as_tensor(ref[True]))
    require(r < OPS_REL, f"ops api: lfilter axis=0 zi: rel {r:.2e}")
    errs["axis0+zi"] = r
    for e, y in got_ff.items():
        r_ref = rel(y.cpu(), torch.as_tensor(ref_ff))
        r_cpu = rel(y.cpu(), want_ff[e])
        require(r_ref < OPS_FF_REL and r_cpu < OPS_FF_REL,
                f"ops api: filtfilt engine={e}: rel {r_ref:.2e} to float64, "
                f"{r_cpu:.2e} to the CPU")
        errs[f"filtfilt {e}"] = r_ref
    print(f"[ops api] lfilter ({OPS_LANES}, {OPS_T}), K={K}, and filtfilt "
          f"({OPS_LANES}, {OPS_FF_T}) on the card, rel to float64 scipy "
          f"(bounds {OPS_REL:g}, filtfilt {OPS_FF_REL:g}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    # --- #1 from a given state at the serving size, beside #1 from zero
    lanes, T = B_TIME * 20, 10_000
    xt = signal((lanes, T), 40, 5, dev)
    zt = signal((lanes, K, 2), 10, 6, dev)
    y = cuda_iir.sosfilt(bp5, xt, zi=zt)
    t0 = time.perf_counter()
    y_plain = iir._sos_scan(xt, bp5.sos, zt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    r = rel(y, y_plain)
    require(r < OPS_REL, f"#1 given state ({lanes}, {T}): rel {r:.2e}")
    given = lambda: cuda_iir.sosfilt(bp5, xt, zi=zt)     # noqa: E731
    zero = lambda: cuda_iir.sosfilt(bp5, xt)             # noqa: E731
    z1, g1, g2, z2 = (cuda_ms(f, 10) for f in (zero, given, given, zero))
    ms, ms_zero = (g1 + g2) / 2, (z1 + z2) / 2
    z0 = zt.reshape(lanes, -1)
    lib_ms = cuda_ms(lambda: iir._cascade_block_matmul(xt, bp5.sos, 128,
                                                       z0=z0), 3)
    block_ms = cuda_ms(lambda: iir.lfilter(bp5, xt, engine="block"), 2)
    blockmm_ms = cuda_ms(lambda: iir.lfilter(bp5, xt, engine="blockmm"), 3)
    b, b_by = bound_ms(lanes * T * 4 * 2 + lanes * K * 2 * 4,
                       9 * K * lanes * T)
    print(f"[ops api] #1 given state K={K} ({lanes}, {T}): rel {r:.2e} to "
          f"the sequential scan from that state; {ms:.4f} ms ({g1:.4f}, "
          f"{g2:.4f}) beside #1 from zero {ms_zero:.4f} ms ({z1:.4f}, "
          f"{z2:.4f}): ratio {ms / ms_zero:.4f}; bound {b:.4f} ms by {b_by}; "
          f"block-matmul route from the state {lib_ms:.4f} ms; "
          f"lfilter engine=block {block_ms:.3f} ms, engine=blockmm "
          f"{blockmm_ms:.4f} ms; plain scan {plain_ms:.1f} ms (host clock) "
          f"[{card}]")
    rec = dict(err=max_abs(y, y_plain), ms=ms, plain_ms=plain_ms,
               bound_ms=b, bound_by=b_by, library_ms=lib_ms,
               ms_zero_state=ms_zero, block_ms=block_ms,
               blockmm_ms=blockmm_ms)
    del xt, zt, y, y_plain
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"ops_api": {"launches": counts, "rel": errs,
                                  "given_ms": ms, "zero_ms": ms_zero,
                                  "ratio": ms / ms_zero, "bound_ms": b,
                                  "block_ms": block_ms,
                                  "blockmm_ms": blockmm_ms,
                                  "phase_s": phase_s}}))
    return {"rec": rec, "launches": counts}


# Phase 18: the port's bench command.  The headline runs once through the
# command line at full width; every other mode in this process through its
# mode function, at the defaults of the repo-root bench.py except the cuts
# below, each listed in PERF.md (a mode alone would pass ~20 s): fewer
# repeats, iterations or K (the number of chained steps a CUDA graph
# replay); --convprobe runs at full size.
BENCH_CUTS = {
    "multimodal FUSED_SPEC=0": dict(scan=4, iters=4),
    "multimodal FUSED_SPEC=2": dict(scan=4, iters=4),
    "multimodal-effnet": dict(scan=2, iters=2, reps=3),
    "multimodal-effnetv2": dict(scan=2, iters=2, reps=3),
    "multimodal --breakdown": dict(iters=4, reps=3),
    "gradcam": dict(scan=16),
    "xai-batch": dict(iters=1, reps=3),
    "latency": {},
    "train": dict(iters=4, reps=3),
    "diffusion": dict(iters=1),
    "diffeeg-train": dict(iters=1, reps=3),
    "longeeg": {},
    "hostgather": {},
    "convprobe": {},
}
BENCH_FUSED_REL = 2e-2           # fused vs unfused bf16, of the max |value|
# The duty probe vs its plain version R·(W @ P), relative to the max.  One
# pass (R=1) on the probe's operands: 1e-5.  The probe's own R=512 output
# sums R·k/16 partial products into one float32 accumulator; the tensor
# cores' accumulation rounds toward zero, each step off by under one unit
# in the last place of the accumulator (2^-23 relative), so the sum is
# held to R·(k/16)·2^-23 of the max.  No float32 R-fold sum meets 1e-5 at
# R=512: tests/test_torch_bench.py::test_duty_r512_needs_the_accumulation_
# bound simulates it on the CPU (round to nearest: 2.5e-5 at (16, 144)).
BENCH_DUTY_REL = 1e-5
BENCH_TIMEOUT_S = 600            # the headline's command


def _bench_modes(bench):
    """(name, mode function, keyword arguments) of every in-process
    mode."""
    fns = {"multimodal-effnet": (bench.bench_multimodal,
                                 dict(spec_model="effnet")),
           "multimodal-effnetv2": (bench.bench_multimodal,
                                   dict(spec_model="effnetv2")),
           "multimodal FUSED_SPEC=0": (bench.bench_multimodal,
                                       dict(fused_spec=0)),
           "multimodal FUSED_SPEC=2": (bench.bench_multimodal,
                                       dict(fused_spec=2)),
           "multimodal --breakdown": (bench.bench_multimodal_breakdown, {}),
           "gradcam": (bench.bench_gradcam, {}),
           "xai-batch": (bench.bench_xai_batch, {}),
           "latency": (bench.bench_latency, {}),
           "train": (bench.bench_train, {}),
           "diffusion": (bench.bench_diffusion, {}),
           "diffeeg-train": (bench.bench_diffeeg_train, {}),
           "longeeg": (bench.bench_longeeg, {}),
           "hostgather": (bench.bench_hostgather, {}),
           "convprobe": (bench.bench_convprobe, {})}
    return [(name, fns[name][0], {**fns[name][1], **cut})
            for name, cut in BENCH_CUTS.items()]


def _bench_plain_rolldec(coeffs, x):
    """#2's plain version on any device: the sequential scan, then the
    mean of every 4 outputs (``cuda_iir.sosfilt_rolldec``'s CPU branch)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import iir
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops.resample \
        import rolling_mean4_decimate_flat
    shape, T = x.shape, x.shape[-1]
    y = iir._sos_scan(x.reshape(-1, T), coeffs.sos)
    return rolling_mean4_decimate_flat(y, 4).reshape(shape[:-1] + (T // 4,))


def phase_bench(card: str, dev) -> dict:
    """The port's ``bench``: (a) ``python -m ... bench`` as a subprocess
    at full width (B=256, (20, 10000), BENCH_SCAN=64): exit 0, one line, a
    finite value > 0, ``device`` the card's name, ``vs_baseline`` null;
    (b) the headline's step against the same step with #2's plain version
    on the card (LOGP_ATOL), the BENCH_FUSED_SPEC=2 multimodal step
    against the unfused one (BENCH_FUSED_REL of the max); (c) every other
    mode through its mode function (BENCH_CUTS), each line finite with no
    error, its seconds and each kernel's launches in its run, the duty
    probe's last output at each shape against its plain version
    (BENCH_DUTY_REL).  Returns each kernel's launches summed over (b) and
    (c)."""
    from multimodal_brain_pattern_identification_xai_tpu_torch import bench
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_duty, cuda_iir)
    reset, read = _counters()
    name = torch.cuda.get_device_name(0)
    kernel_duty = cuda_duty.duty
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def counted(fn):
        reset()
        kernel_duty.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {**read(), "duty": kernel_duty.launches}

    # (a) the headline through the command line
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_BATCH="256", BENCH_SCAN="64")
    proc = subprocess.run([sys.executable, "-m", PKG, "bench"],
                          capture_output=True, text=True, env=env,
                          timeout=BENCH_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require(proc.returncode == 0 and len(lines) == 1,
            f"bench: exit {proc.returncode}, stdout {proc.stdout[-2000:]!r}, "
            f"stderr {proc.stderr[-2000:]!r}")
    line = json.loads(lines[0])
    require(line["metric"] == "eeg_windows_per_sec_per_chip"
            and isinstance(line["value"], (int, float))
            and np.isfinite(line["value"]) and line["value"] > 0
            and line["device"] == name and line["vs_baseline"] is None
            and line["scan_len"] == 64, f"bench headline line {line}")
    print(f"[bench] python -m {PKG} bench (B=256, BENCH_SCAN=64): "
          f"{lines[0]} ({dt:.1f} s) [{card}]")

    # (b) the kernels on the bench's own paths
    step, _, _ = bench.headline_program("cuda", 256)
    got, counts = counted(step)
    add(counts)
    require(counts["iir_sosfilt_rolldec"] == 1,
            f"headline step: launches {counts}")
    step, _, _ = bench.headline_program("cuda", 256)
    kernel_rolldec = cuda_iir.sosfilt_rolldec
    cuda_iir.sosfilt_rolldec = _bench_plain_rolldec
    try:
        reset()
        with torch.no_grad():
            want = step()
        torch.cuda.synchronize()
        require(read()["iir_sosfilt_rolldec"] == 0, "plain step launched #2")
    finally:
        cuda_iir.sosfilt_rolldec = kernel_rolldec
    err = max_abs(got, want)
    require(bool(torch.isfinite(got).all()) and err < LOGP_ATOL,
            f"bench headline step vs plain #2: {err}")
    print(f"[bench] headline step, B=256: log-probs with #2 against #2's "
          f"plain version on the card: max abs {err:.2e} (bound "
          f"{LOGP_ATOL}) [{card}]")
    outs, fused_counts = {}, {}
    for fused in (2, 0):
        step, _, _ = bench.multimodal_program("cuda", 256, fused_spec=fused)
        outs[fused], fused_counts[fused] = counted(step)
        add(fused_counts[fused])
        del step
    require([fused_counts[f]["specblock_convpool_whole_bf16"] for f in (2, 0)]
            == [2, 0], f"multimodal step launches {fused_counts}")
    fused_err = rel(outs[2], outs[0])
    require(bool(torch.isfinite(outs[2]).all())
            and fused_err < BENCH_FUSED_REL,
            f"bench multimodal fused vs unfused: {fused_err}")
    print(f"[bench] multimodal step, B=256, bf16: BENCH_FUSED_SPEC=2 vs 0 "
          f"log-probs: max abs {max_abs(outs[2], outs[0]):.2e} = "
          f"{fused_err:.2e} of the max (bound {BENCH_FUSED_REL}) [{card}]")
    del outs
    torch.cuda.empty_cache()

    # (c) every other mode through its mode function
    # the convprobe mode's duty calls pass a recorder in the module's
    # place; the kernel's wrapper then counts on the recorder (it adds to
    # the module-level name's attribute)
    duty_calls = {}

    def recording_duty(w, p, r):
        out = kernel_duty(w, p, r)
        duty_calls[tuple(w.shape)] = (w, p, r, out)
        return out
    for mode, fn, kw in _bench_modes(bench):
        t0 = time.perf_counter()
        if mode == "convprobe":
            recording_duty.launches = 0
            cuda_duty.duty = recording_duty
        try:
            line, counts = counted(lambda: fn(device="cuda", **kw))
        finally:
            cuda_duty.duty = kernel_duty
        if mode == "convprobe":
            counts["duty"] += recording_duty.launches
        dt = time.perf_counter() - t0
        add(counts)
        require(line.get("unit") != "error" and "error" not in line
                and isinstance(line["value"], (int, float))
                and np.isfinite(line["value"]) and line["device"] == name,
                f"bench {mode}: {line}")
        launched = {k: v for k, v in counts.items() if v}
        print(f"[bench] {mode} {kw}: {json.dumps(line)} ({dt:.1f} s; "
              f"launches {launched}) [{card}]")
        torch.cuda.empty_cache()
    require(set(duty_calls) == set(cuda_duty.SHAPES),
            f"the duty probe ran {sorted(duty_calls)}")
    for (co, k), (w, p, r, out) in sorted(duty_calls.items()):
        e1 = rel(kernel_duty(w, p, 1), cuda_duty._plain_duty(w, p, 1))
        e = rel(out, cuda_duty._plain_duty(w, p, r))
        bound = r * (k // 16) * 2.0 ** -23
        require(e1 <= BENCH_DUTY_REL and e <= bound,
                f"bench duty ({co}, {k}): rel {e1} at R=1, {e} at R={r}")
        print(f"[bench] convprobe duty ({co}, {k}) N={p.shape[1]}, the "
              f"probe's operands, against the plain version: R=1 rel "
              f"{e1:.2e} (bound {BENCH_DUTY_REL}); the probe's R={r} "
              f"output rel {e:.2e} (float32 accumulation bound "
              f"{bound:.2e}) [{card}]")
    for kname in ("iir_sosfilt_rolldec", "specblock_convpool_whole_bf16",
                  "duty"):
        require(total.get(kname, 0) > 0, f"bench: {kname} never launched")
    print(f"[bench] launches in the phase: "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        __import__(PKG)
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    clock = [time.perf_counter()]
    t_start = clock[0]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now
    card = phase_device()
    done("device")
    phase_build(card)
    done("build")
    rec = phase_kernels(card, dev)
    done("kernels")
    launches = phase_main(card)
    done("main")
    launches.update(phase_wide(card, dev))
    done("wide")
    times = phase_timing(card)
    done("timing")
    # phase 7: path A (the 200x150 preset) through the main path's and the
    # timing's harness, then paths B and C; each path keeps its own counts
    from multimodal_brain_pattern_identification_xai_tpu_torch import config
    routes = {"A": phase_main(card, config.SPEC_RES_PRESET, fused_blocks=1)}
    phase_timing(card, config.SPEC_RES_PRESET, beside=times)
    routes.update(phase_routes(card, dev))
    done("routes")
    phase_stem(card)
    done("stem")
    xai_counts = phase_xai(card, dev, times["float32", "finite", B_TIME][0])
    done("xai")
    train_launches = phase_train(card, dev)
    done("train")
    rec["duty"] = phase_convprobe(card, dev)
    done("convprobe")
    diffusion_launches = phase_diffusion(card, dev)
    done("diffusion")
    # phases 13 and 14 share one synthetic HMS tree, written once
    with tempfile.TemporaryDirectory() as tmp:
        realdata_launches = phase_realdata(card, dev, tmp)
        done("realdata")
        zoo_launches = phase_zoo(card, dev, tmp)
        done("zoo")
        cli_launches = phase_cli(card, dev, tmp)
        done("cli")
        parallel_launches = phase_parallel(card, tmp)
        done("parallel")
    ops = phase_ops_api(card, dev)
    done("ops api")
    rec["iir_sosfilt_given"] = ops["rec"]
    bench_launches = phase_bench(card, dev)
    done("bench")

    xai_tpu = "multimodal_brain_pattern_identification_xai_tpu"
    src = {"iir_sosfilt": (f"{PKG}/csrc/iir.cu",
                           f"{xai_tpu}/ops/pallas_iir.py:165",
                           "serving (NaN route); training (NaN route); "
                           "eeg_transform (also train_diffeeg's); notch "
                           "filtfilt of the op-by-op reference chain"),
           "iir_sosfilt_rolldec": (f"{PKG}/csrc/iir.cu",
                                   f"{xai_tpu}/ops/pallas_iir.py:254",
                                   "serving; training (every step)"),
           "specblock_convpool": (f"{PKG}/csrc/specblock.cu",
                                  f"{xai_tpu}/ops/pallas_specblock.py:242",
                                  "serving (also the 200x150 preset's block "
                                  "1)+xai"),
           "specblock_convpool_bf16": (f"{PKG}/csrc/specblock.cu",
                                       f"{xai_tpu}/ops/pallas_specblock.py:242",
                                       "bf16 blocks 1-2 where autograd "
                                       "records"),
           "specblock_convpool_whole_bf16": (
               f"{PKG}/csrc/specblock.cu",
               f"{xai_tpu}/ops/pallas_specblock.py:242",
               "serving (bf16 program; also the 200x150 preset's block 1): "
               "the whole block, BatchNorm, skip and add in the epilogue"),
           "specblock_convpool_wide": (
               f"{PKG}/csrc/specblock.cu",
               f"{xai_tpu}/ops/pallas_specblock.py:242",
               "fused blocks 3-5 (64x48, 64x64), float32; one count a call, "
               "three device launches of wide_tf32_conv_kernel"),
           "specblock_convpool_wide_bf16": (
               f"{PKG}/csrc/specblock.cu",
               f"{xai_tpu}/ops/pallas_specblock.py:242",
               "fused blocks 3-5 (64x48, 64x64), bf16; one count a call, "
               "three device launches of wide_bf16_conv_kernel"),
           "iir_sosfilt_given": (
               f"{PKG}/csrc/iir.cu", f"{xai_tpu}/ops/pallas_iir.py:165",
               "lfilter(zi=) under every engine (the JAX package runs it "
               "as its XLA scan, ops/iir.py:473-475); no serving, training "
               "or command-line path"),
           "duty": (f"{PKG}/csrc/duty.cu", "bench.py:1123", "convprobe")}
    launches["duty"] = rec["duty"].pop("launches")
    launches["iir_sosfilt_given"] = ops["launches"]["iir_sosfilt_given"]
    # iir_sosfilt's launches count its callers besides the main path: the
    # op-by-op reference chain's notch filtfilt (B) and eeg_transform (C)
    main_sosfilt = launches["iir_sosfilt"]
    launches["iir_sosfilt"] += sum(routes[p].get("iir_sosfilt", 0)
                                   for p in ("B", "C"))
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "path": src[name][2],
                "launches": launches[name],
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{key: v for key, v in r.items() if key not in (
                    "err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name, r in rec.items()]
    for k in kernels:
        k["routes_launches"] = {p: c.get(k["name"], 0)
                                for p, c in routes.items()}
        if k["name"] == "iir_sosfilt":
            k["main_launches"] = main_sosfilt
        if k["name"] == "specblock_convpool":
            k["xai_launches"] = xai_counts["launches"]
        if k["name"] in train_launches:
            k["train_launches"] = train_launches[k["name"]]
        if k["name"] in diffusion_launches:
            k["diffusion_launches"] = diffusion_launches[k["name"]]
        if k["name"] in realdata_launches:
            k["realdata_launches"] = realdata_launches[k["name"]]
        if k["name"] in zoo_launches:
            k["zoo_launches"] = zoo_launches[k["name"]]
        k["cli_launches"] = cli_launches.get(k["name"], 0)
        k["parallel_launches"] = parallel_launches.get(k["name"], 0)
        k["ops_api_launches"] = ops["launches"].get(k["name"], 0)
        k["bench_launches"] = bench_launches.get(k["name"], 0)
    print(f"[time] total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
