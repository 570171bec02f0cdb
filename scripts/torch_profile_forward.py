"""Where the time goes in the PyTorch port's serving forward on one card.

    python3 scripts/torch_profile_forward.py [--batch 256] [--route finite]
                                             [--trace trace.json]

Runs the serving entry (``entry(device="cuda")``) with seeded weights,
warms it up, then traces three forwards with ``torch.profiler``.  Prints
the wall time per forward (host clock around a synchronised run), the
device-busy share (summed kernel time over wall time), and the kernels
grouped by name with their share of device time; ``--trace`` writes the
Chrome trace.  float32 with TF32 off, as
``chip_smoke.py`` runs it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--route", choices=("finite", "nan"), default="finite")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_forward: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    fwd, (eeg, spec) = entry(device="cuda", batch=args.batch,
                             assume_finite=args.route == "finite")
    for _ in range(2):
        fwd(eeg, spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fwd(eeg, spec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / REPS

    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values()) / REPS
    print(f"[profile] {args.route} route B={args.batch}: wall "
          f"{wall_ms:.3f} ms/forward (profiler on), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% [{card}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        per = ms / REPS
        print(f"[profile] {per:9.3f} ms/forward {100 * per / busy_ms:5.1f}%  "
              f"{name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
