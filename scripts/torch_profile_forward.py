"""Where the time goes in the PyTorch port's serving forward on one card.

    python3 scripts/torch_profile_forward.py [--batch 256] [--route finite]
        [--dtype float32|bfloat16] [--stem reassociated|canonical]
        [--graph] [--preset] [--trace trace.json]

Runs the serving forward (``entry.seeded`` + ``make_forward``, weights
from seed 0) with the chosen program — float32 or the bf16 program, the
EEGNet stem reassociated (as served) or canonical, eager or captured as
one CUDA graph (``capture_forward``), on 400x300 spectrogram planes or
(``--preset``) the reduced-resolution serving preset's 200x150 ones —
warms it up, then traces three
forwards with ``torch.profiler``.  Prints the wall time per forward (host
clock around a synchronised run), the device-busy share (summed kernel
time over wall time), the kernels launched per forward, the share of
cuDNN's FFT convolution, and the kernels grouped by name with their share
of device time; ``--trace`` writes the Chrome trace.  float32 with TF32
off, as ``chip_smoke.py`` runs it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--route", choices=("finite", "nan"), default="finite")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--stem", choices=("reassociated", "canonical"),
                    default="reassociated")
    ap.add_argument("--graph", action="store_true",
                    help="profile the forward captured as one CUDA graph")
    ap.add_argument("--preset", action="store_true",
                    help="the 200x150 resize_mode='resample' preset")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_forward: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config, profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        capture_forward, make_forward, seeded)
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dtype = None if args.dtype == "float32" else torch.bfloat16
    model, eeg, spec = seeded("cuda", args.batch, dtype=dtype)
    model.eeg_model.fused_inference = args.stem == "reassociated"
    signal = (config.SPEC_RES_PRESET if args.preset
              else config.SignalConfig())
    fwd = make_forward(model, signal=signal,
                       assume_finite=args.route == "finite",
                       serving_dtype=dtype)
    if args.graph:
        fwd = capture_forward(fwd, (eeg, spec))
    prof = profiling.profile_kernels(lambda: fwd(eeg, spec), reps=REPS)
    busy = prof.busy_ms
    fft = profiling.fft_conv_ms(prof)
    print(f"[profile] {'200x150 preset, ' if args.preset else ''}"
          f"{args.route} route, {args.dtype}, {args.stem} stem, "
          f"{'graph' if args.graph else 'eager'}, B={args.batch}: wall "
          f"{prof.wall_ms:.3f} ms/forward (profiler on), device busy "
          f"{busy:.3f} ms ({100 * busy / prof.wall_ms:.1f}%), idle "
          f"{100 * (1 - busy / prof.wall_ms):.1f}%; {prof.kernels:.0f} "
          f"kernels + {prof.copies:.0f} copies a forward; cuDNN FFT conv "
          f"{fft:.3f} ms ({100 * fft / busy:.1f}% of busy) [{card}]")
    for name, ms in sorted(prof.kernel_ms.items(),
                           key=lambda kv: -kv[1])[:args.top]:
        print(f"[profile] {ms:9.3f} ms/forward {100 * ms / busy:5.1f}%  "
              f"{name[:110]}")
    if args.trace:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            fwd(eeg, spec)
            torch.cuda.synchronize()
        p.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
