"""Chunk-length sweep of the chunked IIR kernels on one card.

    python3 scripts/torch_iir_sweep.py [--chunks 64,128,256] [--reps 20]
                                       [--repo DIR] [--serving]

At the serving path's IIR shapes (10,000 samples; B=256 and B=4: the NaN
route's first bandpass, K=5 ``sosfilt`` on B·20 lanes; the finite route's
cascade, K=11 ``sosfilt_rolldec`` on B·20; the NaN route's second
bandpass, K=6 ``sosfilt_rolldec`` on B·38), times each kernel with CUDA
events at every chunk length and at the wrapper's own pick, and beside it
the block-Toeplitz matmul route (``iir._cascade_block_matmul``, block 128,
the JAX package's route on its own chip).  ``--serving`` adds the serving
forward's ms per batch at B=4 and B=256 on both routes.  ``--repo`` imports
the port from another checkout (e.g. an unpacked parent commit, whose
wrappers take no chunk length: only their own launch is timed), so that two
versions compare on one card.  float32, TF32 off.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
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


def sweep(card: str, chunks, reps: int) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, iir, preprocess)
    chunked = hasattr(cuda_iir, "launch_shape")
    bp5 = iir.butter_bandpass(0.5, 20.0, 200.0, 5)
    bp6 = iir.butter_bandpass(0.5, 20.0, 200.0, 6)
    casc = iir.cascade(bp5, bp6)
    rolldec_map = preprocess._rolldec_map(128)
    T = 10_000
    for batch in (256, 4):
        for name, coeffs, lanes in (("sosfilt", bp5, batch * 20),
                                    ("rolldec", casc, batch * 20),
                                    ("rolldec", bp6, batch * 38)):
            K = len(coeffs.sos)
            rng = np.random.default_rng(lanes)
            x = torch.as_tensor(rng.standard_normal((lanes, T)) * 20,
                                dtype=torch.float32, device="cuda")
            roll = name == "rolldec"
            fn = cuda_iir.sosfilt_rolldec if roll else cuda_iir.sosfilt
            out_map = rolldec_map if roll else None
            # an explicit chunk length goes to the launch below the wrapper
            kernel = f"iir_sosfilt{'_rolldec' if roll else ''}_f32"
            y = torch.empty((lanes, T // 4 if roll else T), device="cuda")
            zi_init = () if roll else (0,)
            times = []
            for c in [None] + (list(chunks) if chunked else []):
                def run(c=c):
                    if c is None:
                        return fn(coeffs, x)
                    cuda_iir._launch(kernel, coeffs.sos, x, y, c,
                                     *zi_init)
                    return y
                out = run()
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise RuntimeError(f"{name} K={K} chunk {c}: non-finite")
                ms = cuda_ms(run, reps)
                shape = (f"L={cuda_iir.launch_shape(lanes, T, K, c)}"
                         if chunked else "one thread per lane")
                times.append(f"{'pick ' if c is None else ''}{shape} "
                             f"{ms:.4f}")
            block_ms = cuda_ms(lambda: iir._cascade_block_matmul(
                x, coeffs.sos, 128, out_map=out_map), max(2, reps // 4))
            print(f"[sweep] {name} K={K} ({lanes}, {T}) B={batch}: "
                  f"{'; '.join(times)} ms; block-matmul route {block_ms:.4f} "
                  f"ms [{card}]", flush=True)
            del x


def serving(card: str) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    for batch, reps in ((4, 50), (256, 10)):
        for route in ("finite", "nan"):
            fwd, (eeg, spec) = entry(device="cuda", batch=batch,
                                     assume_finite=route == "finite")
            ms = cuda_ms(lambda: fwd(eeg, spec), reps, warmup=3)
            print(f"[serving] {route} route B={batch}: {ms:.3f} ms/batch, "
                  f"{batch / ms * 1e3:.1f} windows/s [{card}]", flush=True)
            del fwd, eeg, spec
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="64,96,128,192,256,384,512")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repo", default=REPO,
                    help="checkout whose port is imported")
    ap.add_argument("--serving", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_iir_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[sweep] port from {os.path.abspath(args.repo)}")
    sweep(card, [int(v) for v in args.chunks.split(",")], args.reps)
    if args.serving:
        serving(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
