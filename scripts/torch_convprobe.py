"""Conv probe of the PyTorch port on one NVIDIA GPU: how fast can small-Cout
GEMMs and convolutions of the spectrogram blocks run on the tensor cores?

    python3 scripts/torch_convprobe.py [--duty-only] [--repo DIR]

Counterpart of the JAX package's ``bench.py --convprobe``
(``bench_convprobe``), in three sections, all bf16 with float32
accumulation:

1. GEMM orientations (``torch.mm``, bf16 → f32): block 2's im2col GEMM in
   the convolution's orientation (positions × 144 @ 144 × 16) and position-
   major (16 × 144 @ 144 × positions), a well-shaped control at the same
   FLOP count, and the 2×2 / 2×4 phase-packed GEMMs (``*_eff`` counts only
   their useful 9/16 and 9/24 of the FLOPs);
2. the block-1 / block-2 convolution subgraphs (3 convs + ReLU + pool) on
   cuDNN, NHWC, B=64;
3. the duty kernel (``ops/cuda_duty.py``, ``csrc/duty.cu``): W (co, k) @
   P (k, N) accumulated R=512 times from shared memory, N=16384, at the
   four GEMM shapes a fused block could run — the ceiling of any fused
   formulation at that shape.

``--duty-only`` runs section 3 alone; ``--repo DIR`` imports the port from
another checkout (e.g. a parent commit unpacked under ``_archive/``), so
two versions of the duty kernel compare in one call.  Every time is CUDA
events over repeated calls after a warm-up.  Prints one JSON line with the bench's keys (``duty*`` in place of ``pallas_duty*``),
``vs_baseline`` the best useful rate's fraction of the H100's dense bf16
peak (989 TFLOP/s), and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core rate, FLOP/s


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def tflops(flops: float, ms: float) -> float:
    return flops / ms / 1e9


def gemm_and_conv(results: dict, bf16, mm, K: int, CO: int) -> None:
    """Sections 1 and 2: the GEMM orientations and the conv subgraphs."""
    # ---- 1) GEMM orientations (bf16 → f32, K=144, Cout=16) --------------
    S = 384 * 1024
    w2, p0 = bf16(CO, K), bf16(K, S, scale=0.1)
    pt = p0.t().contiguous()
    gemm_flops = 2 * CO * K * S
    w2t = w2.t().contiguous()
    results["gemm_xla_orient_tflops"] = tflops(
        gemm_flops, cuda_ms(lambda: mm(pt, w2t)))
    results["gemm_pos_major_tflops"] = tflops(
        gemm_flops, cuda_ms(lambda: mm(w2, p0)))
    m = gemm_flops // (2 * 1152 * 256)
    a0, wb = bf16(m, 1152, scale=0.1), bf16(1152, 256)
    results["gemm_control_tflops"] = tflops(
        2 * m * 1152 * 256, cuda_ms(lambda: mm(a0, wb)))
    for name, m2, k2, useful in [("gemm_pack2x2", 64, 256, 9 / 16),
                                 ("gemm_pack2x4", 128, 384, 9 / 24)]:
        n2 = max(256, (gemm_flops // (2 * m2 * k2)) // 128 * 128)
        wp, pp = bf16(m2, k2), bf16(k2, n2, scale=0.1)
        raw = tflops(2 * m2 * k2 * n2, cuda_ms(lambda: mm(wp, pp)))
        results[name + "_tflops"] = raw
        results[name + "_eff_tflops"] = raw * useful
    del p0, pt, a0

    # ---- 2) conv subgraphs: 3 × (conv3x3 + ReLU) + 2x2 pool, cuDNN ------
    B = 64
    for name, (h, w, cin, cout, pool) in {
            "conv_block1": (400, 300, 3, 16, "max"),
            "conv_block2": (200, 150, 16, 32, "avg")}.items():
        x0 = bf16(B, cin, h, w).contiguous(memory_format=torch.channels_last)
        ws = [bf16(c_out, c_in, 3, 3, scale=0.05).contiguous(
            memory_format=torch.channels_last)
            for c_in, c_out in [(cin, cout), (cout, cout), (cout, cout)]]

        def block(x=x0, ws=ws, pool=pool):
            for wk in ws:
                x = F.relu(F.conv2d(x, wk, padding=1))
            return F.max_pool2d(x, 2) if pool == "max" else F.avg_pool2d(x, 2)
        ms = cuda_ms(block)
        macs = B * h * w * 9 * (cin * cout + 2 * cout * cout)
        results[name + "_ms"] = ms
        results[name + "_mfu"] = 2 * macs / (ms * 1e-3) / PEAK_BF16
        del x0


def duty_section(results: dict, bf16, cuda_duty, K: int, CO: int) -> None:
    """Section 3: the duty kernel at R=512, N=16384, each shape's ms and
    TFLOP/s."""
    # ---- 3) the duty kernel: R passes from shared memory ----------------
    n_tile, r = 16384, 512
    for name, co, k, useful in [
            ("duty", CO, K, 1.0),                 # im2col block-2 shape
            ("duty_pack2x2", 64, 256, 9 / 16),
            ("duty_pack2x4", 128, 384, 9 / 24),
            ("duty_b1pack2x2", 64, 48, 9 / 16)]:  # block-1 conv1
        wd, pd = bf16(co, k), bf16(k, n_tile, scale=0.1)
        got = cuda_duty.duty(wd, pd, 4)
        want = cuda_duty._plain_duty(wd, pd, 4)
        err = float((got - want).abs().max() / want.abs().max())
        if err >= 1e-4:
            raise RuntimeError(f"duty ({co}, {k}) rel err {err}")
        ms = cuda_ms(lambda: cuda_duty.duty(wd, pd, r), reps=10)
        raw = tflops(2 * r * co * k * n_tile, ms)
        results[name + "_ms"] = ms
        results[name + "_tflops"] = raw
        if useful < 1.0:
            results[name + "_eff_tflops"] = raw * useful


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duty-only", action="store_true",
                    help="run the duty kernel's section alone")
    ap.add_argument("--repo", default=REPO,
                    help="checkout whose port is imported")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_convprobe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_duty)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf16 = lambda *shape, scale=1.0: torch.as_tensor(
        rng.standard_normal(shape) * scale, dtype=torch.bfloat16).to(dev)
    mm = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)
    results = {}

    K, CO = 144, 16
    if not args.duty_only:
        gemm_and_conv(results, bf16, mm, K, CO)
    duty_section(results, bf16, cuda_duty, K, CO)

    # "best" compares useful-FLOP rates, as the JAX bench does
    useful_rates = [
        v for key, v in results.items()
        if key.startswith(("gemm_xla", "gemm_pos", "gemm_pack", "duty"))
        and (key.endswith("_eff_tflops") or (
            key.endswith("_tflops")
            and key[:-len("_tflops")] + "_eff_tflops" not in results))]
    best = max(useful_rates)
    print(json.dumps({
        "metric": "convprobe_best_smallcout_tflops", "value": best,
        "unit": "TFLOP/s", "vs_baseline": best / (PEAK_BF16 / 1e12),
        **results, "card": card, "repo": os.path.abspath(args.repo),
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
