"""Times the wide fused spectrogram block (Cout 64/128/256) on one card.

    python3 scripts/torch_specblock_wide.py [--dtype bfloat16|float32]
                                            [--repo DIR] [--tag NAME]
                                            [--profile] [--tiles SPEC ...]

At chip_smoke.py phase 3's shapes (B=256: Cout 64 on 16x12, 128 on 8x6,
256 on 8x6, and Cout 64 on a 100x76 plane), times
``fused_specblock_convpool(dtype=...)`` (bf16 by default) as one CUDA
graph of calls (the host's launches left out) and eagerly, beside cuDNN's
chain in the same type (conv x3 + pool, one graph, TF32 off; never used
by the port).  ``--repo`` imports the port from another checkout (e.g. an
unpacked parent commit), so two versions compare on one card.
``--profile`` adds the device time a call by kernel name (torch.profiler).

``--tiles WM,WN,MI,MB`` (repeatable) instead builds copies of
``csrc/specblock.cu`` whose wide conv of the type (``wide_bf16_conv_kernel``
or ``wide_tf32_conv_kernel``) has WM x WN warps of MI m16 tiles x 32
channels and ``__launch_bounds__`` minimum MB CTAs an SM, prints ptxas's
registers and spills, holds each against the plain chain of the type
(1e-2 of its max in bf16, a sanity bound of 1e-4 in float32, where
chip_smoke.py holds the kernel at rtol = atol = 1e-5) and times its entry
(``specblock_wide_bf16`` or ``specblock_wide_f32``) alone (weights
prepared once, a CUDA graph of calls), in two passes in opposite orders.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(256, 16, 12, 32, 64, "max"), (256, 8, 6, 64, 128, "avg"),
          (256, 8, 6, 128, 256, "max"), (256, 100, 76, 32, 64, "max")]


def cuda_ms(fn, reps: int) -> float:
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
    """Device time a call of ``reps`` calls captured in one CUDA graph,
    over five replays (warmed up on a side stream first)."""
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


#: per storage type: the tile constants' prefix in specblock.cu, the wide
#: conv's name, its C entry
KINDS = {torch.bfloat16: ("kW", "wide_bf16_conv_kernel", "specblock_wide_bf16"),
         torch.float32: ("kT", "wide_tf32_conv_kernel", "specblock_wide_f32")}


def cudnn_chain(x, ks, bs, pool):
    import torch.nn.functional as F
    xn = x.permute(0, 3, 1, 2).contiguous()
    wn = [k.permute(3, 2, 0, 1).contiguous().to(x.dtype) for k in ks]
    bn = [b.to(x.dtype) for b in bs]

    def run():
        h = xn
        for wk, bk in zip(wn, bn):
            h = F.relu(F.conv2d(h, wk, bk, padding=1))
        return F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return run


def inputs(b, h, w, cin, co, dev, dtype):
    """chip_smoke.py's seeded operands: He-scale weights, biases 0.1."""
    rng = np.random.default_rng(4)
    mk = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                    dtype=torch.float32, device=dev)
    ks = [mk(3, 3, ci, co) * float(np.sqrt(2 / (9 * cin)))
          for ci in (cin, co, co)]
    bs = [mk(co) * 0.1 for _ in range(3)]
    return mk(b, h, w, cin).to(dtype), ks, bs


def flops(b, h, w, cin, co) -> float:
    return 2 * 9 * (cin * co + 2 * co * co) * b * h * w


def time_wrapper(csb, tag: str, profile: bool, dev, dtype) -> None:
    total = 0.0
    for b, h, w, cin, co, pool in SHAPES:
        reps = 3 if h >= 100 else 20
        x, ks, bs = inputs(b, h, w, cin, co, dev, dtype)
        fused = lambda: csb.fused_specblock_convpool(
            x, ks, bs, pool=pool, dtype=dtype)
        # a kernel of over 1 ms a call (the parent's) takes a tenth the reps
        n = reps if cuda_ms(fused, 1) < 1.0 else max(1, reps // 10)
        g = graph_ms(fused, n)
        e = cuda_ms(fused, n)
        lib = graph_ms(cudnn_chain(x, ks, bs, pool), reps)
        total += g if h < 100 else 0.0
        print(f"[{tag}] ({b},{h},{w},{cin})->{co} {pool}: one graph {g:.4f} "
              f"ms ({flops(b, h, w, cin, co) / g / 1e9:.1f} TFLOP/s), eager "
              f"{e:.4f} ms; cuDNN {str(dtype)[6:]} chain, one graph "
              f"{lib:.4f} ms",
              flush=True)
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_
            with prof_(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fused()
                torch.cuda.synchronize()
            for ev in sorted(prof.key_averages(),
                             key=lambda v: -v.device_time_total)[:6]:
                print(f"    {ev.key[:80]:80s} x{ev.count // 5} a call, "
                      f"{ev.device_time_total / 5 / 1e3:.4f} ms a call")
        del x, ks, bs
        torch.cuda.empty_cache()
    print(f"[{tag}] three block shapes, one graph each, sum {total:.4f} ms")


def build_tiles(specs, build_dir: Path, dtype):
    """One library per tile spec, nvcc started for all at once."""
    pre, kern, entry = KINDS[dtype]
    from multimodal_brain_pattern_identification_xai_tpu_torch import _build
    src = (_build.CSRC / "specblock.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        wm, wn, mi, mb = (int(v) for v in spec.split(","))
        s, n = re.subn(rf"{pre}WarpsM = \d+, {pre}WarpsN = \d+, {pre}MI = \d+;",
                       f"{pre}WarpsM = {wm}, {pre}WarpsN = {wn}, {pre}MI = {mi};",
                       src)
        s, n2 = re.subn(rf"{pre}MinBlocks = \d+;", f"{pre}MinBlocks = {mb};", s)
        assert n == n2 == 1, "tile constants not found in specblock.cu"
        name = f"tiles_{pre}_" + spec.replace(",", "_")
        (build_dir / f"{name}.cu").write_text(s)
        procs[spec] = (name, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(build_dir / f"{name}.so"), str(build_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for spec, (name, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on tiles {spec}:\n{log}")
        func = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            func = m.group(1) if m else func
            if func and f"{kern}ILi1E" in func and (
                    "spill" in line or "Used" in line):
                print(f"[tiles {spec}] {line.strip()}")
        lib = ctypes.CDLL(str(build_dir / f"{name}.so"))
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[spec] = getattr(lib, entry)
    return libs


def time_tiles(csb, specs, dev, dtype) -> None:
    libs = build_tiles(specs, Path(csb.__file__).parents[1] / "_build" /
                       "tiles", dtype)
    bf16 = dtype == torch.bfloat16
    res = {s: [] for s in libs}
    for b, h, w, cin, co, pool in SHAPES:
        x, ks, bs = inputs(b, h, w, cin, co, dev, dtype)
        plain = csb._plain_convpool(x, ks, bs, pool, dtype).float()
        xp, k1 = csb._pad_cin(x, ks[0])
        ws = [csb._aligned(csb._pack_bf16_pairs(k) if bf16
                           else k.contiguous()) for k in (k1, ks[1], ks[2])]
        bias = torch.stack(bs).contiguous()
        t1, t2 = (torch.empty((b, h, w, co), dtype=dtype, device=dev)
                  for _ in range(2))
        out = torch.empty((b, h // 2, w // 2, co), dtype=dtype, device=dev)
        for order in (list(libs), list(libs)[::-1]):
            for spec in order:
                call = lambda: libs[spec](
                    xp.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                    ws[2].data_ptr(), bias.data_ptr(), t1.data_ptr(),
                    t2.data_ptr(), out.data_ptr(), b, h, w, xp.shape[-1],
                    co, int(pool == "max"),
                    torch.cuda.current_stream().cuda_stream)
                out.zero_()
                if call() != 0:
                    raise RuntimeError(f"tiles {spec}: launch failed")
                torch.cuda.synchronize()
                err = float((out.float() - plain).abs().max()
                            / plain.abs().max())
                if err >= (1e-2 if bf16 else 1e-4):
                    raise RuntimeError(f"tiles {spec}: rel err {err}")
                ms = graph_ms(call, 3 if h >= 100 else 20)
                res[spec].append(ms)
                print(f"[tiles {spec}] ({b},{h},{w},{cin})->{co} {pool}: "
                      f"rel {err:.2e}, {ms:.4f} ms", flush=True)
        del x, xp, t1, t2, out, plain
        torch.cuda.empty_cache()
    for spec, v in res.items():
        print(f"[tiles {spec}] three block shapes {sum(v[:6]) / 2:.4f} ms, "
              f"100x76 {sum(v[6:]) / 2:.4f} ms (mean of two passes)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--tag", default="port")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tiles", action="append", default=[])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_specblock_wide: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock as csb)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[{args.tag}] port from {os.path.dirname(csb.__file__)}; {card}")
    if args.tiles:
        time_tiles(csb, args.tiles, dev, dtype)
    else:
        time_wrapper(csb, args.tag, args.profile, dev, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
