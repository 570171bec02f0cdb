"""Where the fused spectrogram block's time (and, in f32, error) go, on
one card.

    python3 scripts/torch_specblock_ablate.py [--batch 256] [--dtype bfloat16]

Builds ``csrc/specblock.cu`` as it is and in variants, each with one part
of the tensor-core kernel of the storage type (``specblock_tc_kernel``,
f32; ``specblock_bf16_tc_kernel``, bf16) changed by a textual patch of the
source (a patch that no longer matches raises):

- ``one_accumulator``: the three 3xTF32 products chained in one tensor-core
  accumulator, instead of the small products in their own and each k-step's
  hi*hi added on the CUDA cores;
- ``no_weight_restage``: conv2's and conv3's weights not staged (conv1's
  stay in place; bf16: their cp.async copies left out),
  ``no_input_stage``: the input tile not staged, ``no_pool``: no pool pass
  or output store, ``no_mma_loop``: the implicit-GEMM loops of the
  tensor-core stages removed (their epilogues stay).  These compute wrong
  results: they are timed only, and the kernel's time minus theirs is what
  the removed part costs.  bf16 has no ``one_accumulator`` variant.

For blocks 1 and 2 at the main path's shapes (inputs from the same seed as
``chip_smoke.py``) it prints each variant's time (CUDA events, the variants
run forward then backward, five calls each), and for the kernel, the
one-accumulator variant and cuDNN's f32 chain (TF32 off) the error against
a float64 chain on the first 32 samples, at the inputs and at 100x them:
max |d|, and max(|d| - 1e-5 |ref|), which must stay under the atol of
``rtol = atol = 1e-5``.  bf16 instead holds the kernel against the plain
bf16 chain (max |d| over the chain's max) and times cuDNN's bf16 chain.
Ends with one JSON line and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_MMA_SPLIT = """\
          mma_tf32(cor[i][n], al, bh[n][0], bh[n][1]);
          mma_tf32(cor[i][n], ah, bl[n][0], bl[n][1]);
          float p[4];
          mma_tf32_z(p, ah, bh[n][0], bh[n][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][n][j] += p[j];
"""
_MMA_ONE = """\
          mma_tf32(acc[i][n], al, bh[n][0], bh[n][1]);
          mma_tf32(acc[i][n], ah, bl[n][0], bl[n][1]);
          mma_tf32(acc[i][n], ah, bh[n][0], bh[n][1]);
"""
_INPUT_STAGE = """\
  if (cin % 4)
    stage_input(x, buf0, kP0, b, y0, x0, H, W, cin);
  else
    stage_input4(x, buf0, b, y0, x0, H, W, cin);
"""
VARIANTS = {
    "kernel": [],
    "one_accumulator": [(_MMA_SPLIT, _MMA_ONE)],
    "no_weight_restage": [("  stage_split<C>(w2, C, swh, swl);\n", ""),
                          ("  stage_split<C>(w3, C, swh, swl);\n", "")],
    "no_input_stage": [(_INPUT_STAGE, "")],
    "no_pool": [("  pool_store<C, float>(bufa, out, b, y0, x0, H, W, "
                 "pool_max);\n", "")],
    "no_mma_loop": [("for (int k0 = 0; k0 < cin; k0 += 8) {",
                     "for (int k0 = 0; k0 < 0; k0 += 8) {")],
}
ACCURATE = ("kernel", "one_accumulator")
VARIANTS_BF16 = {
    "kernel": [],
    "no_weight_restage": [
        ("  stage_pairs_async<C>(w2, RC, swb);\n", ""),
        ("  stage_pairs_async<C>(w3, RC, swa);   // lands while conv2 "
         "computes\n", "")],
    "no_input_stage": [("  stage_input_pairs(x, buf0, b, y0, x0, H, W, cin);\n",
                        "")],
    "no_pool": [("  pool_store<C, __nv_bfloat16>(c3, out, b, y0, x0, H, W, "
                 "pool_max);\n", "")],
    "no_mma_loop": [("j0 + 8 <= R;", "j0 + 8 <= 0;"),
                    ("if constexpr (R % 8 != 0) step8",
                     "if constexpr (false) step8"),
                    ("j0 + 8 <= rows;", "j0 + 8 <= 0;"),
                    ("if (rows % 8) step8", "if (false) step8")],
}


def build_variants(variants: dict, tag: str) -> dict:
    from multimodal_brain_pattern_identification_xai_tpu_torch import _build
    src = (_build.CSRC / "specblock.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not match once: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"specblock_{tag}_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libspecblock_{tag}_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.specblock_convpool.argtypes = ([ctypes.c_void_p] * 6
                                           + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def run(lib, x, ks, bias, pool):
    """One launch on x of its storage type; ``ks``: HWIO f32, or the
    packed words of ``_pack_bf16_pairs`` for bf16."""
    b, h, w, cin = x.shape
    co = ks[0].shape[-1]
    out = torch.empty((b, h // 2, w // 2, co), dtype=x.dtype, device=x.device)
    rc = lib.specblock_convpool(
        x.data_ptr(), ks[0].data_ptr(), ks[1].data_ptr(), ks[2].data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, w, cin, co,
        int(pool == "max"), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"specblock_convpool: CUDA error {rc}")
    return out


def cuda_ms(fn, reps: int = 5) -> float:
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


def chain(x, ks, bs, pool, dtype):
    """cuDNN's conv ×3 + ReLU + pool on NCHW in ``dtype``; NHWC out."""
    h = x.to(dtype).permute(0, 3, 1, 2).contiguous()
    for k, b in zip(ks, bs):
        h = torch.relu(F.conv2d(h, k.to(dtype).permute(3, 2, 0, 1), b.to(dtype),
                                padding=1))
    h = F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return h.permute(0, 2, 3, 1)


def errors(got, ref) -> dict:
    d = (got.double() - ref).abs()
    return {"max_abs": float(d.max()),
            "excess": float((d - 1e-5 * ref.abs()).max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_specblock_ablate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.dtype == "bfloat16":
        return main_bf16(args.batch, card)
    libs = build_variants(VARIANTS, "f32")
    result = {}
    for name, cin, co, h, w, pool in (("block1", 3, 16, 400, 300, "max"),
                                      ("block2", 16, 32, 200, 150, "avg")):
        x, ks, bs = inputs(args.batch, cin, co, h, w)
        bias = torch.stack(bs).contiguous()
        times = {n: 0.0 for n in libs}
        for n in list(libs) + list(libs)[::-1]:
            times[n] += cuda_ms(lambda: run(libs[n], x, ks, bias, pool)) / 2
        times["cudnn_f32"] = cuda_ms(lambda: chain(x, ks, bs, pool,
                                                   torch.float32))
        rec = {"ms": times, "cost_ms": {
            part: times["kernel"] - times[f"no_{part}"]
            for part in ("weight_restage", "input_stage", "pool",
                         "mma_loop")}}
        for scale in (1.0, 100.0):
            xs = (x[:32] * scale).contiguous()
            ref = chain(xs, ks, bs, pool, torch.float64)
            got = {n: run(libs[n], xs, ks, bias, pool) for n in ACCURATE}
            got["cudnn_f32"] = chain(xs, ks, bs, pool, torch.float32)
            rec[f"vs_f64_x{scale:g}"] = {n: errors(y, ref)
                                        for n, y in got.items()}
        ref = chain(x, ks, bs, pool, torch.float32).double()
        rec["vs_cudnn_f32"] = {n: errors(run(libs[n], x, ks, bias, pool), ref)
                               for n in ACCURATE}
        result[name] = rec
        print(f"[ablate] {name} ({args.batch},{h},{w},{cin})->{co} {pool}: "
              + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
              + f" [{card}]")
        print(f"[ablate] {name} cost of each part (kernel minus variant): "
              + ", ".join(f"{p} {t:.3f} ms"
                          for p, t in rec["cost_ms"].items()))
        for key in ("vs_f64_x1", "vs_f64_x100", "vs_cudnn_f32"):
            print(f"[ablate] {name} {key}: " + ", ".join(
                f"{n} max|d| {e['max_abs']:.3e} excess {e['excess']:.3e}"
                for n, e in rec[key].items()))
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"specblock_ablate": result, "batch": args.batch}))
    print(card)
    return 0


def inputs(batch, cin, co, h, w):
    """x, HWIO kernels and biases from chip_smoke.py's seed."""
    rng = np.random.default_rng(4)
    mk = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                    dtype=torch.float32, device="cuda")
    ks = [mk(3, 3, ci, co) * 0.2 for ci in (cin, co, co)]
    bs = [mk(co) * 0.1 for _ in range(3)]
    return mk(batch, h, w, cin), ks, bs


def main_bf16(batch: int, card: str) -> int:
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    libs = build_variants(VARIANTS_BF16, "bf16")
    result = {}
    for name, cin, co, h, w, pool in (("block1", 3, 16, 400, 300, "max"),
                                      ("block2", 16, 32, 200, 150, "avg")):
        x, ks, bs = inputs(batch, cin, co, h, w)
        x = x.to(torch.bfloat16)
        ws = [cuda_specblock._pack_bf16_pairs(k) for k in ks]
        bias = torch.stack(bs).contiguous()
        times = {n: 0.0 for n in libs}
        for n in list(libs) + list(libs)[::-1]:
            times[n] += cuda_ms(lambda: run(libs[n], x, ws, bias, pool)) / 2
        times["cudnn_bf16"] = cuda_ms(lambda: chain(x, ks, bs, pool,
                                                    torch.bfloat16))
        plain = cuda_specblock._chain_convpool(x, ks, bs, pool,
                                               torch.bfloat16).double()
        got = run(libs["kernel"], x, ws, bias, pool).double()
        rec = {"ms": times, "cost_ms": {
            part: times["kernel"] - times[f"no_{part}"]
            for part in ("weight_restage", "input_stage", "pool",
                         "mma_loop")},
            "vs_plain_bf16_rel": float((got - plain).abs().max()
                                       / plain.abs().max())}
        result[name] = rec
        print(f"[ablate] bf16 {name} ({batch},{h},{w},{cin})->{co} {pool}: "
              + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items())
              + f" [{card}]")
        print(f"[ablate] bf16 {name} cost of each part (kernel minus "
              f"variant): " + ", ".join(f"{p} {t:.3f} ms"
                                        for p, t in rec["cost_ms"].items())
              + f"; kernel vs the plain bf16 chain "
              f"{rec['vs_plain_bf16_rel']:.2e} of its max")
        del x, plain, got
        torch.cuda.empty_cache()
    print(json.dumps({"specblock_ablate": result, "batch": batch,
                      "dtype": "bfloat16"}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
