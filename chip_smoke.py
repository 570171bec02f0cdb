"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds every kernel from ``csrc/``, all sources at
              once; prints ptxas's register / shared-memory / spill lines;
3. kernels  — every kernel against its plain PyTorch version on the card
              (float32 with TF32 off; bf16 for the spectrogram block), at
              the main path's shapes, with the bounds of the JAX package's
              kernel tests;
4. main     — the serving entry at B=4 on cuda, NaN route (a NaN run in one
              channel of one window) and finite route, with every kernel's
              launch counter read around that run; log-probs held against
              the same forward on the CPU's plain versions;
5. timing   — the finite-route serving forward at B=256 (CUDA events),
              windows/s, and every kernel's time beside its plain
              version, its bound and the library call where one exists.

Output: a ``{"kernels": [...]}`` JSON line, the nvidia-smi line, then the
last line ``{"ok": true, "device": {...}}``.  Needs one card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
B_MAIN, B_TIME = 4, 256
LOGP_ATOL = 1e-3                 # GPU vs CPU log-probs (see main_path)
PKG = "multimodal_brain_pattern_identification_xai_tpu_torch"


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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


def phase_build(card: str) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch import _build
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock)
    t0 = time.perf_counter()
    _build.build(["iir", "specblock"])
    print(f"[build] nvcc iir.cu + specblock.cu in "
          f"{time.perf_counter() - t0:.1f} s (both in parallel; empty log "
          f"= already built)")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"[build] {name}: {line.strip()}")
    lib = cuda_specblock._lib()
    for cin, co in ((3, 16), (16, 32)):
        print(f"[build] specblock dynamic smem (cin={cin}, cout={co}): "
              f"{lib.specblock_smem_bytes(cin, co)} bytes")


def phase_kernels(card: str, dev) -> dict:
    """Kernel vs plain version on the card; returns per-kernel records
    with the error and the timings at B_TIME main-path shapes."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, cuda_specblock, iir)
    import torch.nn.functional as F

    bp5 = iir.butter_bandpass(0.5, 20.0, 200.0, 5)
    bp6 = iir.butter_bandpass(0.5, 20.0, 200.0, 6)
    casc = iir.cascade(bp5, bp6)
    notch = iir.iirnotch(60.0, 30.0, 200.0)
    rec = {}
    T = 10_000

    # --- #1 sosfilt, zero init: the NaN route's first bandpass, K=5 -------
    lanes = B_TIME * 20
    x = signal((lanes, T), 40, 1, dev)
    y = cuda_iir.sosfilt(bp5, x)
    t0 = time.perf_counter()
    y_plain = iir._sos_scan(x, bp5.sos)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    r = rel(y, y_plain)
    require(r < 2e-4, f"sosfilt K=5 rel err {r}")
    ms = cuda_ms(lambda: cuda_iir.sosfilt(bp5, x), 5)
    b, b_by = bound_ms(2 * lanes * T * 4, 9 * 5 * lanes * T)
    rec["iir_sosfilt"] = dict(err=max_abs(y, y_plain), ms=ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=b_by,
                              library_ms=None)
    print(f"[kernels] iir_sosfilt K=5 ({lanes}, {T}): rel {r:.2e}, "
          f"{ms:.4f} ms (plain scan {plain_ms:.1f} ms, host clock), "
          f"bound {b:.4f} ms by {b_by} [{card}]")
    del x, y, y_plain

    # --- #1 with zi: filtfilt of the spectrogram notch, 400-sample lanes --
    xs = signal((B_MAIN * 300, 400), 5, 2, dev)
    got = cuda_iir.filtfilt(notch, xs)
    n_plain = cuda_iir.sosfilt.launches
    pad = 3 * max(len(notch.a), len(notch.b))          # scipy's default
    ext = torch.cat([2 * xs[..., :1] - xs[..., 1:pad + 1].flip(-1), xs,
                     2 * xs[..., -1:] - xs[..., -pad - 1:-1].flip(-1)], -1)
    zi = torch.as_tensor(iir._sos_zi(notch), dtype=torch.float32, device=dev)
    yp = iir._sos_scan(ext, notch.sos, zi * ext[..., :1, None]).flip(-1)
    yp = iir._sos_scan(yp, notch.sos, zi * yp[..., :1, None]).flip(-1)
    r = rel(got, yp[..., pad:pad + 400])
    require(cuda_iir.sosfilt.launches == n_plain, "plain filtfilt launched")
    require(r < 1e-3, f"filtfilt (zi mode) rel err {r}")
    print(f"[kernels] iir_sosfilt zi mode (filtfilt notch, {tuple(xs.shape)})"
          f": rel {r:.2e}")

    # --- #2 rolldec: K=11 (finite route) and K=6 (NaN route bp2) ---------
    for coeffs, k, lanes in ((casc, 11, B_TIME * 20), (bp6, 6, B_TIME * 38)):
        x = signal((lanes, T), 20, 3, dev)
        y = cuda_iir.sosfilt_rolldec(coeffs, x)
        t0 = time.perf_counter()
        y_scan = iir._sos_scan(x, coeffs.sos)
        y_plain = y_scan.reshape(lanes, T // 4, 4).mean(-1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del y_scan
        r = rel(y, y_plain)
        require(r < 2e-4, f"sosfilt_rolldec K={k} rel err {r}")
        ms = cuda_ms(lambda: cuda_iir.sosfilt_rolldec(coeffs, x), 5)
        b, b_by = bound_ms(lanes * T * 4 + lanes * T // 4 * 4,
                           9 * k * lanes * T + lanes * T)
        print(f"[kernels] iir_sosfilt_rolldec K={k} ({lanes}, {T}): rel "
              f"{r:.2e}, {ms:.4f} ms (plain scan {plain_ms:.1f} ms, host "
              f"clock), bound {b:.4f} ms by {b_by} [{card}]")
        if k == 11:
            rec["iir_sosfilt_rolldec"] = dict(
                err=max_abs(y, y_plain), ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=b_by, library_ms=None)
        del x, y, y_plain

    # --- #3 fused spec block: block 1 (max) and block 2 (avg) ------------
    tot = dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               t_bytes=0.0, t_ops=0.0)
    for name, cin, co, h, w, pool in (("block1", 3, 16, 400, 300, "max"),
                                      ("block2", 16, 32, 200, 150, "avg")):
        rng = np.random.default_rng(4)
        mk = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                        dtype=torch.float32, device=dev)
        ks = [mk(3, 3, ci, co) * 0.2 for ci in (cin, co, co)]
        bs = [mk(co) * 0.1 for _ in range(3)]
        x = mk(B_TIME, h, w, cin)
        fused = lambda dt=torch.float32, xx=x: \
            cuda_specblock.fused_specblock_convpool(xx, ks, bs, pool=pool,
                                                    dtype=dt)
        plain = lambda: cuda_specblock._plain_convpool(x, ks, bs, pool,
                                                       torch.float32)
        y, y_plain = fused(), plain()
        torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
        err = max_abs(y, y_plain)
        xs_ = x[:16]
        yb = fused(torch.bfloat16, xs_).float()
        tb = cuda_specblock._plain_convpool(xs_, ks, bs, pool, torch.float32)
        eb = (yb - tb).abs() / tb.abs().max()
        require(float(eb.max()) < 0.03 and float(eb.mean()) < 0.003,
                f"specblock {name} bf16 err max {float(eb.max())} "
                f"mean {float(eb.mean())}")
        del y, y_plain, yb, tb
        # library yardstick: cuDNN convs + pool on NCHW (never used by the port)
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = [k.permute(3, 2, 0, 1).contiguous() for k in ks]

        def library():
            hh = xn
            for wk, bk in zip(wn, bs):
                hh = F.relu(F.conv2d(hh, wk, bk, padding=1))
            return F.max_pool2d(hh, 2) if pool == "max" else F.avg_pool2d(hh, 2)
        ms = cuda_ms(fused, 5)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(library, 3)
        nbytes = (x.numel() + sum(k.numel() for k in ks) + 3 * co
                  + B_TIME * (h // 2) * (w // 2) * co) * 4
        flops = (2 * 9 * (cin * co + 2 * co * co) * B_TIME * h * w
                 + (3 if pool == "max" else 4) * B_TIME * (h // 2) * (w // 2) * co)
        b, b_by = bound_ms(nbytes, flops)
        print(f"[kernels] specblock_convpool {name} ({B_TIME},{h},{w},{cin})"
              f"->{co} {pool}: f32 max abs {err:.2e}, bf16 max "
              f"{float(eb.max()):.2e} mean {float(eb.mean()):.2e} (tensor "
              f"scale); {ms:.3f} ms (plain {plain_ms:.3f} ms, library "
              f"{lib_ms:.3f} ms), bound {b:.3f} ms by {b_by} [{card}]")
        tot["err"] = max(tot["err"], err)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += lib_ms
        tot["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        tot["t_ops"] += flops / F32_FLOP_PER_S * 1e3
        del x, xn
    tot["bound_ms"] = max(tot.pop("t_bytes"), tot["t_ops"])
    tot["bound_by"] = "operations" if tot.pop("t_ops") >= tot["bound_ms"] \
        else "bytes"
    rec["specblock_convpool"] = tot
    torch.cuda.empty_cache()
    return rec


def phase_main(card: str) -> dict:
    """The serving entry at B_MAIN on cuda, both routes; launch counts
    read around exactly that run; log-probs against the CPU run."""
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_iir, cuda_specblock)
    counters = {"iir_sosfilt": cuda_iir.sosfilt,
                "iir_sosfilt_rolldec": cuda_iir.sosfilt_rolldec,
                "specblock_convpool": cuda_specblock.fused_specblock_convpool}

    runs = {}
    for route in ("nan", "finite"):
        fwd, (eeg, spec) = entry(device="cuda", batch=B_MAIN,
                                 assume_finite=route == "finite")
        if route == "nan":
            eeg[1, 5, 2000:2300] = float("nan")   # one channel of one window
        runs[route] = (fwd, eeg, spec)

    for c in counters.values():
        c.launches = 0
    outs = {route: fwd(eeg, spec) for route, (fwd, eeg, spec) in runs.items()}
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    print(f"[main] launches on the main path (B={B_MAIN}, both routes): "
          f"{launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    # the same forward on the CPU: plain PyTorch versions throughout.
    # Bound: float32 on both sides, sums in other orders (cuDNN vs CPU
    # convolutions; the kernels vs the sequential scan), through a
    # random-weight network — 1e-3 on log-probs, as tests/test_torch_slice.py
    for route, (fwd, eeg, spec) in runs.items():
        cfwd, (ceeg, cspec) = entry(device="cpu", batch=B_MAIN,
                                    assume_finite=route == "finite")
        if route == "nan":
            ceeg[1, 5, 2000:2300] = float("nan")
        want = cfwd(ceeg, cspec)
        got = outs[route].cpu()
        require(got.shape == (B_MAIN, 6), f"{route}: shape {got.shape}")
        require(bool(torch.isfinite(got).all()), f"{route}: non-finite")
        err = float((got - want).abs().max())
        require(err < LOGP_ATOL, f"{route} route: GPU vs CPU log-probs {err}")
        print(f"[main] {route} route: log-probs {tuple(got.shape)} finite; "
              f"GPU vs CPU max abs {err:.2e} (bound {LOGP_ATOL})")
    return launches


def phase_timing(card: str) -> None:
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        entry)
    for route in ("finite", "nan"):
        fwd, (eeg, spec) = entry(device="cuda", batch=B_TIME,
                                 assume_finite=route == "finite")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fwd(eeg, spec), 10, warmup=2)
        print(f"[timing] serving forward, {route} route, B={B_TIME}: "
              f"{ms:.3f} ms/batch, {B_TIME / ms * 1e3:.1f} windows/s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
        del fwd, eeg, spec
        torch.cuda.empty_cache()


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
    card = phase_device()
    phase_build(card)
    rec = phase_kernels(card, dev)
    launches = phase_main(card)
    phase_timing(card)

    src = {"iir_sosfilt": (f"{PKG}/csrc/iir.cu",
                           "multimodal_brain_pattern_identification_xai_tpu/"
                           "ops/pallas_iir.py:165"),
           "iir_sosfilt_rolldec": (f"{PKG}/csrc/iir.cu",
                                   "multimodal_brain_pattern_identification_"
                                   "xai_tpu/ops/pallas_iir.py:254"),
           "specblock_convpool": (f"{PKG}/csrc/specblock.cu",
                                  "multimodal_brain_pattern_identification_"
                                  "xai_tpu/ops/pallas_specblock.py:242")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
               for name, r in rec.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
