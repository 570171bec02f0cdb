"""The halo convolution's two shapes under cuDNN's TF32 switch, on one
NVIDIA GPU:

    python3 scripts/torch_halo_tf32.py

``parallel.seqparallel.halo_conv1d`` convolves each rank's part of the
time axis, padded with its neighbours' samples, where the unsharded
function convolves the whole sequence: the same outputs from inputs of
another length, so cuDNN may choose another algorithm for each.  This
script computes both on one card, without a process group (each rank's
padded part is cut from the whole sequence, as the halo exchange builds
it), for K = 3, 5, 7, 9 at two shapes: a world of 4 with 64 samples and
8 → 4 channels a rank, and chip_smoke phase 16's halo check (256 samples,
16 → 8 channels) at worlds 2 and 4.  For each it prints, with cuDNN's
TF32 off and then on, the largest difference of a rank's part from the
unsharded output, absolute and relative to the unsharded maximum.  The
inputs are drawn as phase 16 draws them (``torch.Generator`` seeded with
K).  Ends with one JSON line and the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

KS = (3, 5, 7, 9)
# (name, world, samples a rank, input channels, output channels)
SHAPES = (("w4_t64_c8x4", 4, 64, 8, 4),
          ("w2_t256_c16x8", 2, 256, 16, 8),
          ("w4_t256_c16x8", 4, 256, 16, 8))


def _conv(xp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'VALID' conv of (B, T, Cin) by (K, Cin, Cout), channels last."""
    return F.conv1d(xp.transpose(1, 2), kernel.permute(2, 1, 0)).transpose(1, 2)


def halo_diffs(world: int, tl: int, cin: int, cout: int, k: int,
               dev: torch.device) -> dict:
    """Each rank's padded part against the unsharded 'SAME' conv: the
    largest |difference| over the ranks, absolute and relative."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(2, tl * world, cin, generator=gen).to(dev)
    kernel = torch.randn(k, cin, cout, generator=gen).to(dev)
    h = k // 2
    xp = F.pad(x, (0, 0, h, h))
    full = _conv(xp, kernel)
    worst = 0.0
    for s in range(world):
        part = _conv(xp[:, s * tl:(s + 1) * tl + 2 * h], kernel)
        worst = max(worst, float((part - full[:, s * tl:(s + 1) * tl])
                                 .abs().max()))
    return {"abs": worst, "rel": worst / float(full.abs().max())}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    saved = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for name, world, tl, cin, cout in SHAPES:
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                out[f"{name}_tf32_{'on' if tf32 else 'off'}"] = {
                    k: halo_diffs(world, tl, cin, cout, k, dev) for k in KS}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for key, by_k in out.items():
        print(f"[halo] {key}: " + ", ".join(
            f"K={k} abs {d['abs']:.3e} rel {d['rel']:.3e}"
            for k, d in by_k.items()))
    print(json.dumps({"halo_tf32": out}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
