"""Holds the fused block's float32 cases of the card tests against float64.

    python3 scripts/torch_specblock_f64.py

For each float32 case of ``tests/test_torch_cuda_kernels.py``'s
``test_specblock_matches_plain`` at Cout 64/128/256 (the same seeded
inputs), runs the fused block, the plain float32 chain (cuDNN, TF32 off)
and the chain in float64 on one card, and prints each pair's largest
|difference| and its largest ratio to the test's bound rtol = atol =
1e-5·scale (1.0 = at the bound).  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_specblock_f64: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from multimodal_brain_pattern_identification_xai_tpu_torch.ops import (
        cuda_specblock as csb)
    from test_torch_cuda_kernels import (_SPECBLOCK_CASES, _block_args,
                                         _chain_f64)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    worst = {}
    for case in _SPECBLOCK_CASES:
        dtype, cin, cout, h, w, pool, batch, scale, wscale = case.values
        if dtype != torch.float32 or cout not in csb.WIDE_COUTS:
            continue
        x, ks, bs = _block_args(cin, cout, h, w, b=batch, wscale=wscale)
        xd, kd, bd = (x * scale).to(dev), [k.to(dev) for k in ks], [
            b.to(dev) for b in bs]
        out = {"kernel": csb.fused_specblock_convpool(
                   xd, kd, bd, pool=pool, dtype=dtype).double(),
               "chain": csb._plain_convpool(xd, kd, bd, pool,
                                            torch.float32).double(),
               "f64": _chain_f64(xd, kd, bd, pool)}
        tol = 1e-5 * scale + 1e-5 * out["f64"].abs()
        line = []
        for a, b in (("kernel", "f64"), ("chain", "f64"),
                     ("kernel", "chain")):
            d = (out[a] - out[b]).abs()
            r = float((d / tol).max())
            worst[a, b] = max(worst.get((a, b), 0.0), r)
            line.append(f"{a}-{b} max abs {float(d.max()):.3e} "
                        f"({r:.3f} of the bound)")
        print(f"[f64] {case.id}: " + "; ".join(line), flush=True)
    print("[f64] worst, of the bound: " + ", ".join(
        f"{a}-{b} {r:.3f}" for (a, b), r in worst.items()) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
