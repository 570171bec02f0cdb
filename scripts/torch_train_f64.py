"""How far float32 training gradients sit from float64, on the card and on
the CPU.

    python3 scripts/torch_train_f64.py [--batch 4] [--device cuda]

One float32 training step of ``entry.train_entry`` (full width, dropout
off, finite route, KLDiv + L2 1e-3) on the batch the device preprocessed:
its loss, gradients and updated BatchNorm running statistics on
``--device`` and on the CPU in float32, each against the same step on the
CPU in float64.  Prints the loss, the gradient norm's relative error,
the normwise error of all gradients, the worst single gradients (relative
to their tensor's max |g| plus 1e-6 of the model's largest) and the worst
running statistics (relative to their tensor's max).  This is the
evidence behind ``chip_smoke.py``'s TRAIN_* bounds.  float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _errors(name, loss, grads, stats, ref):
    loss64, grads64, stats64 = ref
    top = max(float(g.abs().max()) for g in grads64.values())
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    flat64 = torch.cat([g.reshape(-1) for g in grads64.values()])
    worst = sorted(((float((grads[k] - g).abs().max()
                           / (g.abs().max() + 1e-6 * top)), k)
                    for k, g in grads64.items()), reverse=True)[:5]
    bn = sorted(((float((stats[k] - v).abs().max() / v.abs().max()), k)
                 for k, v in stats64.items()), reverse=True)[:3]
    print(f"[train-f64] {name}: loss {loss:.8f} (float64 {loss64:.8f}, rel "
          f"{abs(loss - loss64) / abs(loss64):.2e}); gradient norm rel "
          f"{abs(float(flat.norm() - flat64.norm())) / float(flat64.norm()):.2e};"
          f" all gradients normwise {float((flat - flat64).norm() / flat64.norm()):.2e}")
    print(f"[train-f64] {name}: worst gradients "
          + ", ".join(f"{k} {e:.2e}" for e, k in worst))
    print(f"[train-f64] {name}: worst running statistics "
          + ", ".join(f"{k} {e:.2e}" for e, k in bn))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        preprocess_batch, train_entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.models import (
        Dropout)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.steps import (
        loss_and_grads)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "CPU"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    _, state, raw = train_entry(device=args.device, batch=args.batch,
                                dtype=None)
    for m in state.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    batch = preprocess_batch(*raw)
    cpu = {k: v.cpu() for k, v in batch.items()}
    runs = {}
    for name, model, b in (
            (args.device, state.model, batch), ("cpu float32", state.model, cpu),
            ("cpu float64", state.model, {k: v.double() for k, v in cpu.items()})):
        model = copy.deepcopy(model)
        if name != args.device:
            model = model.cpu()
        if name == "cpu float64":
            model = model.double()
        loss, _, grads = loss_and_grads(model, b, None, l2_lambda=1e-3)
        names = [n for n, _ in model.named_parameters()]
        runs[name] = (float(loss),
                      {n: g.detach().cpu().double()
                       for n, g in zip(names, grads)},
                      {k: v.cpu().double()
                       for k, v in model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})
    print(f"[train-f64] one float32 step, B={args.batch}, full width, "
          f"against the CPU in float64 [{card}]")
    for name in (args.device, "cpu float32"):
        _errors(name, *runs[name], runs["cpu float64"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
