"""Where the time goes in the PyTorch port's training step on one card.

    python3 scripts/torch_profile_train.py [--batch 256]
        [--dtype bfloat16|float32] [--route finite|nan] [--top 20]
        [--trace trace.json]

Builds ``entry.train_entry`` (the JAX bench's ``--train`` program: raw
windows → both preprocessing chains → forward + KLDiv + L2 → backward →
Adam, full-width model, Kaiming weights from seed 0), warms it up, then
prints the time of a step and of its parts (CUDA events: the
preprocessing alone, preprocessing + the forward and loss in training
mode, the whole step; the backward and the update are the difference),
the peak device memory, the unfused conv chain of spectrogram blocks 1-2
(conv3x3 + ReLU x3, pool: what a backward kernel for the fused block
would let training replace) forward and forward + backward, and a
``torch.profiler`` trace of three steps:
device-busy share, kernels a step, and the kernels grouped by name with
their launches a step and share of device time.  float32 with TF32 off,
as ``chip_smoke.py`` runs it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 3


def _ms(fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _block_chain(block, x):
    """A SpectrogramBlock's conv3x3 + ReLU x3 and pool, as training runs
    them (unfused, in x's type)."""
    import torch.nn.functional as F

    from multimodal_brain_pattern_identification_xai_tpu_torch.models.layers import (
        _conv)
    for conv in (block.conv1, block.conv2, block.conv3):
        x = F.relu(_conv(conv, x))
    pool = F.max_pool2d if block.pool_type == "max" else F.avg_pool2d
    return pool(x, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="bfloat16")
    ap.add_argument("--route", choices=("finite", "nan"), default="finite")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", help="write the Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        profiling)
    from multimodal_brain_pattern_identification_xai_tpu_torch.entry import (
        preprocess_batch, train_entry)
    from multimodal_brain_pattern_identification_xai_tpu_torch.train.losses import (
        kldiv_with_logits, l2_regularization)
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dtype = None if args.dtype == "float32" else torch.bfloat16
    finite = args.route == "finite"
    torch.cuda.reset_peak_memory_stats()
    step, state, (eeg, spec, y) = train_entry(
        device="cuda", batch=args.batch, dtype=dtype, assume_finite=finite)
    box = [state]

    def one():
        box[0], _ = step(box[0], eeg, spec, y)

    def pre():
        preprocess_batch(eeg, spec, y, assume_finite=finite)

    def pre_fwd():
        b = preprocess_batch(eeg, spec, y, assume_finite=finite)
        model = box[0].model
        model.train()
        loss = kldiv_with_logits(model(b["eeg"], b["spec"]), y)
        return loss + l2_regularization(model, 1e-3)

    step_ms = _ms(one, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre_ms, fwd_ms = _ms(pre), _ms(pre_fwd)
    print(f"[train-profile] {args.dtype}, {args.route} route, B={args.batch}: "
          f"step {step_ms:.3f} ms = {args.batch / step_ms * 1e3:.1f} "
          f"windows/s; preprocessing {pre_ms:.3f} ms, forward + loss "
          f"{fwd_ms - pre_ms:.3f} ms, backward + update "
          f"{step_ms - fwd_ms:.3f} ms (CUDA events); peak {peak:.2f} GiB "
          f"[{card}]")
    chain = []
    spec_model = box[0].model.spectrogram_model
    x = preprocess_batch(eeg, spec, y, assume_finite=finite)["spec"]
    x = x.to(dtype or torch.float32)
    for i, block in enumerate((spec_model.block1, spec_model.block2)):
        x = x.detach().requires_grad_(i > 0)
        fwd = lambda b=block, h=x: _block_chain(b, h)
        out = fwd()
        g = torch.randn_like(out)
        chain.append((_ms(fwd), _ms(lambda: torch.autograd.backward(
            fwd(), g))))
        x = out.detach()
    print(f"[train-profile] blocks 1-2 unfused conv chain (cuDNN, "
          f"{args.dtype}, B={args.batch}): forward "
          f"{chain[0][0]:.3f} + {chain[1][0]:.3f} ms, forward + backward "
          f"{chain[0][1]:.3f} + {chain[1][1]:.3f} = "
          f"{chain[0][1] + chain[1][1]:.3f} ms")
    prof = profiling.profile_kernels(one, reps=REPS, warmup=0)
    busy = prof.busy_ms
    print(f"[train-profile] wall {prof.wall_ms:.3f} ms/step (profiler on), "
          f"device busy {busy:.3f} ms ({100 * busy / prof.wall_ms:.1f}% of "
          f"wall), {prof.kernels:.0f} kernels + {prof.copies:.0f} copies a "
          f"step; cuDNN FFT conv {profiling.fft_conv_ms(prof):.3f} ms")
    for name, ms in sorted(prof.kernel_ms.items(),
                           key=lambda kv: -kv[1])[:args.top]:
        print(f"[train-profile] {ms:9.3f} ms/step {100 * ms / busy:5.1f}% "
              f"x{prof.kernel_calls[name]:4.0f}  {name[:140]}")
    if args.trace:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            one()
            torch.cuda.synchronize()
        p.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
