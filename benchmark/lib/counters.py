"""Operations and bytes computed from shapes: the yardstick of the roofline
and MFU metrics.  A multiply-add counts 2 operations; elementwise work,
pooling, normalisation and softmax are left out (they are small beside
the convolutions and would only raise the shares).  Every function gives
the count for ONE window unless it takes a batch.

Kernels: #2 is the IIR cascade with the fused 4-tap mean and ::4
(``chunked_scan_kernel<…, MeanOut>``): 9 operations a section a sample
and 1 a sample for the mean, x read once (float32) and y written once
(T/4 samples).  #3 is the fused conv3x3+ReLU ×3 → 2×2 pool block
(``specblock_bf16_tc_kernel``): x read once, the three kernels' weights
and biases read once, the pooled map written once, in the storage type.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ..reference import branches
from ..reference.models import conv_flops as conv

Flops = Dict[str, float]          # operations by the precision they run in


# ---------------------------------------------------------------------------
# models

def spectrogram_branch(cfg: dict, h: int, w: int) -> float:
    """The spectrogram branch that the configuration names, counted by its
    reference file (``reference/branches/<model>.py``)."""
    spec = cfg["spectrogram"]
    return branches.get(spec["model"]).flops(spec, h, w, cfg["num_classes"])


def eegnet(chans: int = 37, samples: int = 3000, kern_length: int = 64,
           f1: int = 8, d: int = 2, f2: int = 16,
           reassociated: bool = True, num_classes: int = 6) -> float:
    """``EEGNetAttentionRegularized``.  ``reassociated``: the serving stem
    (channels contracted first, then the temporal conv a group), as the
    program runs it in evaluation mode; otherwise the canonical stem."""
    fd = f1 * d
    if reassociated:
        f = 2.0 * fd * chans * samples + 2.0 * fd * samples * kern_length
    else:
        f = 2.0 * f1 * chans * samples * kern_length + 2.0 * fd * chans * samples
    t4, t32 = samples // 4, samples // 32
    f += 2.0 * f2 * fd * 16 * t4                            # separable conv
    f += 3 * 2.0 * t32 * f2 * f2 + 2 * 2.0 * t32 * t32 * f2  # attention
    f += 2.0 * f2 * t32 * 128 + 2.0 * 128 * num_classes      # dense 1, 2
    return f


def eegnet_of(cfg: dict) -> float:
    e = cfg["eeg"]
    return eegnet(e["chans"], e["samples"], e["kern_length"], e["f1"], e["d"],
                  e["f2"], num_classes=cfg["num_classes"])


def fusion_head(num_classes: int = 6) -> float:
    return 2.0 * 2 * num_classes * 128 + 2.0 * 128 * num_classes


# ---------------------------------------------------------------------------
# preprocessing and kernels

def iir(lanes: int, T: int, sections: int) -> Tuple[float, float]:
    """#2 over ``lanes`` × T: (operations, bytes)."""
    return lanes * T * (9.0 * sections + 1.0), 4.0 * lanes * (T + T // 4)


def eeg_chain(cfg: dict, T: int) -> float:
    """The finite route for one window: the cascade of both bandpasses on
    the raw lanes (#2) and the (chans, raw) montage on the T/4 output."""
    e = cfg["eeg"]
    sections = e["first_bandpass_order"] + e["denoise_bandpass_order"]
    lanes = e["raw_channels"]
    return iir(lanes, T, sections)[0] + 2.0 * e["chans"] * lanes * (T // 4)


def spectrogram_chain(h: int, w: int) -> float:
    """The two dense operators (M_h @ x) @ M_w."""
    return 2.0 * h * h * w + 2.0 * h * w * w


def specblock(batch: int, h: int, w: int, cin: int, cout: int,
              elem_bytes: int = 2) -> Tuple[float, float]:
    """#3 for one block call: (operations, bytes)."""
    ops = batch * (conv(h, w, cin, cout, 3, 3) + 2 * conv(h, w, cout, cout, 3, 3))
    weights = 9 * (cin * cout + 2 * cout * cout) + 3 * cout
    io = batch * (h * w * cin + (h // 2) * (w // 2) * cout)
    return ops, float(elem_bytes * (io + weights))


# ---------------------------------------------------------------------------
# whole requests, by precision

def _add(acc: Flops, prec: str, f: float) -> None:
    acc[prec] = acc.get(prec, 0.0) + f


def score(cfg: dict, prog: dict, batch: int, n_points: int,
          plane: Sequence[int]) -> Flops:
    """One scoring request: both chains, both branches and the head."""
    h, w = plane
    acc: Flops = {}
    _add(acc, "f32", batch * (eeg_chain(cfg, n_points) + eegnet_of(cfg)
                              + fusion_head(cfg["num_classes"])))
    _add(acc, _prec(prog["spec_chain_dtype"]), batch * spectrogram_chain(h, w))
    _add(acc, _prec(prog["spec_model_dtype"]),
         batch * spectrogram_branch(cfg, h, w))
    return acc


def explain(cfg: dict, prog: dict, batch: int, n_points: int,
            plane: Sequence[int], ig_steps: int) -> Flops:
    """One explanation request: the chains, the fused model's argmax
    forward, saliency (a forward and the input gradient, which costs what
    the forward does), the EEG branch's argmax forward and ``ig_steps``
    forward and input-gradient passes of the EEG branch."""
    h, w = plane
    eeg_f = eegnet_of(cfg)
    full = (eeg_f + spectrogram_branch(cfg, h, w)
            + fusion_head(cfg["num_classes"]))
    total = (eeg_chain(cfg, n_points) + spectrogram_chain(h, w) + 3 * full
             + eeg_f * (1 + 2 * ig_steps))
    return {_prec(prog["spec_model_dtype"]): batch * total}


def _prec(dtype_name: str) -> str:
    return {"bfloat16": "bf16", "float32": "f32"}[dtype_name]


def least_seconds(flops: Flops, peaks: Dict[str, float]) -> float:
    """The least time the operations need, each at the peak of its
    precision."""
    return sum(f / peaks[p] for p, f in flops.items())
