"""Plain float32 forward passes of the benchmark's models, written from the
published architectures as functions of a weight dictionary.

* :func:`eegnet_attention`: ``EEGNetAttentionRegularized`` of the reference
  repository (KC-decoder/Multimodal-Brain-Pattern-Identification_XAI), in
  its canonical order: temporal conv (1, 64) → BN → depthwise (37, 1) conv
  → BN → ELU → avgpool (1, 4) → separable conv (1, 16) → BN → ELU → avgpool
  (1, 8) → single-head attention over the time tokens → dense 128 → dense 6
  → log-softmax.
* the spectrogram branch that a configuration names, from
  ``branches/<model>.py``.
* :func:`fusion`: concatenated branch log-probs → FC 128 → ReLU → FC 6 →
  log-softmax.

Every size comes from the configuration.  Evaluation mode throughout
(BatchNorm on running statistics, dropout off).  Each ``*_shapes``
function lists the weight names and shapes its forward reads.  ``q`` is a
rounding applied to the inputs and weights of every conv and linear layer
and to each block's output (identity for the reference; a lower precision
for the control).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from . import branches

Shapes = Dict[str, Tuple[int, ...]]
Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]

BN_EPS = 1e-5
SPEC_PRE = "spectrogram_model."


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def conv_flops(h_out: int, w_out: int, cin: int, cout: int, kh: int, kw: int,
               groups: int = 1) -> float:
    """Operations of a conv at an (h_out, w_out) output, a multiply-add
    counted as 2."""
    return 2.0 * h_out * w_out * cout * (cin // groups) * kh * kw


def _bn_shapes(name: str, c: int) -> Shapes:
    return {f"{name}.{k}": (c,) for k in
            ("weight", "bias", "running_mean", "running_var")}


def _bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0,
                        BN_EPS)


def _conv(p: Params, name: str, x: torch.Tensor, q: Round, stride: int = 1,
          padding=0, groups: int = 1, bias: bool = True) -> torch.Tensor:
    b = p.get(f"{name}.bias") if bias else None
    return F.conv2d(q(x), q(p[f"{name}.weight"]), None if b is None else q(b),
                    stride, padding, 1, groups)


def _linear(p: Params, name: str, x: torch.Tensor, q: Round) -> torch.Tensor:
    return F.linear(q(x), q(p[f"{name}.weight"]), q(p[f"{name}.bias"]))


# ---------------------------------------------------------------------------
# EEG branch

def eegnet_shapes(pre: str = "eeg_model.", chans: int = 37,
                  samples: int = 3000, kern_length: int = 64, f1: int = 8,
                  d: int = 2, f2: int = 16, num_classes: int = 6) -> Shapes:
    s = {f"{pre}conv1.weight": (f1, 1, 1, kern_length)}
    s.update(_bn_shapes(f"{pre}batchnorm1", f1))
    s[f"{pre}depthwiseConv.weight"] = (f1 * d, 1, chans, 1)
    s.update(_bn_shapes(f"{pre}batchnorm2", f1 * d))
    s[f"{pre}separableConv.weight"] = (f2, f1 * d, 1, 16)
    s.update(_bn_shapes(f"{pre}batchnorm3", f2))
    for proj in ("query", "key", "value"):
        s[f"{pre}attention_layer.{proj}.weight"] = (f2, f2)
        s[f"{pre}attention_layer.{proj}.bias"] = (f2,)
    s[f"{pre}dense1.weight"] = (128, f2 * (samples // 32))
    s[f"{pre}dense1.bias"] = (128,)
    s[f"{pre}dense2.weight"] = (num_classes, 128)
    s[f"{pre}dense2.bias"] = (num_classes,)
    return s


def _same_pad(k: int) -> Tuple[int, int, int, int]:
    """PyTorch's ``padding="same"`` along the last axis for a kernel of k
    taps: (k − 1)//2 on the left, k//2 on the right."""
    return ((k - 1) // 2, k // 2, 0, 0)


def eegnet_attention(p: Params, x: torch.Tensor, pre: str = "eeg_model.",
                     q: Round = _ident) -> torch.Tensor:
    """(B, 1, chans, T) → log-probs (B, n)."""
    w1 = p[f"{pre}conv1.weight"]
    f1 = w1.shape[0]
    x = F.conv2d(F.pad(q(x), _same_pad(w1.shape[-1])), q(w1))
    x = _bn(p, f"{pre}batchnorm1", x)
    x = F.conv2d(q(x), q(p[f"{pre}depthwiseConv.weight"]), groups=f1)
    x = F.avg_pool2d(F.elu(_bn(p, f"{pre}batchnorm2", x)), (1, 4))
    ws = p[f"{pre}separableConv.weight"]
    x = F.conv2d(F.pad(q(x), _same_pad(ws.shape[-1])), q(ws))
    x = F.avg_pool2d(F.elu(_bn(p, f"{pre}batchnorm3", x)), (1, 8))
    tokens = x.flatten(2).transpose(1, 2)                    # (B, T', F2)
    att = f"{pre}attention_layer"
    qq, kk, vv = (_linear(p, f"{att}.{n}", tokens, q)
                  for n in ("query", "key", "value"))
    scores = qq @ kk.transpose(-2, -1) * qq.shape[-1] ** -0.5
    tokens = torch.softmax(scores, dim=-1) @ vv
    x = tokens.transpose(1, 2).flatten(1)                    # channel-major
    x = _linear(p, f"{pre}dense2", _linear(p, f"{pre}dense1", x, q), q)
    return F.log_softmax(x, dim=-1)


# ---------------------------------------------------------------------------
# fusion

def fusion_shapes(cfg: dict) -> Shapes:
    """Every weight of a configuration's late-fusion model: the EEG branch
    from ``cfg["eeg"]``, the spectrogram branch that ``cfg["spectrogram"]
    ["model"]`` names (``branches/<model>.py``) and the head."""
    e, n = cfg["eeg"], cfg["num_classes"]
    s = eegnet_shapes(chans=e["chans"], samples=e["samples"],
                      kern_length=e["kern_length"], f1=e["f1"], d=e["d"],
                      f2=e["f2"], num_classes=n)
    spec = cfg["spectrogram"]
    s.update(branches.get(spec["model"]).shapes(spec, SPEC_PRE, n))
    s.update({"fc1.weight": (128, 2 * n), "fc1.bias": (128,),
              "fc2.weight": (n, 128), "fc2.bias": (n,)})
    return s


def spectrogram_branch(p: Params, x: torch.Tensor, cfg: dict,
                       q: Round = _ident) -> torch.Tensor:
    spec = cfg["spectrogram"]
    return branches.get(spec["model"]).forward(p, x, spec, SPEC_PRE, q)


def fusion_head(p: Params, eeg_logp: torch.Tensor, spec_logp: torch.Tensor
                ) -> torch.Tensor:
    x = torch.cat([eeg_logp, spec_logp.float()], dim=-1)
    x = F.linear(F.relu(F.linear(x, p["fc1.weight"], p["fc1.bias"])),
                 p["fc2.weight"], p["fc2.bias"])
    return F.log_softmax(x, dim=-1)


def fusion(p: Params, eeg: torch.Tensor, spec: torch.Tensor, cfg: dict,
           q_spec: Round = _ident, q_eeg: Round = _ident) -> torch.Tensor:
    """Late fusion: (B, 1, chans, T), (B, 3, H, W) → log-probs (B, n).
    ``q_spec`` and ``q_eeg`` round inside each branch."""
    return fusion_head(p, eegnet_attention(p, eeg, q=q_eeg),
                       spectrogram_branch(p, spec, cfg, q_spec))
