"""The reference repository's ``SpectrogramCNN``: blocks of conv3x3+ReLU
×3 → 2×2 pool → BN, plus a bilinear-resized 1×1 conv skip; global mean →
FC → log-softmax.  Widths and pools come from the configuration's
``spectrogram.widths`` and ``spectrogram.pools``."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..models import Params, Round, Shapes, _bn, _bn_shapes, _conv, _ident, _linear, conv_flops


def shapes(spec: dict, pre: str, num_classes: int) -> Shapes:
    s: Shapes = {}
    cin = 3
    for i, c in enumerate(spec["widths"]):
        b = f"{pre}block{i + 1}"
        for j, ci in enumerate((cin, c, c)):
            s[f"{b}.conv{j + 1}.weight"] = (c, ci, 3, 3)
            s[f"{b}.conv{j + 1}.bias"] = (c,)
        s.update(_bn_shapes(f"{b}.bn", c))
        s[f"{b}.conv1x1.weight"] = (c, cin, 1, 1)
        s[f"{b}.conv1x1.bias"] = (c,)
        cin = c
    s[f"{pre}fc.weight"] = (num_classes, cin)
    s[f"{pre}fc.bias"] = (num_classes,)
    return s


def forward(p: Params, x: torch.Tensor, spec: dict, pre: str,
            q: Round = _ident) -> torch.Tensor:
    pools = spec["pools"]
    if len(pools) != len(spec["widths"]):
        raise ValueError(f"{len(spec['widths'])} widths, {len(pools)} pools")
    for i, pool in enumerate(pools):
        b = f"{pre}block{i + 1}"
        identity = x
        for j in range(3):
            x = F.relu(_conv(p, f"{b}.conv{j + 1}", x, q, padding=1))
        x = {"max": F.max_pool2d, "avg": F.avg_pool2d}[pool](x, 2)
        x = _bn(p, f"{b}.bn", x)
        identity = F.interpolate(identity, size=x.shape[2:], mode="bilinear",
                                 align_corners=False)
        x = q(x + _conv(p, f"{b}.conv1x1", identity, q))
    return F.log_softmax(_linear(p, f"{pre}fc", x.mean(dim=(2, 3)), q), dim=-1)


def blocks(spec: dict, h: int, w: int
           ) -> List[Tuple[int, int, int, int, float]]:
    """(H, W, Cin, Cout, operations) of each block: three 3×3 convs at (H,
    W) and the 1×1 skip at the pooled plane."""
    out, cin = [], 3
    for c in spec["widths"]:
        f = conv_flops(h, w, cin, c, 3, 3) + 2 * conv_flops(h, w, c, c, 3, 3)
        f += conv_flops(h // 2, w // 2, cin, c, 1, 1)
        out.append((h, w, cin, c, f))
        h, w, cin = h // 2, w // 2, c
    return out


def flops(spec: dict, h: int, w: int, num_classes: int) -> float:
    return (sum(b[-1] for b in blocks(spec, h, w))
            + 2.0 * spec["widths"][-1] * num_classes)
