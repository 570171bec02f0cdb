"""EfficientNetV2-B2 (Tan & Le 2021, arXiv:2104.00298) as Keras's
``EfficientNetV2B2`` scales B0's blocks.  The configuration's
``spectrogram`` section gives the stem, each stage's width and depth, the
head and the squeeze-excite ratio; each is held against what its
``width_coefficient`` and ``depth_coefficient`` make of B0's (Keras
``round_filters``, ``ceil(depth × repeats)``).  Kinds, kernels,
expansions and strides are B0's.  Departures from Keras, as the
configuration states them: symmetric (k − 1)//2 padding on strided
convs, BatchNorm eps 1e-5, no input rescaling layer."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..models import Params, Round, Shapes, _bn, _bn_shapes, _conv, _ident, _linear, conv_flops

#: EfficientNetV2-B0's blocks (Keras ``DEFAULT_BLOCKS_ARGS["efficientnetv2-b0"]``):
#: (kind, kernel, repeats, filters_in, filters_out, expand, stride, se)
V2_B0_BLOCKS = (
    ("fused", 3, 1, 32, 16, 1, 1, 0.0),
    ("fused", 3, 2, 16, 32, 4, 2, 0.0),
    ("fused", 3, 2, 32, 48, 4, 2, 0.0),
    ("mb", 3, 3, 48, 96, 4, 2, 0.25),
    ("mb", 3, 5, 96, 112, 6, 1, 0.25),
    ("mb", 3, 8, 112, 192, 6, 2, 0.25),
)
V2_B0_STEM, V2_B0_HEAD = 32, 1280

Block = Tuple[str, str, int, int, int, int, int, float]


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Keras ``round_filters``: scale, round to a multiple of 8, never
    below 90 % of the scaled width."""
    f = filters * width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * f else new)


def _check(spec: dict) -> None:
    wc, dc = spec["width_coefficient"], spec["depth_coefficient"]
    want = {"stem": _round_filters(V2_B0_STEM, wc),
            "head": _round_filters(V2_B0_HEAD, wc),
            "stage_widths": [_round_filters(b[4], wc) for b in V2_B0_BLOCKS],
            "stage_depths": [int(math.ceil(dc * b[2])) for b in V2_B0_BLOCKS]}
    for key, v in want.items():
        if spec[key] != v:
            raise ValueError(f"spectrogram.{key} is {spec[key]}, but width "
                             f"{wc} and depth {dc} make {v}")


def blocks(spec: dict) -> List[Block]:
    """Every block of the network: (name, kind, kernel, cin, cout, expand,
    stride, se ratio)."""
    _check(spec)
    out, cin = [], spec["stem"]
    for si, ((kind, k, _, _, _, e, s, se), cout, reps) in enumerate(zip(
            V2_B0_BLOCKS, spec["stage_widths"], spec["stage_depths"])):
        for j in range(reps):
            out.append((f"stage{si}_block{j}", kind, k, cin, cout, e,
                        s if j == 0 else 1, spec["se_ratio"] if se else 0.0))
            cin = cout
    return out


def shapes(spec: dict, pre: str, num_classes: int) -> Shapes:
    stem, head = spec["stem"], spec["head"]
    s: Shapes = {f"{pre}stem_conv.weight": (stem, 3, 3, 3)}
    s.update(_bn_shapes(f"{pre}BatchNorm_0", stem))
    bl = blocks(spec)
    for name, kind, k, cin, cout, e, _, se in bl:
        b, mid = f"{pre}{name}", cin * e
        if kind == "fused":
            s[f"{b}.fused_conv.weight"] = (mid if e != 1 else cout, cin, k, k)
            s.update(_bn_shapes(f"{b}.BatchNorm_0", mid if e != 1 else cout))
            if e != 1:
                s[f"{b}.project_conv.weight"] = (cout, mid, 1, 1)
                s.update(_bn_shapes(f"{b}.BatchNorm_1", cout))
            continue
        red = max(1, int(cin * se))
        s[f"{b}.block.0.0.weight"] = (mid, cin, 1, 1)
        s.update(_bn_shapes(f"{b}.block.0.1", mid))
        s[f"{b}.block.1.0.weight"] = (mid, 1, k, k)
        s.update(_bn_shapes(f"{b}.block.1.1", mid))
        s[f"{b}.block.2.fc1.weight"] = (red, mid, 1, 1)
        s[f"{b}.block.2.fc1.bias"] = (red,)
        s[f"{b}.block.2.fc2.weight"] = (mid, red, 1, 1)
        s[f"{b}.block.2.fc2.bias"] = (mid,)
        s[f"{b}.block.3.0.weight"] = (cout, mid, 1, 1)
        s.update(_bn_shapes(f"{b}.block.3.1", cout))
    s[f"{pre}head_conv.weight"] = (head, bl[-1][4], 1, 1)
    s.update(_bn_shapes(f"{pre}BatchNorm_1", head))
    s[f"{pre}classifier.weight"] = (num_classes, head)
    s[f"{pre}classifier.bias"] = (num_classes,)
    return s


def forward(p: Params, x: torch.Tensor, spec: dict, pre: str,
            q: Round = _ident) -> torch.Tensor:
    x = F.silu(_bn(p, f"{pre}BatchNorm_0",
                   _conv(p, f"{pre}stem_conv", x, q, 2, 1, bias=False)))
    for name, kind, k, cin, cout, e, stride, _ in blocks(spec):
        b, inp = f"{pre}{name}", x
        pad = (k - 1) // 2
        if kind == "fused":
            y = F.silu(_bn(p, f"{b}.BatchNorm_0", _conv(
                p, f"{b}.fused_conv", x, q, stride, pad, bias=False)))
            if e != 1:
                y = _bn(p, f"{b}.BatchNorm_1",
                        _conv(p, f"{b}.project_conv", y, q, bias=False))
        else:
            mid = cin * e
            y = F.silu(_bn(p, f"{b}.block.0.1",
                           _conv(p, f"{b}.block.0.0", x, q, bias=False)))
            y = F.silu(_bn(p, f"{b}.block.1.1", _conv(
                p, f"{b}.block.1.0", y, q, stride, pad, mid, bias=False)))
            s = y.mean(dim=(2, 3), keepdim=True)
            s = F.silu(_conv(p, f"{b}.block.2.fc1", s, q))
            y = y * torch.sigmoid(_conv(p, f"{b}.block.2.fc2", s, q))
            y = _bn(p, f"{b}.block.3.1",
                    _conv(p, f"{b}.block.3.0", y, q, bias=False))
        x = y + inp if stride == 1 and cin == cout else y
    x = F.silu(_bn(p, f"{pre}BatchNorm_1",
                   _conv(p, f"{pre}head_conv", x, q, bias=False)))
    return F.log_softmax(_linear(p, f"{pre}classifier", x.mean(dim=(2, 3)),
                                 q), dim=-1)


def _out(n: int, k: int, s: int) -> int:
    """Output length of a conv with symmetric (k − 1)//2 padding."""
    p = (k - 1) // 2
    return (n + 2 * p - k) // s + 1


def flops(spec: dict, h: int, w: int, num_classes: int) -> float:
    h, w = _out(h, 3, 2), _out(w, 3, 2)
    f = conv_flops(h, w, 3, spec["stem"], 3, 3)
    bl = blocks(spec)
    for _, kind, k, cin, cout, e, s, se in bl:
        mid = cin * e
        ho, wo = _out(h, k, s), _out(w, k, s)
        if kind == "fused":
            f += conv_flops(ho, wo, cin, mid if e != 1 else cout, k, k)
            if e != 1:
                f += conv_flops(ho, wo, mid, cout, 1, 1)
        else:
            red = max(1, int(cin * se))
            f += conv_flops(h, w, cin, mid, 1, 1)
            f += conv_flops(ho, wo, mid, mid, k, k, groups=mid)
            f += 4.0 * mid * red
            f += conv_flops(ho, wo, mid, cout, 1, 1)
        h, w = ho, wo
    return (f + conv_flops(h, w, bl[-1][4], spec["head"], 1, 1)
            + 2.0 * spec["head"] * num_classes)
