"""EfficientNet-B0 and EfficientNetV2-B2 spectrogram encoders
(counterpart of the JAX package's ``models/efficientnet.py``): MBConv with
squeeze-excite and SiLU, V2's fused early stages, BatchNorm with torch's
eps and momentum, torch's symmetric (k − 1)//2 padding on the strided
convs.  Input (B, 3, H, W) NCHW → (B, num_classes) log-probs.

Key layouts: ``EfficientNetB0`` is torchvision's ``efficientnet_b0``
(``features.0`` stem conv + BN, ``features.{1..7}.{j}.block`` of
conv-BN pairs and ``SqueezeExcitation`` ``fc1``/``fc2``, ``features.8``
head, ``classifier.1``), which the JAX package's
``load_torch_efficientnet_state_dict`` reads.  ``EfficientNetV2B2`` has no
torch counterpart: its modules carry the flax names (``stem_conv``,
``stage{s}_block{j}`` with ``fused_conv``/``project_conv`` and
``BatchNorm_{k}``, ``head_conv``, ``classifier``); its MBConv blocks are
the B0 block."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Dropout

# (expand_ratio, channels, repeats, stride, kernel)
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# EfficientNetV2-B2: the V2 base config with B2's width 1.1 and depth 1.2
# (stem 32; 16/32/56/104/120/208; head 1408)
# (block, expand_ratio, channels, repeats, stride, kernel)
V2_B2_STAGES = (
    ("fused", 1, 16, 2, 1, 3),
    ("fused", 4, 32, 3, 2, 3),
    ("fused", 4, 56, 3, 2, 3),
    ("mb", 4, 104, 4, 2, 3),
    ("mb", 6, 120, 6, 1, 3),
    ("mb", 6, 208, 10, 2, 3),
)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    """k×k conv without bias, symmetric (k − 1)//2 padding."""
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                     bias=False)


class _ConvBN(nn.Sequential):
    """conv → BatchNorm (→ SiLU when ``act``): torchvision's
    ``Conv2dNormActivation`` keys ``0`` and ``1``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__(_conv(cin, cout, k, stride, groups), BatchNorm(cout))
        if act:
            self.append(nn.SiLU())


class SqueezeExcite(nn.Module):
    """x · σ(fc2(SiLU(fc1(mean over H, W)))), 1×1 convs with bias."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduced, 1)
        self.fc2 = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


class MBConv(nn.Module):
    """[1×1 expand → BN → SiLU] → k×k depthwise (stride) → BN → SiLU →
    squeeze-excite (int(inp · se_ratio)) → 1×1 project → BN, plus the
    input where the stride is 1 and the width stays (after a per-sample
    dropout of rate ``drop_rate`` in training, when it is above 0)."""

    def __init__(self, inp: int, expand_ratio: int, out_channels: int,
                 stride: int, kernel: int, se_ratio: float = 0.25,
                 drop_rate: float = 0.0):
        super().__init__()
        mid = inp * expand_ratio
        layers = [_ConvBN(inp, mid, 1)] if expand_ratio != 1 else []
        layers += [_ConvBN(mid, mid, kernel, stride, groups=mid),
                   SqueezeExcite(mid, max(1, int(inp * se_ratio))),
                   _ConvBN(mid, out_channels, 1, act=False)]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and inp == out_channels
        self.drop = Dropout(drop_rate, per_sample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return self.drop(y) + x if self.residual else y


class FusedMBConv(nn.Module):
    """V2's early block: one k×k ``fused_conv`` (stride) → BN → SiLU, then
    (when expanding) 1×1 ``project_conv`` → BN; plus the input where the
    stride is 1 and the width stays (after a per-sample dropout of rate
    ``drop_rate`` in training, when it is above 0)."""

    def __init__(self, inp: int, expand_ratio: int, out_channels: int,
                 stride: int, kernel: int, drop_rate: float = 0.0):
        super().__init__()
        mid = inp * expand_ratio
        self.expand = expand_ratio != 1
        self.fused_conv = _conv(inp, mid if self.expand else out_channels,
                                kernel, stride)
        self.BatchNorm_0 = BatchNorm(mid if self.expand else out_channels)
        if self.expand:
            self.project_conv = _conv(mid, out_channels, 1)
            self.BatchNorm_1 = BatchNorm(out_channels)
        self.residual = stride == 1 and inp == out_channels
        self.drop = Dropout(drop_rate, per_sample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.BatchNorm_0(self.fused_conv(x)))
        if self.expand:
            y = self.BatchNorm_1(self.project_conv(y))
        return self.drop(y) + x if self.residual else y


class _EfficientNet(nn.Module):
    """``features`` (to the feature map the JAX model perturbs, NCHW) →
    ``head``: global mean → dropout → classifier → log-softmax."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


class EfficientNetB0(_EfficientNet):
    """The B0 topology (stem 32 → :data:`B0_STAGES` → head 1280) in
    torchvision's key layout."""

    def __init__(self, num_classes: int = 6):
        super().__init__()
        stages, cin = [_ConvBN(3, 32, 3, 2)], 32
        for e, c, r, s, k in B0_STAGES:
            blocks = []
            for j in range(r):
                blocks.append(MBConv(cin, e, c, s if j == 0 else 1, k))
                cin = c
            stages.append(nn.Sequential(*blocks))
        stages.append(_ConvBN(cin, 1280, 1))
        #: called as ``features(x)``: the feature map (B, 1280, H/32, W/32)
        self.features = nn.Sequential(*stages)
        self.classifier = nn.Sequential(Dropout(0.2),
                                        nn.Linear(1280, num_classes))

    def head(self, a: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.classifier(a.mean(dim=(2, 3))), dim=-1)


class EfficientNetV2B2(_EfficientNet):
    """The V2-B2 topology (stem 32 → :data:`V2_B2_STAGES` → head 1408),
    modules named after the flax model's."""

    def __init__(self, num_classes: int = 6):
        super().__init__()
        self.stem_conv = _conv(3, 32, 3, 2)
        self.BatchNorm_0 = BatchNorm(32)
        cin = 32
        self.blocks = []
        for si, (blk, e, c, r, s, k) in enumerate(V2_B2_STAGES):
            for j in range(r):
                cls = FusedMBConv if blk == "fused" else MBConv
                name = f"stage{si}_block{j}"
                self.add_module(name, cls(cin, e, c, s if j == 0 else 1, k))
                self.blocks.append(name)
                cin = c
        self.head_conv = _conv(cin, 1408, 1)
        self.BatchNorm_1 = BatchNorm(1408)
        self.dropout = Dropout(0.3)
        self.classifier = nn.Linear(1408, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature map (B, 1408, H/32, W/32)."""
        x = F.silu(self.BatchNorm_0(self.stem_conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return F.silu(self.BatchNorm_1(self.head_conv(x)))

    def head(self, a: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(
            self.classifier(self.dropout(a.mean(dim=(2, 3)))), dim=-1)
