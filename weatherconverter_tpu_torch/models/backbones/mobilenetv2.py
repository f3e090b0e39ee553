"""MobileNetV2 backbone with DeepLab dilation, NCHW (port of
weatherconverter_tpu/models/backbones/mobilenetv2.py).

The reference's dilation-aware variant: every conv has padding 0, and each
InvertedResidual pads its whole input by `fixed_padding(3, dilation)`
before its first conv, the 1x1 expansion included (a quirk kept for the
checkpoints' outputs); the 3x3/s2 stem has padding 0 too. Output stride 8
or 16 is reached by turning later strides into dilation. Torch's layout and
names: `low_level_features.{0..3}` and `high_level_features.{4..17}` (the
torchvision `features` split by the DeepLab factory, indices kept), a block's
`conv.{i}` the expansion and depthwise ConvBNReLU6 then the projection conv
and its BatchNorm, so compat/from_jax.export_deeplab_mobilenet's output
loads with strict=True. BatchNorm is models/norm.BatchNorm2d.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d

# (expand ratio t, channels c, repeats n, stride s)
INVERTED_RESIDUAL_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
LOW_LEVEL_CHANNELS, OUT_CHANNELS = 24, 320


def _make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Channel rounding to a multiple of `divisor`, never below 90 % of v."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def fixed_padding(kernel_size: int, dilation: int) -> tuple[int, int]:
    """(pad_beg, pad_end) for the effective kernel of a dilated conv."""
    k_eff = kernel_size + (kernel_size - 1) * (dilation - 1)
    pad_total = k_eff - 1
    pad_beg = pad_total // 2
    return pad_beg, pad_total - pad_beg


class ConvBNReLU6(nn.Sequential):
    """Conv (padding 0, no bias) -> BN -> ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, stride, 0, dilation=dilation, groups=groups, bias=False),
            BatchNorm2d(cout),
            nn.ReLU6(),
        )


class InvertedResidual(nn.Module):
    """[1x1 expand] -> 3x3 depthwise (stride, dilation) -> 1x1 project + BN, on
    the input padded by fixed_padding(3, dilation); identity skip when the
    stride is 1 and the widths agree."""

    def __init__(self, cin: int, cout: int, stride: int, dilation: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        self.padding = fixed_padding(3, dilation)
        layers = [ConvBNReLU6(cin, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, dilation, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pb, pe = self.padding
        h = self.conv(F.pad(x, (pb, pe, pb, pe)))
        return x + h if self.use_res else h


class MobileNetV2Features(nn.Module):
    """forward -> {'low_level': features[0:4] (24 ch), 'out': features[4:18]
    (320 ch)}; the final 1x1-to-1280 layer and the classifier are dropped."""

    def __init__(self, output_stride: int = 16, width_mult: float = 1.0):
        super().__init__()
        input_channel = _make_divisible(32 * width_mult)
        features = [ConvBNReLU6(3, input_channel, 3, 2)]
        current_stride, dilation = 2, 1
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            previous_dilation = dilation
            if current_stride == output_stride:
                stride = 1
                dilation *= s
            else:
                stride = s
                current_stride *= s
            output_channel = _make_divisible(c * width_mult)
            for i in range(n):
                features.append(InvertedResidual(input_channel if i == 0 else output_channel, output_channel,
                                                 stride if i == 0 else 1, previous_dilation if i == 0 else dilation,
                                                 t))
                input_channel = output_channel
        self.low_level_features = nn.Sequential(OrderedDict((str(i), m) for i, m in enumerate(features[:4])))
        self.high_level_features = nn.Sequential(OrderedDict((str(i), m) for i, m in enumerate(features) if i >= 4))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        low = self.low_level_features(x)
        return {"low_level": low, "out": self.high_level_features(low)}
