"""Xception backbone with DeepLab dilation, NCHW (port of
weatherconverter_tpu/models/backbones/xception.py).

The reference's clone of the Cadene port: a 3x3/s2 and a 3x3 stem conv
(padding 0), twelve blocks of [ReLU] separable conv + BN repeats with a
3x3 max-pool where a block strides and a 1x1 conv + BN skip where the width
or the stride changes, then the separable conv3 (+ bn3, ReLU) and conv4.
The DeepLab factory taps block1 (128 ch) as 'low_level' and conv4's output
before bn4 (2048 ch) as 'out'. conv3 and conv4 keep padding 1 whatever
their dilation, as the reference has them, so under dilation they shrink
the map. Torch's names (`conv1`, `bn1`, `block{n}.rep.{i}`, `.skip`,
`.skipbn`, a separable conv's `conv1` and `pointwise`), so
compat/from_jax.export_deeplab_xception's output loads with strict=True.
The ReLUs are not in place: the skip takes the block's input as it came.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d

LOW_LEVEL_CHANNELS, OUT_CHANNELS = 128, 2048


class SeparableConvX(nn.Module):
    """Depthwise (groups = C_in) then pointwise 1x1, both without bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, kernel, stride, padding, dilation=dilation, groups=cin, bias=False)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.conv1(x))


def max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max-pool, padding 1 (padded cells never win)."""
    return F.max_pool2d(x, 3, stride, 1)


class XceptionBlock(nn.Module):
    """`rep`: [ReLU] SepConv BN repeated `reps` times (the width grows at the
    first repeat, or at the last when not `grow_first`), then a max-pool
    when `strides` != 1; plus a 1x1-conv + BN skip when channels or stride
    change, else the identity."""

    def __init__(self, cin: int, cout: int, reps: int, strides: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True, dilation: int = 1):
        super().__init__()
        widths = [cout] if grow_first else []
        widths += [cout if grow_first else cin] * (reps - 1)
        widths += [] if grow_first else [cout]
        layers, c = [], cin
        for i, w in enumerate(widths):
            if i > 0 or start_with_relu:
                layers.append(nn.ReLU())
            layers += [SeparableConvX(c, w, 3, 1, dilation, dilation), BatchNorm2d(w)]
            c = w
        self.rep = nn.Sequential(*layers)
        self.strides = strides
        if cout != cin or strides != 1:
            self.skip = nn.Conv2d(cin, cout, 1, strides, bias=False)
            self.skipbn = BatchNorm2d(cout)
        else:
            self.skip = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rep(x)
        if self.strides != 1:
            h = max_pool_3x3(h, self.strides)
        return h + (x if self.skip is None else self.skipbn(self.skip(x)))


class XceptionFeatures(nn.Module):
    """forward -> {'low_level': block1 (128 ch), 'out': conv4 before bn4 (2048 ch)}.
    `replace_stride_with_dilation` (4 flags: blocks 1, 2, 3 and 12) sets the output stride."""

    def __init__(self, replace_stride_with_dilation: Sequence[bool] = (False, False, False, True)):
        super().__init__()
        rswd = list(replace_stride_with_dilation)
        dilation = 1

        def stride_dil(s: int, dilate: bool) -> tuple[int, int]:
            nonlocal dilation
            if dilate:
                dilation *= s
                return 1, dilation
            return s, dilation

        self.conv1 = nn.Conv2d(3, 32, 3, 2, 0, bias=False)
        self.bn1 = BatchNorm2d(32)
        self.conv2 = nn.Conv2d(32, 64, 3, 1, 0, bias=False)
        self.bn2 = BatchNorm2d(64)
        s, d = stride_dil(2, rswd[0])
        self.block1 = XceptionBlock(64, 128, 2, s, start_with_relu=False, grow_first=True, dilation=d)
        s, d = stride_dil(2, rswd[1])
        self.block2 = XceptionBlock(128, 256, 2, s, dilation=d)
        s, d = stride_dil(2, rswd[2])
        self.block3 = XceptionBlock(256, 728, 2, s, dilation=d)
        for i in range(4, 12):  # the middle blocks take the dilation after block3
            setattr(self, f"block{i}", XceptionBlock(728, 728, 3, 1, dilation=dilation))
        s, d = stride_dil(2, rswd[3])
        self.block12 = XceptionBlock(728, 1024, 2, s, grow_first=False, dilation=d)
        self.conv3 = SeparableConvX(1024, 1536, 3, 1, 1, dilation)
        self.bn3 = BatchNorm2d(1536)
        self.conv4 = SeparableConvX(1536, 2048, 3, 1, 1, dilation)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        low = self.block1(h)
        h = low
        for i in range(2, 13):
            h = getattr(self, f"block{i}")(h)
        h = F.relu(self.bn3(self.conv3(h)))
        return {"low_level": low, "out": self.conv4(h)}
