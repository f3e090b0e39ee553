"""ResNet backbones with DeepLab dilation, NCHW (port of
weatherconverter_tpu/models/backbones/resnet.py).

Torchvision's layout and parameter names (conv1/bn1, layer{1..4}.{i}.conv{k},
.bn{k}, .downsample.{0,1}), so compat/torch_export.export_deeplab_resnet
output loads with strict=True. `replace_stride_with_dilation` turns later
stages' strides into dilation for output stride 8/16. The bottleneck's 3x3
takes `groups` and `base_width` (width = planes * base_width / 64 * groups),
which make the ResNeXt and wide variants. The stem is a plain 7x7/s2 conv:
the JAX package's shift-packed stem backward was a rewrite for the TPU's
matrix unit, and autograd gives this conv's input gradient directly.
BatchNorm is models/norm.BatchNorm2d, which trains as flax's does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1, groups: int = 1):
    pad = dilation * (kernel - 1) // 2
    conv = nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation, groups=groups, bias=False)
    return conv, BatchNorm2d(cout)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(*_conv_bn(cin, cout, 1, stride))


class BasicBlock(nn.Module):
    """resnet18/34 block: 3x3 -> 3x3, expansion 1."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None, groups=1, base_width=64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64")
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 3, stride, dilation)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, 1, dilation)
        self.downsample = downsample

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    """resnet50/101/152 block: 1x1 -> 3x3 (stride, dilation, groups) -> 1x1 x4,
    expansion 4; the inner width is planes * base_width / 64 * groups."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None, groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1, self.bn1 = _conv_bn(inplanes, width, 1)
        self.conv2, self.bn2 = _conv_bn(width, width, 3, stride, dilation, groups)
        self.conv3, self.bn3 = _conv_bn(width, planes * 4, 1)
        self.downsample = downsample

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """Feature-extracting ResNet: forward returns {'low_level': layer1, 'out': layer4}."""

    def __init__(
        self,
        layers: Sequence[int],
        block: type[nn.Module] = Bottleneck,
        replace_stride_with_dilation: Sequence[bool] = (False, False, True),
        groups: int = 1,
        base_width: int = 64,
    ):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(3, 64, 7, 2)
        inplanes, dilation = 64, 1
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            previous_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            out = planes * block.expansion
            mods = []
            for b in range(blocks):
                down = _downsample(inplanes, out, stride) if b == 0 and (stride != 1 or inplanes != out) else None
                mods.append(block(inplanes, planes, stride if b == 0 else 1,
                                  previous_dilation if b == 0 else dilation, down, groups, base_width))
                inplanes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, kernel_size=3, stride=2, padding=1)
        low = self.layer1(h)
        return {"low_level": low, "out": self.layer4(self.layer3(self.layer2(low)))}


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet((3, 8, 36, 3), Bottleneck, **kw)


def resnext50_32x4d(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, groups=32, base_width=4, **kw)


def resnext101_32x8d(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, groups=32, base_width=8, **kw)


def wide_resnet50_2(**kw) -> ResNet:
    """The inner 3x3 twice as wide; the outer 1x1 channels unchanged."""
    return ResNet((3, 4, 6, 3), Bottleneck, base_width=128, **kw)


def wide_resnet101_2(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, base_width=128, **kw)
