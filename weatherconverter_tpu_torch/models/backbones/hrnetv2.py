"""HRNetV2 backbone, NCHW (port of weatherconverter_tpu/models/backbones/hrnetv2.py).

Stem of two 3x3/s2 convs, four bottlenecks (64 -> 256 ch), then branches
at 1/4, 1/8, 1/16 and 1/32 of the input (c, 2c, 4c, 8c channels) made by
transitions, each stage module running four basic blocks a branch and
fusing every branch into every output (1x1 conv + BN and nearest-neighbour
upsampling from a coarser branch, chains of 3x3/s2 conv + BN from a finer
one). The 'out' features are the four streams bilinearly resized to the
finest and concatenated (15c channels); 'low_level' is the stage-1 output
(256 channels).

The stem is the reference's as the DeepLab factory runs it:
conv1 -> bn1 -> conv2 -> bn2 -> ReLU, with no ReLU between the two convs
(the factory's layer getter runs the one shared ReLU module once). The
fusion's upsampling takes the branch to exactly `scale` times its size, so
the input's sides must be multiples of 32, as in the reference. Torch's
names (`conv1`..`bn2`, `layer1.{i}`, `transition1.{0, 1.0}`,
`transition{2,3}`, `stage{s}.{b}.branches.{i}.{k}`,
`.fuse_layers.{o}.{i}`), so compat/from_jax.export_deeplab_hrnet's output
loads with strict=True.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d
from weatherconverter_tpu_torch.ops.image import resize_bilinear, resize_nearest

LOW_LEVEL_CHANNELS = 256


def out_channels(c: int) -> int:
    """Width of the concatenated streams: c + 2c + 4c + 8c."""
    return 15 * c


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1, relu: bool = False) -> nn.Sequential:
    """Conv (padding (k - 1) / 2, no bias) -> BN [-> ReLU]."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False), BatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class HRBottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4 width), a 1x1 conv + BN skip where it widens."""

    def __init__(self, cin: int, planes: int, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, planes, 1)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3)
        self.conv3, self.bn3 = conv_bn(planes, planes * 4, 1)
        self.downsample = conv_bn(cin, planes * 4, 1) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class HRBasicBlock(nn.Module):
    """3x3 -> 3x3 with the identity skip."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(planes, planes, 3)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + x)


class _Upsample(nn.Module):
    """Nearest-neighbour upsampling by an integer factor."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_nearest(x, (x.shape[2] * self.scale, x.shape[3] * self.scale))


class StageModule(nn.Module):
    """Four basic blocks a branch, then every output branch o the ReLU of the
    sum over the branches i brought to o's resolution and width."""

    def __init__(self, num_branches: int, output_branches: int, c: int):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(HRBasicBlock(c * 2**i) for _ in range(4))) for i in range(num_branches))
        fuse = []
        for o in range(output_branches):
            row = []
            for i in range(num_branches):
                if i == o:
                    row.append(nn.Identity())
                elif i > o:
                    row.append(nn.Sequential(*conv_bn(c * 2**i, c * 2**o, 1), _Upsample(2 ** (i - o))))
                else:
                    downs = [conv_bn(c * 2**i, c * 2**i, 3, 2, relu=True) for _ in range(o - i - 1)]
                    row.append(nn.Sequential(*downs, conv_bn(c * 2**i, c * 2**o, 3, 2)))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        hs = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for row in self.fuse_layers:
            acc = row[0](hs[0])
            for layer, h in zip(row[1:], hs[1:]):
                acc = acc + layer(h)
            out.append(F.relu(acc))
        return out


class HRNetV2Features(nn.Module):
    """forward -> {'low_level': stage 1 (256 ch), 'out': the four streams
    resized to 1/4 and concatenated (15c ch)}. `num_blocks` = stage modules
    in stages 2, 3 and 4."""

    def __init__(self, c: int = 32, num_blocks: Sequence[int] = (1, 4, 3)):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(3, 64, 3, 2)
        self.conv2, self.bn2 = conv_bn(64, 64, 3, 2)
        self.layer1 = nn.Sequential(HRBottleneck(64, 64, downsample=True),
                                    *(HRBottleneck(256, 64) for _ in range(3)))
        self.transition1 = nn.ModuleList([conv_bn(256, c, 3, 1, relu=True),
                                          nn.Sequential(conv_bn(256, 2 * c, 3, 2, relu=True))])
        self.stage2 = nn.Sequential(*(StageModule(2, 2, c) for _ in range(num_blocks[0])))
        self.transition2 = conv_bn(2 * c, 4 * c, 3, 2, relu=True)
        self.stage3 = nn.Sequential(*(StageModule(3, 3, c) for _ in range(num_blocks[1])))
        self.transition3 = conv_bn(4 * c, 8 * c, 3, 2, relu=True)
        self.stage4 = nn.Sequential(*(StageModule(4, 4, c) for _ in range(num_blocks[2])))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = self.bn1(self.conv1(x))  # no ReLU here: the reference's stem as the factory runs it
        h = F.relu(self.bn2(self.conv2(h)))
        low = self.layer1(h)
        xs = [t(low) for t in self.transition1]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [self.transition2(xs[-1])])
        xs = self.stage4(xs + [self.transition3(xs[-1])])
        size = xs[0].shape[-2:]
        out = torch.cat([xs[0]] + [resize_bilinear(s, size) for s in xs[1:]], dim=1)
        return {"low_level": low, "out": out}
