"""DeepLabV3+ on a dilated ResNet-101 (output stride 16) and the Swift-SRGAN
generator, in plain f32 PyTorch, NCHW, in eval mode.

Frozen, self-contained copies of the algorithms the port runs
(`weatherconverter_tpu_torch/models/deeplab.py`, `models/backbones/resnet.py`,
`models/srgan.py`), with torchvision's and the port's parameter names, so one
state dict loads into both. BatchNorm is torch's, in eval mode (running
statistics). Nothing of the port is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv_bn(cin, cout, kernel, stride=1, dilation=1):
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation, bias=False), nn.BatchNorm2d(cout)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride, dilation)
        self.conv3, self.bn3 = _conv_bn(planes, planes * 4, 1)
        self.downsample = downsample

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """Bottleneck ResNet; stride 2 of the stages listed in `dilate` becomes dilation."""

    def __init__(self, layers=(3, 4, 23, 3), dilate=(False, False, True)):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(3, 64, 7, 2)
        inplanes, dilation = 64, 1
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride, previous = (1 if stage == 0 else 2), dilation
            if stage > 0 and dilate[stage - 1]:
                dilation, stride = dilation * stride, 1
            mods = []
            for b in range(blocks):
                down = None
                if b == 0 and (stride != 1 or inplanes != planes * 4):
                    down = nn.Sequential(*_conv_bn(inplanes, planes * 4, 1, stride))
                mods.append(Bottleneck(inplanes, planes, stride if b == 0 else 1, previous if b == 0 else dilation,
                                       down))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, kernel_size=3, stride=2, padding=1)
        low = self.layer1(h)
        return low, self.layer4(self.layer3(self.layer2(low)))


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, kernel=1, dilation=1):
        pad = dilation * (kernel - 1) // 2
        super().__init__(nn.Conv2d(cin, cout, kernel, padding=pad, dilation=dilation, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class ASPPPooling(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(nn.Identity(), *ConvBNReLU(cin, cout))

    def forward(self, x):
        h = super().forward(x.mean(dim=(2, 3), keepdim=True))
        return F.interpolate(h, size=tuple(x.shape[-2:]), mode="bilinear", align_corners=False)


class ASPP(nn.Module):
    def __init__(self, cin, rates, cout=256):
        super().__init__()
        self.convs = nn.ModuleList([ConvBNReLU(cin, cout)] + [ConvBNReLU(cin, cout, 3, r) for r in rates]
                                   + [ASPPPooling(cin, cout)])
        self.project = nn.Sequential(*ConvBNReLU(5 * cout, cout), nn.Identity())

    def forward(self, x):
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class HeadV3Plus(nn.Module):
    def __init__(self, low_channels, in_channels, num_classes, rates):
        super().__init__()
        self.project = ConvBNReLU(low_channels, 48)
        self.aspp = ASPP(in_channels, rates)
        self.classifier = nn.Sequential(*ConvBNReLU(48 + 256, 256, 3), nn.Conv2d(256, num_classes, 1))

    def forward(self, low, out):
        low = self.project(low)
        aspp = F.interpolate(self.aspp(out), size=tuple(low.shape[-2:]), mode="bilinear", align_corners=False)
        return self.classifier(torch.cat([low, aspp], dim=1))


class DeepLabV3Plus(nn.Module):
    """ResNet-101 -> V3+ head -> logits bilinearly resized to the input. Only
    output stride 16 (dilation in the last stage, ASPP rates 6, 12, 18)."""

    def __init__(self, num_classes: int = 19, output_stride: int = 16):
        super().__init__()
        if output_stride != 16:
            raise ValueError("the reference holds output stride 16 only")
        self.backbone = ResNet()
        self.classifier = HeadV3Plus(256, 2048, num_classes, (6, 12, 18))

    def forward(self, x):
        logits = self.classifier(*self.backbone(x))
        return F.interpolate(logits, size=tuple(x.shape[-2:]), mode="bilinear", align_corners=False)


class PReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return x.clamp_min(0) + self.weight.reshape(1, -1, 1, 1) * x.clamp_max(0)


class SeparableConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=1, bias=True):
        super().__init__()
        self.depthwise = nn.Conv2d(cin, cin, kernel, stride, padding, groups=cin, bias=bias)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=bias)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, kernel=3, padding=1, use_act=True, use_bn=True):
        super().__init__()
        self.cnn = SeparableConv(cin, cout, kernel, 1, padding, bias=not use_bn)
        self.bn = nn.BatchNorm2d(cout) if use_bn else None
        self.act = PReLU(cout) if use_act else None

    def forward(self, x):
        h = self.cnn(x)
        if self.bn is not None:
            h = self.bn(h)
        return h if self.act is None else self.act(h)


class UpsampleBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = SeparableConv(channels, channels * 4, 3, 1, 1)
        self.act = PReLU(channels)

    def forward(self, x):
        return self.act(F.pixel_shuffle(self.conv(x), 2))


class ResidualBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.block1 = ConvBlock(channels, channels)
        self.block2 = ConvBlock(channels, channels, use_act=False)

    def forward(self, x):
        return self.block2(self.block1(x)) + x


class SRGenerator(nn.Module):
    """Swift-SRGAN: 9x9 separable stem, residual blocks, conv and global skip,
    2x pixel-shuffle upsamplers, 9x9 separable tail, (tanh + 1) / 2."""

    def __init__(self, in_channels=3, num_channels=64, num_blocks=16, upscale_factor=4):
        super().__init__()
        self.initial = ConvBlock(in_channels, num_channels, kernel=9, padding=4, use_bn=False)
        self.residual = nn.Sequential(*(ResidualBlock(num_channels) for _ in range(num_blocks)))
        self.convblock = ConvBlock(num_channels, num_channels, use_act=False)
        self.upsampler = nn.Sequential(*(UpsampleBlock(num_channels) for _ in range(upscale_factor // 2)))
        self.final_conv = SeparableConv(num_channels, in_channels, 9, 1, 4)

    def forward(self, x):
        initial = self.initial(x)
        h = self.convblock(self.residual(initial)) + initial
        return (torch.tanh(self.final_conv(self.upsampler(h))) + 1.0) / 2.0


@torch.no_grad()
def calibrate_bn(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Set every BatchNorm's running statistics to those of the activations
    `x` makes (one forward in train mode, as a cumulative average), as a
    trained model's are of its inputs'. Returns that forward's output; the
    model is left in eval mode."""
    model.train()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    out = model(x)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 0.1
    model.eval()
    return out
