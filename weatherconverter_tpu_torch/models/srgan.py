"""Swift-SRGAN generator and discriminator, NCHW (port of
weatherconverter_tpu/models/srgan.py).

The generator's parameter names are those of
compat/torch_export.export_srgan_generator; the discriminator's are the
reference's (`blocks.{i}`, `classifier.{2,4}`), filled by
compat/from_jax.srgan_discriminator_state_dict. Separable convs are
depthwise + pointwise Conv2d. BatchNorm is models/norm.BatchNorm2d at
torch momentum 0.1 (flax's 0.9): in train mode it updates the running
variance with the biased batch variance, as flax does. The JAX package's
dense-composed stem and shift-packed 9x9 tail were rewrites for the TPU's
matrix unit and do not come across.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d
from weatherconverter_tpu_torch.ops.image import pixel_shuffle


class PReLU(nn.Module):
    """Per-channel PReLU, max(x, 0) + a * min(x, 0), with `a` cast to x's dtype
    so a bf16 chain stays bf16. Parameter named like nn.PReLU's."""

    def __init__(self, channels: int, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).reshape(1, -1, 1, 1)
        return x.clamp_min(0) + a * x.clamp_max(0)


class SeparableConv(nn.Module):
    """Depthwise (groups = C_in) then pointwise 1x1."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 1, bias: bool = True):
        super().__init__()
        self.depthwise = nn.Conv2d(cin, cin, kernel, stride, padding, groups=cin, bias=bias)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class ConvBlock(nn.Module):
    """SepConv -> [BN] -> [PReLU, or LeakyReLU(0.2) in the discriminator]."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=1, use_act=True, use_bn=True, discriminator=False):
        super().__init__()
        self.cnn = SeparableConv(cin, cout, kernel, stride, padding, bias=not use_bn)
        self.bn = BatchNorm2d(cout) if use_bn else None
        self.act = None
        if use_act:
            self.act = nn.LeakyReLU(0.2) if discriminator else PReLU(cout)

    def forward(self, x):
        h = self.cnn(x)
        if self.bn is not None:
            h = self.bn(h)
        return h if self.act is None else self.act(h)


class UpsampleBlock(nn.Module):
    """SepConv(C -> C*r^2) -> PixelShuffle(r) -> PReLU."""

    def __init__(self, channels: int, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = SeparableConv(channels, channels * scale_factor**2, 3, 1, 1)
        self.act = PReLU(channels)

    def forward(self, x):
        return self.act(pixel_shuffle(self.conv(x), self.scale_factor))


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block1 = ConvBlock(channels, channels)
        self.block2 = ConvBlock(channels, channels, use_act=False)

    def forward(self, x):
        return self.block2(self.block1(x)) + x


class Generator(nn.Module):
    """9x9 sep-conv stem -> num_blocks residuals -> conv + global skip ->
    log2(upscale) 2x PixelShuffle upsamplers -> 9x9 sep-conv -> (tanh + 1) / 2 in f32."""

    def __init__(self, in_channels: int = 3, num_channels: int = 64, num_blocks: int = 16, upscale_factor: int = 4):
        super().__init__()
        if upscale_factor not in (2, 4):
            raise ValueError(f"upscale_factor must be 2 or 4, got {upscale_factor}")
        self.initial = ConvBlock(in_channels, num_channels, kernel=9, padding=4, use_bn=False)
        self.residual = nn.Sequential(*(ResidualBlock(num_channels) for _ in range(num_blocks)))
        self.convblock = ConvBlock(num_channels, num_channels, use_act=False)
        self.upsampler = nn.Sequential(*(UpsampleBlock(num_channels, 2) for _ in range(upscale_factor // 2)))
        self.final_conv = SeparableConv(num_channels, in_channels, 9, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        initial = self.initial(x)
        h = self.convblock(self.residual(initial)) + initial
        h = self.final_conv(self.upsampler(h)).float()
        return (torch.tanh(h) + 1.0) / 2.0


class Discriminator(nn.Module):
    """Swift-SRGAN discriminator: ConvBlocks at `features` widths, stride
    1 + idx % 2, LeakyReLU 0.2, BN on all but the first -> adaptive average
    pool to 6 x 6 (torch's bin edges, as the JAX function has them) ->
    flatten in NCHW order -> fc 1024 -> LeakyReLU 0.2 -> fc 1 -> sigmoid, f32.
    The input is cast to the parameters' type first, as the flax module does."""

    def __init__(self, in_channels: int = 3, features: Sequence[int] = (64, 64, 128, 128, 256, 256, 512, 512)):
        super().__init__()
        widths = [in_channels, *features]
        self.blocks = nn.Sequential(*(ConvBlock(widths[i], f, 3, 1 + i % 2, 1, use_bn=i != 0, discriminator=True)
                                      for i, f in enumerate(features)))
        self.classifier = nn.Sequential(nn.AdaptiveAvgPool2d((6, 6)), nn.Flatten(), nn.Linear(features[-1] * 36, 1024),
                                        nn.LeakyReLU(0.2), nn.Linear(1024, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.classifier[2].weight.dtype)  # the generator's output is f32 whatever the parameters' type
        return torch.sigmoid(self.classifier(self.blocks(x))).float()
