"""DeepLabV3 and DeepLabV3+ heads and the assembled segmentation model, NCHW
(port of weatherconverter_tpu/models/deeplab.py).

Torchvision's module layout (V3+: classifier.aspp.convs.{0..4}, .project,
classifier.project, classifier.classifier.{0,1,3}; V3:
classifier.classifier.{0 (the ASPP),1,2,4}), so compat/torch_export output
loads with strict=True. The mode is torch's: in train() BatchNorm
normalizes with the batch's statistics and updates its running ones as flax
does (models/norm.py), in eval() it uses them. ASPP's dropout exists only
when the model is built with deterministic=False; the JAX trainer builds
its train model deterministic, so its dropout never fires, and neither does
the port's.

`separable=True` is the atrous-separable head (the reference's
`convert_to_separable_conv`): every conv of the head with a kernel larger
than 1 (ASPP's three atrous branches and the 3x3 after it) becomes a
depthwise conv with C_in groups and no bias, then a pointwise 1x1 with no
bias, under the reference's module name `body.{0,1}` in place of the conv.
The heads take their input widths explicitly (flax infers them): the
backbone's low-level and high-level channels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d
from weatherconverter_tpu_torch.ops.image import global_avg_pool, resize_bilinear


class AtrousSeparableConvolution(nn.Module):
    """Depthwise (groups = C_in, no bias) then pointwise 1x1 (no bias)."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int, dilation: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(cin, cin, kernel, padding=padding, dilation=dilation, groups=cin, bias=False),
            nn.Conv2d(cin, cout, 1, bias=False),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1, separable: bool = False):
        pad = dilation * (kernel - 1) // 2
        conv = (AtrousSeparableConvolution(cin, cout, kernel, pad, dilation) if separable and kernel > 1
                else nn.Conv2d(cin, cout, kernel, padding=pad, dilation=dilation, bias=False))
        super().__init__(conv, BatchNorm2d(cout), nn.ReLU())


class ASPPPooling(nn.Sequential):
    """Global-pool branch: pool -> 1x1 ConvBNReLU -> bilinear back to the map size."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Identity(), *ConvBNReLU(cin, cout))  # index 0 is the pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = super().forward(global_avg_pool(x))
        return resize_bilinear(h, x.shape[-2:])


class ASPP(nn.Module):
    """1x1 + three dilated 3x3 + global-pool branches, concatenated and
    projected by 1x1, then dropout 0.1 in train mode unless `deterministic`."""

    def __init__(self, cin: int, atrous_rates: Sequence[int], cout: int = 256, deterministic: bool = True,
                 separable: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(cin, cout)]
            + [ConvBNReLU(cin, cout, 3, rate, separable) for rate in atrous_rates]
            + [ASPPPooling(cin, cout)]
        )
        self.project = nn.Sequential(*ConvBNReLU(5 * cout, cout),
                                     nn.Identity() if deterministic else nn.Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class DeepLabHeadV3Plus(nn.Module):
    """low_level -> 1x1 to 48ch; ASPP(out) upsampled to it; concat -> 3x3 256 -> 1x1 classes."""

    def __init__(self, low_channels: int, in_channels: int, num_classes: int, aspp_dilate: Sequence[int],
                 deterministic: bool = True, separable: bool = False):
        super().__init__()
        self.project = ConvBNReLU(low_channels, 48)
        self.aspp = ASPP(in_channels, aspp_dilate, deterministic=deterministic, separable=separable)
        self.classifier = nn.Sequential(
            *ConvBNReLU(48 + 256, 256, 3, separable=separable), nn.Conv2d(256, num_classes, 1)
        )

    def forward(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        low = self.project(feats["low_level"])
        aspp = resize_bilinear(self.aspp(feats["out"]), low.shape[-2:])
        return self.classifier(torch.cat([low, aspp], dim=1))


class DeepLabHead(nn.Module):
    """ASPP(out) -> 3x3 256 -> 1x1 classes (the V3 head; no low-level branch)."""

    def __init__(self, in_channels: int, num_classes: int, aspp_dilate: Sequence[int], deterministic: bool = True,
                 separable: bool = False):
        super().__init__()
        self.classifier = nn.Sequential(
            ASPP(in_channels, aspp_dilate, deterministic=deterministic, separable=separable),
            *ConvBNReLU(256, 256, 3, separable=separable),
            nn.Conv2d(256, num_classes, 1),
        )

    def forward(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.classifier(feats["out"])


class DeepLabV3(nn.Module):
    """backbone -> head -> logits bilinearly resized to the input size, f32."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module):
        super().__init__()
        self.backbone, self.classifier = backbone, classifier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.classifier(self.backbone(x))
        return resize_bilinear(logits, x.shape[-2:]).float()
