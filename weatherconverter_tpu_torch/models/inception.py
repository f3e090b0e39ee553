"""InceptionV3, the FID feature extractor, NCHW (port of
weatherconverter_tpu/models/inception.py).

The module graph and names are torchvision's `inception_v3` (`Conv2d_1a_3x3`
... `Mixed_7c`, `fc`; every branch a BasicConv2d with `conv` and `bn`), so a
torchvision-layout `.pth` (torchvision's ImageNet weights, or the
pytorch-fid port of the TF FID weights) loads through
compat/from_jax.load_torchvision_inception, and the JAX package's tree
through compat/from_jax.inception_state_dict. There is no `AuxLogits`: the
JAX model has none (a train-time head). torchvision itself is not needed.
The model runs in eval mode (BatchNorm on its running statistics), its one
use being FID.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weatherconverter_tpu_torch.models.norm import BatchNorm2d
from weatherconverter_tpu_torch.ops.image import resize_bilinear

FID_SIZE = 299


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, padding 1, the padding counted (torch's default)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionV3(nn.Module):
    """torchvision's InceptionV3 graph. `forward(x)`, x (B, 3, H, W) in
    [-1, 1] (H, W >= 75; 299 for FID), returns the 2048-d pool3 features in
    f32, or with `classify` the fc logits (then the module has `fc`).
    `transform_input` maps ImageNet-normalized input to the TF scaling, as
    torchvision does."""

    def __init__(self, num_classes: int = 1000, classify: bool = False, transform_input: bool = False):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes) if classify else None
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                           x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                           x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=1)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(h)))
        h = _maxpool3s2(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        feats = h.float().mean(dim=(2, 3))  # pool3, 2048-d
        return feats if self.fc is None else self.fc(feats).float()


def fid_input_resize(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, 3, 299, 299) in [-1, 1], the input
    FID evaluates at (bilinear, half-pixel centres, no antialias)."""
    return resize_bilinear(x.float(), (FID_SIZE, FID_SIZE)) * 2.0 - 1.0
