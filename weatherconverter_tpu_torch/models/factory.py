"""Segmentation model factory (port of weatherconverter_tpu/models/factory.py):
the DeepLabV3 and DeepLabV3+ heads, plain or atrous-separable, over the
ResNet family (resnet18-152, ResNeXt 32x4d/32x8d, the wide ResNets),
MobileNetV2, Xception and HRNetV2 (c = 32, 48): the JAX factory's 26 names.
The output stride maps to dilation and ASPP rates as there; HRNet's ASPP
rates are always (12, 24, 36).
"""

from __future__ import annotations

from typing import Optional

from weatherconverter_tpu_torch.models.backbones import hrnetv2, mobilenetv2, resnet, xception
from weatherconverter_tpu_torch.models.deeplab import DeepLabHead, DeepLabHeadV3Plus, DeepLabV3
from weatherconverter_tpu_torch.models.norm import set_bn_momentum

RESNET_FAMILY = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
                 "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2")
BACKBONES = RESNET_FAMILY + ("mobilenet", "xception", "hrnetv2_32", "hrnetv2_48")
SUPPORTED_MODELS = [f"{arch}_{bb}" for arch in ("deeplabv3", "deeplabv3plus") for bb in BACKBONES]


def _resnet_cfg(output_stride: int):
    """output stride -> (replace_stride_with_dilation, ASPP rates)."""
    if output_stride == 8:
        return (False, True, True), (12, 24, 36)
    return (False, False, True), (6, 12, 18)


def _xception_cfg(output_stride: int):
    if output_stride == 8:
        return (False, False, True, True), (12, 24, 36)
    return (False, False, False, True), (6, 12, 18)


def _aspp_for(output_stride: int):
    return (12, 24, 36) if output_stride == 8 else (6, 12, 18)


def make_backbone(backbone_name: str, output_stride: int = 16):
    """(backbone, low-level channels, high-level channels, ASPP rates)."""
    if backbone_name in RESNET_FAMILY:
        rswd, aspp = _resnet_cfg(output_stride)
        backbone = getattr(resnet, backbone_name)(replace_stride_with_dilation=rswd)
        expansion = backbone.layer1[0].expansion
        return backbone, 64 * expansion, 512 * expansion, aspp
    if backbone_name == "mobilenet":
        return (mobilenetv2.MobileNetV2Features(output_stride), mobilenetv2.LOW_LEVEL_CHANNELS,
                mobilenetv2.OUT_CHANNELS, _aspp_for(output_stride))
    if backbone_name == "xception":
        rswd, aspp = _xception_cfg(output_stride)
        return xception.XceptionFeatures(rswd), xception.LOW_LEVEL_CHANNELS, xception.OUT_CHANNELS, aspp
    if backbone_name in ("hrnetv2_32", "hrnetv2_48"):
        c = int(backbone_name.split("_")[-1])
        return hrnetv2.HRNetV2Features(c), hrnetv2.LOW_LEVEL_CHANNELS, hrnetv2.out_channels(c), (12, 24, 36)
    raise NotImplementedError(f"unknown backbone {backbone_name!r}")


def make_seg_model(
    name: str,
    num_classes: int = 19,
    output_stride: int = 16,
    train: bool = False,
    deterministic: bool = True,
    bn_momentum: Optional[float] = None,
    separable: bool = False,
) -> DeepLabV3:
    """`deeplabv3_<backbone>` or `deeplabv3plus_<backbone>`, parameters on the
    CPU in f32, in train() mode if `train` else eval(). `deterministic`
    leaves ASPP's dropout out (the JAX trainer's setting). `bn_momentum`
    (torch's convention) is the backbone's BatchNorm momentum; the head's
    stays at torch's default 0.1, as the JAX model scopes it. `separable`
    builds the atrous-separable head."""
    arch, _, backbone_name = name.partition("_")
    if arch not in ("deeplabv3", "deeplabv3plus"):
        raise NotImplementedError(f"unknown model name {name!r}")
    backbone, low, high, aspp = make_backbone(backbone_name, output_stride)
    if arch == "deeplabv3plus":
        head = DeepLabHeadV3Plus(low, high, num_classes, aspp, deterministic, separable)
    else:
        head = DeepLabHead(high, num_classes, aspp, deterministic, separable)
    if bn_momentum is not None:
        set_bn_momentum(backbone, bn_momentum)
    return DeepLabV3(backbone, head).train(train)
