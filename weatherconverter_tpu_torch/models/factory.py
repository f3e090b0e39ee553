"""Segmentation model factory (port of weatherconverter_tpu/models/factory.py)
for the DeepLabV3 and DeepLabV3+ heads over the ResNet family: resnet18-152,
ResNeXt (32x4d, 32x8d) and the wide ResNets. The JAX factory's other
backbones (mobilenet, xception, hrnetv2) and its atrous-separable head are
ROADMAP Queue 1 item 13 and raise NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Optional

from weatherconverter_tpu_torch.models.backbones import resnet
from weatherconverter_tpu_torch.models.deeplab import DeepLabHead, DeepLabHeadV3Plus, DeepLabV3
from weatherconverter_tpu_torch.models.norm import set_bn_momentum

RESNET_FAMILY = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
                 "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2")
SUPPORTED_MODELS = [f"{arch}_{bb}" for arch in ("deeplabv3", "deeplabv3plus") for bb in RESNET_FAMILY]
NOT_PORTED = "ROADMAP Queue 1 item 13"


def _resnet_cfg(output_stride: int):
    """output stride -> (replace_stride_with_dilation, ASPP rates)."""
    if output_stride == 8:
        return (False, True, True), (12, 24, 36)
    return (False, False, True), (6, 12, 18)


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
    stays at torch's default 0.1, as the JAX model scopes it."""
    arch, _, backbone_name = name.partition("_")
    if arch not in ("deeplabv3", "deeplabv3plus"):
        raise NotImplementedError(f"unknown model name {name!r}")
    if backbone_name not in RESNET_FAMILY:
        raise NotImplementedError(f"{name!r}: the port builds the DeepLab heads over {RESNET_FAMILY} so far; the "
                                  f"{backbone_name!r} backbone is {NOT_PORTED}")
    if separable:
        raise NotImplementedError(f"the atrous-separable head (separable=True) is {NOT_PORTED}")
    rswd, aspp = _resnet_cfg(output_stride)
    backbone = getattr(resnet, backbone_name)(replace_stride_with_dilation=rswd)
    expansion = backbone.layer1[0].expansion
    if arch == "deeplabv3plus":
        head = DeepLabHeadV3Plus(64 * expansion, 512 * expansion, num_classes, aspp, deterministic)
    else:
        head = DeepLabHead(512 * expansion, num_classes, aspp, deterministic)
    if bn_momentum is not None:
        set_bn_momentum(backbone, bn_momentum)
    return DeepLabV3(backbone, head).train(train)
