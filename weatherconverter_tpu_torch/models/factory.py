"""Segmentation model factory (port of weatherconverter_tpu/models/factory.py),
for the DeepLabV3+ models over plain ResNets. The other names of the JAX
factory (the DeepLabV3 head, mobilenet, xception, hrnetv2, ResNeXt and
wide ResNets) are ROADMAP work and raise NotImplementedError."""

from __future__ import annotations

from weatherconverter_tpu_torch.models.backbones import resnet
from weatherconverter_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3

_RESNETS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")


def _resnet_cfg(output_stride: int):
    """output stride -> (replace_stride_with_dilation, ASPP rates)."""
    if output_stride == 8:
        return (False, True, True), (12, 24, 36)
    return (False, False, True), (6, 12, 18)


def make_seg_model(name: str, num_classes: int = 19, output_stride: int = 16) -> DeepLabV3:
    """`deeplabv3plus_resnet{18,34,50,101,152}` in eval mode (BatchNorm on its
    running statistics), parameters on the CPU in f32."""
    backbone_name = name[len("deeplabv3plus_"):] if name.startswith("deeplabv3plus_") else None
    if backbone_name not in _RESNETS:
        raise NotImplementedError(
            f"{name!r}: the port has only deeplabv3plus over {_RESNETS} so far; the other "
            "seg models are ROADMAP Queue 1 item 13"
        )
    rswd, aspp = _resnet_cfg(output_stride)
    backbone = getattr(resnet, backbone_name)(replace_stride_with_dilation=rswd)
    expansion = backbone.layer1[0].expansion
    head = DeepLabHeadV3Plus(64 * expansion, 512 * expansion, num_classes, aspp)
    return DeepLabV3(backbone, head).eval()
