"""JAX parameter trees -> state dicts of the port's modules.

The port's modules keep the torch layout that
weatherconverter_tpu/compat/torch_export writes, so this module is that
exporter plus the conversion to tensors; load the result with
`load_state_dict(..., strict=True)`. The trees may hold numpy arrays or
anything `np.asarray` takes. Importing the exporter loads neither JAX nor
flax (tests/test_torch_translate.py checks it).

Trees carried across: the UNet's, the DeepLabV3+/ResNet's and the SRGAN
generator's parameters (with BatchNorm statistics for the latter two).
`unet_state_dict` takes any tree shaped like the UNet's parameters: the
export only moves and transposes arrays (layout, no arithmetic), so a
gradient tree or an EMA shadow maps the same way, which is how the tests
hold the port's gradients and EMA against JAX's.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from weatherconverter_tpu.compat.torch_export import (
    export_deeplab_resnet,
    export_srgan_generator,
    export_unet,
    to_torch_state_dict,
)


def unet_state_dict(params: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """flax Unet params -> models.unet.Unet state dict."""
    return to_torch_state_dict(export_unet(params, config))


def deeplab_state_dict(variables: Mapping[str, Any], model_name: str) -> dict[str, torch.Tensor]:
    """flax DeepLabV3 {'params', 'batch_stats'} for `deeplabv3plus_resnet*`
    -> models.factory.make_seg_model(model_name) state dict."""
    backbone = model_name.split("_", 1)[1]
    return to_torch_state_dict(
        export_deeplab_resnet(variables["params"], variables["batch_stats"], backbone)
    )


def srgan_generator_state_dict(variables: Mapping[str, Any], num_blocks: int = 16) -> dict[str, torch.Tensor]:
    """flax Generator {'params', 'batch_stats'} -> models.srgan.Generator state dict."""
    return to_torch_state_dict(
        export_srgan_generator(variables["params"], variables.get("batch_stats", {}), num_blocks)
    )
