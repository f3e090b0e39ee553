"""JAX parameter trees -> state dicts of the port's modules.

The port's modules keep the torch layout of the reference's checkpoints, so
a flax tree only has to be renamed and transposed (layout, no arithmetic):
numpy in, strict state dicts out; load the result with
`load_state_dict(..., strict=True)`. The trees may hold numpy arrays or
anything `np.asarray` takes. The exporters below are the port's own copy of
the JAX package's `compat/torch_export` (UNet, Swift-SRGAN generator,
DeepLabV3(+)/ResNet); the tests hold the two against each other key for key
and bit for bit. Nothing here imports JAX, flax or the JAX package.

Trees carried across: the UNet's, the DeepLabV3+/ResNet's and the SRGAN
generator's parameters (with BatchNorm statistics for the latter two).
`unet_state_dict` takes any tree shaped like the UNet's parameters, so a
gradient tree or an EMA shadow maps the same way, which is how the tests
hold the port's gradients and EMA against JAX's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# blocks per stage, and the families built from two-conv basic blocks
RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
RESNET_BASIC = {"resnet18", "resnet34"}


def _np(x) -> np.ndarray:
    return np.asarray(x)


def conv_w_out(kernel) -> np.ndarray:
    """(kh, kw, I, O) -> (O, I, kh, kw)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def depthwise_w_out(kernel) -> np.ndarray:
    """(kh, kw, 1, C) -> (C, 1, kh, kw)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def convt_w_out(kernel) -> np.ndarray:
    """(kh, kw, O, I) -> (I, O, kh, kw)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def linear_w_out(kernel) -> np.ndarray:
    return _np(kernel).transpose()


def _put_conv(sd, name, p, transposed=False, depthwise=False):
    k = p["kernel"]
    if transposed:
        sd[f"{name}.weight"] = convt_w_out(k)
    elif depthwise:
        sd[f"{name}.weight"] = depthwise_w_out(k)
    else:
        sd[f"{name}.weight"] = conv_w_out(k)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _put_linear(sd, name, p):
    sd[f"{name}.weight"] = linear_w_out(p["kernel"])
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _put_gn(sd, name, p):
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])


def _put_bn(sd, name, p, s):
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])
    sd[f"{name}.running_mean"] = _np(s["mean"])
    sd[f"{name}.running_var"] = _np(s["var"])
    sd[f"{name}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _put_mha(sd, name, p):
    sd[f"{name}.in_proj_weight"] = linear_w_out(p["qkv"]["kernel"])
    sd[f"{name}.in_proj_bias"] = _np(p["qkv"]["bias"])
    sd[f"{name}.out_proj.weight"] = linear_w_out(p["out"]["kernel"])
    sd[f"{name}.out_proj.bias"] = _np(p["out"]["bias"])


def export_unet(params: Mapping[str, Any], config) -> dict:
    """flax Unet params -> numpy dict in models.unet.Unet's state-dict layout."""
    sd: dict[str, Any] = {}
    _put_linear(sd, "t_proj.0", params["t_proj1"])
    _put_linear(sd, "t_proj.2", params["t_proj2"])
    _put_conv(sd, "conv_in", params["conv_in"])
    _put_gn(sd, "norm_out", params["norm_out"])
    _put_conv(sd, "conv_out", params["conv_out"])

    def res_block(sd, prefix, j, blk):
        _put_gn(sd, f"{prefix}.resnet_conv_first.{j}.0", blk["norm1"])
        _put_conv(sd, f"{prefix}.resnet_conv_first.{j}.2", blk["conv1"])
        _put_linear(sd, f"{prefix}.t_emb_layers.{j}.1", blk["time_proj"])
        _put_gn(sd, f"{prefix}.resnet_conv_second.{j}.0", blk["norm2"])
        _put_conv(sd, f"{prefix}.resnet_conv_second.{j}.2", blk["conv2"])
        _put_conv(sd, f"{prefix}.residual_input_conv.{j}", blk["residual"])

    def attn_block(sd, prefix, j, blk):
        _put_gn(sd, f"{prefix}.attention_norms.{j}", blk["norm"])
        _put_mha(sd, f"{prefix}.attentions.{j}", blk)

    n_down = len(config.down_channels) - 1
    for i in range(n_down):
        blk = params[f"down{i}"]
        for j in range(config.num_down_layers):
            res_block(sd, f"downs.{i}", j, blk[f"res{j}"])
            if f"attn{j}" in blk:
                attn_block(sd, f"downs.{i}", j, blk[f"attn{j}"])
        if "down" in blk:
            _put_conv(sd, f"downs.{i}.down_sample_conv", blk["down"])
    for i in range(len(config.mid_channels) - 1):
        blk = params[f"mid{i}"]
        res_block(sd, f"mids.{i}", 0, blk["res0"])
        for j in range(config.num_mid_layers):
            if f"attn{j}" in blk:
                attn_block(sd, f"mids.{i}", j, blk[f"attn{j}"])
            res_block(sd, f"mids.{i}", j + 1, blk[f"res{j+1}"])
    for i in range(n_down):
        blk = params[f"up{i}"]
        if "up" in blk:
            _put_conv(sd, f"ups.{i}.up_sample_conv", blk["up"], transposed=True)
        for j in range(config.num_up_layers):
            res_block(sd, f"ups.{i}", j, blk[f"res{j}"])
            if f"attn{j}" in blk:
                attn_block(sd, f"ups.{i}", j, blk[f"attn{j}"])
    return sd


def export_srgan_generator(
    params: Mapping[str, Any], stats: Mapping[str, Any], num_blocks: int = 16
) -> dict:
    sd: dict[str, Any] = {}

    def sep_conv(name, p):
        _put_conv(sd, f"{name}.depthwise", p["depthwise"], depthwise=True)
        _put_conv(sd, f"{name}.pointwise", p["pointwise"])

    def conv_block(name, p, s):
        sep_conv(f"{name}.cnn", p["cnn"])
        if "bn" in p:
            _put_bn(sd, f"{name}.bn", p["bn"], s["bn"])
        if "act" in p:
            sd[f"{name}.act.weight"] = _np(p["act"]["alpha"])

    conv_block("initial", params["initial"], {})
    for i in range(num_blocks):
        conv_block(f"residual.{i}.block1", params[f"residual{i}"]["block1"],
                   stats[f"residual{i}"]["block1"])
        conv_block(f"residual.{i}.block2", params[f"residual{i}"]["block2"],
                   stats[f"residual{i}"]["block2"])
    conv_block("convblock", params["convblock"], stats["convblock"])
    i = 0
    while f"upsampler{i}" in params:
        sep_conv(f"upsampler.{i}.conv", params[f"upsampler{i}"]["conv"])
        sd[f"upsampler.{i}.act.weight"] = _np(params[f"upsampler{i}"]["act"]["alpha"])
        i += 1
    sep_conv("final_conv", params["final_conv"])
    return sd


def _export_deeplab_head(sd, hp, hs):
    def conv_bn(torch_conv, torch_bn, p, s):
        _put_conv(sd, torch_conv, p["conv"])
        _put_bn(sd, torch_bn, p["bn"], s["bn"])

    is_plus = "project" in hp
    aspp_prefix = "classifier.aspp" if is_plus else "classifier.classifier.0"
    conv_bn(f"{aspp_prefix}.convs.0.0", f"{aspp_prefix}.convs.0.1",
            hp["aspp"]["conv1x1"], hs["aspp"]["conv1x1"])
    for j in range(3):
        conv_bn(f"{aspp_prefix}.convs.{j+1}.0", f"{aspp_prefix}.convs.{j+1}.1",
                hp["aspp"][f"atrous{j}"], hs["aspp"][f"atrous{j}"])
    conv_bn(f"{aspp_prefix}.convs.4.1", f"{aspp_prefix}.convs.4.2",
            hp["aspp"]["pool_conv"], hs["aspp"]["pool_conv"])
    conv_bn(f"{aspp_prefix}.project.0", f"{aspp_prefix}.project.1",
            hp["aspp"]["project"], hs["aspp"]["project"])
    if is_plus:
        conv_bn("classifier.project.0", "classifier.project.1", hp["project"], hs["project"])
        conv_bn("classifier.classifier.0", "classifier.classifier.1",
                hp["classifier0"], hs["classifier0"])
        _put_conv(sd, "classifier.classifier.3", hp["classifier1"])
    else:
        conv_bn("classifier.classifier.1", "classifier.classifier.2",
                hp["classifier0"], hs["classifier0"])
        _put_conv(sd, "classifier.classifier.4", hp["classifier1"])


def export_deeplab_resnet(
    params: Mapping[str, Any], stats: Mapping[str, Any], backbone_name: str
) -> dict:
    sd: dict[str, Any] = {}

    def conv_bn(torch_conv, torch_bn, p, s):
        _put_conv(sd, torch_conv, p["conv"])
        _put_bn(sd, torch_bn, p["bn"], s["bn"])

    bb_p, bb_s = params["backbone"], stats["backbone"]
    conv_bn("backbone.conv1", "backbone.bn1", bb_p["stem"], bb_s["stem"])
    nconvs = 2 if backbone_name in RESNET_BASIC else 3
    for L, blocks in enumerate(RESNET_LAYERS[backbone_name], start=1):
        for i in range(blocks):
            name = f"layer{L}_{i}"
            t = f"backbone.layer{L}.{i}"
            for k in range(1, nconvs + 1):
                conv_bn(f"{t}.conv{k}", f"{t}.bn{k}",
                        bb_p[name][f"conv{k}"], bb_s[name][f"conv{k}"])
            if "downsample" in bb_p[name]:
                conv_bn(f"{t}.downsample.0", f"{t}.downsample.1",
                        bb_p[name]["downsample"], bb_s[name]["downsample"])

    _export_deeplab_head(sd, params["head"], stats["head"])
    return sd


def to_torch_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """numpy dict -> torch tensor dict ready for torch.save / load_state_dict."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


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
