"""JAX parameter trees -> state dicts of the port's modules.

The port's modules keep the torch layout of the reference's checkpoints, so
a flax tree only has to be renamed and transposed (layout, no arithmetic):
numpy in, strict state dicts out; load the result with
`load_state_dict(..., strict=True)`. The trees may hold numpy arrays or
anything `np.asarray` takes. The exporters below are the port's own copy of
the JAX package's `compat/torch_export` (UNet, Swift-SRGAN generator,
DeepLabV3(+) over every backbone of the factory); the tests hold the two
against each other key for key and bit for bit; the legacy UNet's too.
InceptionV3's exporter is the inverse of the JAX package's
`convert_inception_v3` (torchvision's `inception_v3` layout), held by a
round-trip test. Two loaders take the reference's own files: a legacy
`.ckpt` (its dead `res.weight` keys dropped) and a torchvision `.pth` of
InceptionV3 (its `AuxLogits` dropped). Two conversions have no
JAX exporter and use the port's own module names, held by round-trip tests:
the atrous-separable head (a separable conv under `<conv>.body.{0,1}`,
depthwise then pointwise) and the SRGAN discriminator (`blocks.{i}`,
`classifier.{2,4}`). Nothing here imports JAX, flax or the JAX package.

Trees carried across: the UNet's, the DeepLabV3/V3+'s (over resnet18-152,
ResNeXt, the wide ResNets, MobileNetV2, Xception and HRNetV2; a grouped 3x3
kernel (3, 3, I/groups, O) takes the same transpose, the groups implied by
the shapes) and the SRGAN generator's and discriminator's parameters (with
BatchNorm statistics for the last three).
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
    "resnext50_32x4d": (3, 4, 6, 3),
    "resnext101_32x8d": (3, 4, 23, 3),
    "wide_resnet50_2": (3, 4, 6, 3),
    "wide_resnet101_2": (3, 4, 23, 3),
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


def export_legacy_unet(params: Mapping[str, Any], stats: Mapping[str, Any], block_depth: int = 3) -> dict:
    """flax LegacyUNet (params, batch_stats) -> numpy dict in
    models.unet_legacy.LegacyUNet's layout (the reference's old_modules.UNet
    without its dead `res.weight` of the non-residual blocks)."""
    sd: dict[str, Any] = {}
    _put_conv(sd, "pre_conv", params["pre_conv"])
    _put_conv(sd, "output", params["output"])

    def res_block(prefix, p, s):
        _put_bn(sd, f"{prefix}.double_conv.0", p["bn"], s["bn"])
        _put_conv(sd, f"{prefix}.double_conv.1", p["conv1"])
        _put_conv(sd, f"{prefix}.double_conv.3", p["conv2"])
        if "res" in p:
            _put_conv(sd, f"{prefix}.res", p["res"])

    for n in range(1, 5):
        for i in range(block_depth):
            for half in ("down", "up"):
                res_block(f"{half}{n}.residual_blocks.{i}", params[f"{half}{n}"][f"res{i}"],
                          stats[f"{half}{n}"][f"res{i}"])
    for name in ("bottleneck1", "bottleneck2"):
        res_block(name, params[name], stats[name])
    for name in ("attn_down3", "attn_down4", "attn_bottleneck", "attn_up1", "attn_up2"):
        p = params[name]
        sd[f"{name}.ln.weight"] = _np(p["ln"]["scale"])
        sd[f"{name}.ln.bias"] = _np(p["ln"]["bias"])
        _put_mha(sd, f"{name}.mha", p)
        sd[f"{name}.ff_self.0.weight"] = _np(p["ff_ln"]["scale"])
        sd[f"{name}.ff_self.0.bias"] = _np(p["ff_ln"]["bias"])
        _put_linear(sd, f"{name}.ff_self.1", p["ff1"])
        _put_linear(sd, f"{name}.ff_self.3", p["ff2"])
    return sd


def export_inception_v3(params: Mapping[str, Any], stats: Mapping[str, Any]) -> dict:
    """flax InceptionV3 (params, batch_stats) -> numpy dict in torchvision's
    `inception_v3` layout (models.inception.InceptionV3's): every
    BasicConv2d at `<path>.conv` / `<path>.bn`, and `fc` when the tree has
    the classifier. The inverse of the JAX package's convert_inception_v3."""
    sd: dict[str, Any] = {}

    def walk(p, s, path):
        if "conv" in p and "bn" in p:
            _put_conv(sd, f"{path}.conv", p["conv"])
            _put_bn(sd, f"{path}.bn", p["bn"], s["bn"])
            return
        for key in p:
            walk(p[key], s[key], f"{path}.{key}" if path else key)

    walk({k: v for k, v in params.items() if k != "fc"}, stats, "")
    if "fc" in params:
        _put_linear(sd, "fc", params["fc"])
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
        if "depthwise" in p:  # the atrous-separable head
            _put_conv(sd, f"{torch_conv}.body.0", p["depthwise"], depthwise=True)
            _put_conv(sd, f"{torch_conv}.body.1", p["pointwise"])
        else:
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


def export_deeplab_mobilenet(params, stats) -> dict:
    """MobileNetV2: the stem and blocks 1-3 under `low_level_features`, 4-17
    under `high_level_features`, indices kept."""
    sd: dict = {}
    bp, bs = params["backbone"], stats["backbone"]

    def attr_for(idx):
        return "low_level_features" if idx < 4 else "high_level_features"

    _put_conv(sd, "backbone.low_level_features.0.0", bp["stem"]["conv"])
    _put_bn(sd, "backbone.low_level_features.0.1", bp["stem"]["bn"], bs["stem"]["bn"])
    for idx in range(1, 18):
        name = f"block{idx}"
        t = f"backbone.{attr_for(idx)}.{idx}"
        p, s = bp[name], bs[name]
        base = 0
        if "expand" in p:
            _put_conv(sd, f"{t}.conv.0.0", p["expand"]["conv"])
            _put_bn(sd, f"{t}.conv.0.1", p["expand"]["bn"], s["expand"]["bn"])
            base = 1
        _put_conv(sd, f"{t}.conv.{base}.0", p["depthwise"]["conv"], depthwise=True)
        _put_bn(sd, f"{t}.conv.{base}.1", p["depthwise"]["bn"], s["depthwise"]["bn"])
        _put_conv(sd, f"{t}.conv.{base+1}", p["project"]["conv"])
        _put_bn(sd, f"{t}.conv.{base+2}", p["project"]["bn"], s["project"]["bn"])
    _export_deeplab_head(sd, params["head"], stats["head"])
    return sd


def _xception_sep_positions(n_seps: int, starts_with_relu: bool):
    """Indices of the separable convs in a block's `rep`: [ReLU] SepConv BN
    repeats, so (0, 3) for block1 (no leading ReLU), (1, 4[, 7]) otherwise."""
    first = 0 if not starts_with_relu else 1
    return [first + 3 * i for i in range(n_seps)]


def export_deeplab_xception(params, stats) -> dict:
    sd: dict = {}
    bp, bs = params["backbone"], stats["backbone"]
    for name in ("conv1", "conv2"):
        _put_conv(sd, f"backbone.{name}", bp[name])
    for name in ("bn1", "bn2", "bn3"):
        _put_bn(sd, f"backbone.{name}", bp[name], bs[name])

    def sep(torch_name, p):
        _put_conv(sd, f"{torch_name}.conv1", p["conv1"], depthwise=True)
        _put_conv(sd, f"{torch_name}.pointwise", p["pointwise"])

    sep("backbone.conv3", bp["conv3"])
    sep("backbone.conv4", bp["conv4"])
    for n in range(1, 13):
        blk_p, blk_s = bp[f"block{n}"], bs[f"block{n}"]
        n_seps = sum(1 for k in blk_p if k.startswith("sep"))
        pos = _xception_sep_positions(n_seps, starts_with_relu=(n != 1))
        for idx in range(n_seps):
            sep(f"backbone.block{n}.rep.{pos[idx]}", blk_p[f"sep{idx}"])
            _put_bn(sd, f"backbone.block{n}.rep.{pos[idx] + 1}", blk_p[f"bn{idx}"], blk_s[f"bn{idx}"])
        if "skip" in blk_p:
            _put_conv(sd, f"backbone.block{n}.skip", blk_p["skip"])
            _put_bn(sd, f"backbone.block{n}.skipbn", blk_p["skipbn"], blk_s["skipbn"])
    _export_deeplab_head(sd, params["head"], stats["head"])
    return sd


def export_deeplab_hrnet(params, stats, num_blocks=(1, 4, 3)) -> dict:
    sd: dict = {}
    bp, bs = params["backbone"], stats["backbone"]

    def conv_bn(torch_conv, torch_bn, p, s):
        _put_conv(sd, torch_conv, p["conv"])
        _put_bn(sd, torch_bn, p["bn"], s["bn"])

    conv_bn("backbone.conv1", "backbone.bn1", bp["stem1"], bs["stem1"])
    conv_bn("backbone.conv2", "backbone.bn2", bp["stem2"], bs["stem2"])
    for i in range(4):
        t = f"backbone.layer1.{i}"
        for k in (1, 2, 3):
            conv_bn(f"{t}.conv{k}", f"{t}.bn{k}", bp[f"layer1_{i}"][f"conv{k}"], bs[f"layer1_{i}"][f"conv{k}"])
        if "downsample" in bp[f"layer1_{i}"]:
            conv_bn(f"{t}.downsample.0", f"{t}.downsample.1",
                    bp[f"layer1_{i}"]["downsample"], bs[f"layer1_{i}"]["downsample"])
    conv_bn("backbone.transition1.0.0", "backbone.transition1.0.1", bp["transition1_0"], bs["transition1_0"])
    conv_bn("backbone.transition1.1.0.0", "backbone.transition1.1.0.1", bp["transition1_1"], bs["transition1_1"])
    conv_bn("backbone.transition2.0", "backbone.transition2.1", bp["transition2"], bs["transition2"])
    conv_bn("backbone.transition3.0", "backbone.transition3.1", bp["transition3"], bs["transition3"])
    for stage, n_branches, blocks in ((2, 2, num_blocks[0]), (3, 3, num_blocks[1]), (4, 4, num_blocks[2])):
        for b in range(blocks):
            t = f"backbone.stage{stage}.{b}"
            mod_p, mod_s = bp[f"stage{stage}_{b}"], bs[f"stage{stage}_{b}"]
            for i in range(n_branches):
                for blk in range(4):
                    bt = f"{t}.branches.{i}.{blk}"
                    for k in (1, 2):
                        conv_bn(f"{bt}.conv{k}", f"{bt}.bn{k}", mod_p[f"branch{i}_block{blk}"][f"conv{k}"],
                                mod_s[f"branch{i}_block{blk}"][f"conv{k}"])
            for o in range(n_branches):
                for i in range(n_branches):
                    if i == o:
                        continue
                    ft = f"{t}.fuse_layers.{o}.{i}"
                    if i > o:
                        conv_bn(f"{ft}.0", f"{ft}.1", mod_p[f"fuse{o}_{i}"], mod_s[f"fuse{o}_{i}"])
                    else:
                        n_down = o - i
                        for sdx in range(n_down - 1):
                            conv_bn(f"{ft}.{sdx}.0", f"{ft}.{sdx}.1", mod_p[f"fuse{o}_{i}_down{sdx}"],
                                    mod_s[f"fuse{o}_{i}_down{sdx}"])
                        conv_bn(f"{ft}.{n_down-1}.0", f"{ft}.{n_down-1}.1", mod_p[f"fuse{o}_{i}_down_last"],
                                mod_s[f"fuse{o}_{i}_down_last"])
    _export_deeplab_head(sd, params["head"], stats["head"])
    return sd


def export_deeplab(params, stats, model_name: str) -> dict:
    """Dispatch on the factory's model name; HRNet's stage modules are
    counted in the tree (the factory builds (1, 4, 3))."""
    backbone = model_name.split("_", 1)[1]
    if backbone.startswith(("resnet", "resnext", "wide_resnet")):
        return export_deeplab_resnet(params, stats, backbone)
    if backbone == "mobilenet":
        return export_deeplab_mobilenet(params, stats)
    if backbone == "xception":
        return export_deeplab_xception(params, stats)
    if backbone.startswith("hrnetv2"):
        bp = params["backbone"]
        return export_deeplab_hrnet(params, stats, tuple(sum(k.startswith(f"stage{i}_") for k in bp) for i in (2, 3, 4)))
    raise ValueError(f"unknown deeplab backbone in {model_name!r}")


def export_srgan_discriminator(params: Mapping[str, Any], stats: Mapping[str, Any]) -> dict:
    """flax Discriminator -> models.srgan.Discriminator's layout (no JAX
    exporter has it): `blocks.{i}.cnn.{depthwise,pointwise}`, `blocks.{i}.bn`,
    fc1 and fc2 as `classifier.2` and `classifier.4`. The flax model flattens
    in NCHW order, so fc1's kernel only transposes."""
    sd: dict[str, Any] = {}
    i = 0
    while f"block{i}" in params:
        p = params[f"block{i}"]
        _put_conv(sd, f"blocks.{i}.cnn.depthwise", p["cnn"]["depthwise"], depthwise=True)
        _put_conv(sd, f"blocks.{i}.cnn.pointwise", p["cnn"]["pointwise"])
        if "bn" in p:
            _put_bn(sd, f"blocks.{i}.bn", p["bn"], stats[f"block{i}"]["bn"])
        i += 1
    _put_linear(sd, "classifier.2", params["fc1"])
    _put_linear(sd, "classifier.4", params["fc2"])
    return sd


def to_torch_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """numpy dict -> torch tensor dict ready for torch.save / load_state_dict."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def unet_state_dict(params: Mapping[str, Any], config) -> dict[str, torch.Tensor]:
    """flax Unet params -> models.unet.Unet state dict."""
    return to_torch_state_dict(export_unet(params, config))


def deeplab_state_dict(variables: Mapping[str, Any], model_name: str) -> dict[str, torch.Tensor]:
    """flax DeepLabV3 {'params', 'batch_stats'} of any factory name, plain or
    separable head -> models.factory.make_seg_model(model_name) state dict."""
    return to_torch_state_dict(export_deeplab(variables["params"], variables["batch_stats"], model_name))


def srgan_generator_state_dict(variables: Mapping[str, Any], num_blocks: int = 16) -> dict[str, torch.Tensor]:
    """flax Generator {'params', 'batch_stats'} -> models.srgan.Generator state dict."""
    return to_torch_state_dict(
        export_srgan_generator(variables["params"], variables.get("batch_stats", {}), num_blocks)
    )


def srgan_discriminator_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax Discriminator {'params', 'batch_stats'} -> models.srgan.Discriminator state dict."""
    return to_torch_state_dict(export_srgan_discriminator(variables["params"], variables.get("batch_stats", {})))


def legacy_unet_state_dict(variables: Mapping[str, Any], block_depth: int = 3) -> dict[str, torch.Tensor]:
    """flax LegacyUNet {'params', 'batch_stats'} -> models.unet_legacy.LegacyUNet state dict."""
    return to_torch_state_dict(export_legacy_unet(variables["params"], variables["batch_stats"], block_depth))


def inception_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax InceptionV3 {'params', 'batch_stats'} -> models.inception.InceptionV3 state dict."""
    return to_torch_state_dict(export_inception_v3(variables["params"], variables["batch_stats"]))


def dead_legacy_keys(block_depth: int = 3) -> list[str]:
    """The parameters the reference's legacy UNet creates and never applies:
    the 1x1 `res` conv of every down block's non-residual blocks
    (old_modules.py:146; weatherconverter_tpu/compat/torch_export.py:148-150)."""
    return [f"down{n}.residual_blocks.{i}.res.weight" for n in range(1, 5) for i in range(1, block_depth)]


def load_legacy_reference(model: torch.nn.Module, sd: Mapping[str, Any], block_depth: int = 3) -> torch.nn.Module:
    """A reference legacy checkpoint's state dict (old_model/1000-checkpoint.ckpt)
    into `model` (a LegacyUNet): exactly the dead keys of `dead_legacy_keys`
    are dropped, then it loads with strict=True, so any other missing or extra
    key raises."""
    dead = set(dead_legacy_keys(block_depth))
    model.load_state_dict({k: v for k, v in sd.items() if k not in dead}, strict=True)
    return model


def load_torchvision_inception(model: torch.nn.Module, sd: Mapping[str, Any], classify: bool) -> torch.nn.Module:
    """A torchvision-layout InceptionV3 state dict (torchvision's own weights or
    the pytorch-fid port of the TF FID weights) into `model` (a
    models.inception.InceptionV3): `AuxLogits.*`, the train-time head, is
    dropped, and `fc.*` too unless `classify`; then it loads with strict=True."""
    kept = {k: v for k, v in sd.items()
            if not k.startswith("AuxLogits.") and (classify or not k.startswith("fc."))}
    model.load_state_dict(kept, strict=True)
    return model
