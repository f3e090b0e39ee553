"""The rest of the port's DeepLab family against the JAX package's, on the CPU:
MobileNetV2, Xception and HRNetV2 under the DeepLabV3 and V3+ heads, plain
and atrous-separable, at output stride 8 and 16; the exporters of every
name of the factory. One train step per new family is in
tests/test_torch_seg_zoo_training.py (a file of its own, so that the
suite's workers run the two halves side by side).

JAX parameters are drawn with numpy from a seed (torch_parity.seeded_leaves),
cross over through compat/from_jax and load with strict=True; the same numpy
inputs go through both models. Spatial sizes are not multiples of 16 (the
backbones' fixed padding under dilation must give JAX's shapes), except
HRNet's, whose fusion upsamples by exact factors and needs multiples of 32,
as in JAX. The tolerance of an eval forward is the one of
tests/test_torch_models.py: rtol 1e-3 and atol 1e-4 of max |logits|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nhwc_to_nchw, seeded_leaves, seg_pair_from_shapes, to_nhwc

from weatherconverter_tpu.compat import torch_export as JE
from weatherconverter_tpu.models import deeplab as JD
from weatherconverter_tpu.models import factory as JF
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.models import factory as PF

CLASSES = 5
# side sizes each backbone takes at both output strides (Xception's conv3/conv4
# keep padding 1 under dilation and shrink the map by 2 (OS16) or 6 (OS8) each)
SIZES = {"mobilenet": (50, 70), "xception": (120, 130), "hrnetv2_32": (64, 96), "hrnetv2_48": (64, 96)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(batch, hw, seed):
    return np.random.default_rng(seed).standard_normal((batch, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("name, os_, separable", [
    ("deeplabv3plus_mobilenet", 16, False), ("deeplabv3_mobilenet", 8, True),
    ("deeplabv3plus_xception", 16, True), ("deeplabv3_xception", 8, False),
    ("deeplabv3plus_hrnetv2_32", 16, False), ("deeplabv3_hrnetv2_48", 8, True),
    ("deeplabv3plus_resnet18", 8, True),
])
def test_eval_forward_matches_jax(name, os_, separable):
    """Each new backbone under both heads, at OS 8 and 16, plain and separable
    (and the separable head over a ResNet)."""
    hw = SIZES.get(name.partition("_")[2], (40, 56))
    jseg, variables, port = seg_pair_from_shapes(name, hw, CLASSES, seed=1, output_stride=os_, separable=separable)
    x = _input(2, hw, 2)
    ref = np.asarray(jseg.apply(variables, jnp.asarray(x)))  # op by op: HRNet's jit compile takes 15 s
    with torch.no_grad():
        out = port(nhwc_to_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES, *hw)
    tol = 1e-4 * float(np.abs(ref).max())
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=1e-3, atol=tol)
    if name == "deeplabv3plus_hrnetv2_32":
        # the stem has no ReLU between its convs and the fusion upsamples by
        # nearest neighbour: a ReLU there, or bilinear, breaks the tolerance
        bb = port.backbone
        bn1, up = bb.bn1, bb.stage2[0].fuse_layers[0][1][2]
        with torch.no_grad():
            bb.bn1 = torch.nn.Sequential(bn1, torch.nn.ReLU())
            relu = to_nhwc(port(nhwc_to_nchw(x)))
            bb.bn1 = bn1
            up.forward = lambda t: torch.nn.functional.interpolate(t, scale_factor=2, mode="bilinear")
            bilinear = to_nhwc(port(nhwc_to_nchw(x)))
        assert np.abs(relu - ref).max() > 10 * tol and np.abs(bilinear - ref).max() > 10 * tol


def _head_shapes(arch, separable, low, high):
    """The JAX head's variable shapes alone, from features of the backbone's widths."""
    cls = JD.DeepLabHeadV3Plus if arch == "deeplabv3plus" else JD.DeepLabHead
    head = cls(num_classes=CLASSES, aspp_dilate=(6, 12, 18), separable=separable)
    feats = {"low_level": jnp.zeros((1, 8, 8, low)), "out": jnp.zeros((1, 4, 4, high))}
    return jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), feats))


def _distinct_leaves(shapes):
    """Each leaf filled with its own value (cheap at a wide ResNet-101's 126M
    parameters, and a value landing under another key shows)."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    return jax.tree_util.tree_unflatten(treedef, [np.full(s.shape, 1.0 + i / 4096, np.float32)
                                                  for i, s in enumerate(leaves)])


@pytest.mark.parametrize("backbone", PF.BACKBONES)
def test_every_name_loads_its_converted_weights_strictly(backbone):
    """For both heads, plain and separable: the JAX tree's conversion loads
    into make_seg_model(name, separable=...) with strict=True and every value
    lands where it belongs (the port's state dict equals the conversion);
    for the plain heads the conversion equals the JAX package's exporter key
    for key, in order, bit for bit. The separable head has no JAX exporter:
    its conversion is held by this round trip and by the forwards above."""
    hw = SIZES.get(backbone, (32, 32))
    full = jax.eval_shape(lambda: JF.make_seg_model(f"deeplabv3plus_{backbone}", num_classes=CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))))
    bb = {k: v["backbone"] for k, v in full.items()}
    _, low, high, _ = PF.make_backbone(backbone)
    for arch in ("deeplabv3", "deeplabv3plus"):
        for separable in (False, True):
            name = f"{arch}_{backbone}"
            head = _head_shapes(arch, separable, low, high)
            shapes = {k: {"backbone": bb[k], "head": head[k]} for k in ("params", "batch_stats")}
            variables = _distinct_leaves(shapes)
            sd = from_jax.deeplab_state_dict(variables, name)
            with torch.device("meta"):
                port = PF.make_seg_model(name, CLASSES, separable=separable)
            port.load_state_dict(sd, strict=True, assign=True)
            got = port.state_dict()
            # (a 0-d num_batches_tracked leaves the conversion 1-d; the load takes either)
            assert all(torch.equal(got[k].reshape(v.shape), v) for k, v in sd.items()), name
            if separable:
                assert any(".body.0." in k for k in sd) and not any(k.endswith("convs.1.0.weight") for k in sd)
                continue
            ref = JE.to_torch_state_dict(JE.export_deeplab(variables["params"], variables["batch_stats"], name))
            assert list(ref) == list(sd), name
            assert all(ref[k].numpy().tobytes() == v.numpy().tobytes() for k, v in sd.items()), name


def test_factory_builds_every_supported_name():
    """The JAX factory's 26 names, in its order, and each one builds, plain and separable."""
    assert PF.SUPPORTED_MODELS == JF.SUPPORTED_MODELS and len(PF.SUPPORTED_MODELS) == 26
    for name in PF.SUPPORTED_MODELS:
        for separable in (False, True):
            with torch.device("meta"):
                model = PF.make_seg_model(name, CLASSES, separable=separable)
            convs = [type(m).__name__ for m in model.classifier.modules()]
            assert ("AtrousSeparableConvolution" in convs) == separable, name
    with pytest.raises(NotImplementedError, match="unknown backbone"):
        PF.make_seg_model("deeplabv3plus_vgg16")


@pytest.mark.parametrize("backbone, filename, extra", [
    ("mobilenet", "mobilenet_v2-b0353104.pth", {"features.18.0.weight": (1280, 320, 1, 1),
                                                "classifier.1.weight": (1000, 1280)}),
    ("xception", "xception-43020ad28.pth", {"bn4.weight": (2048,), "fc.weight": (1000, 2048)}),
    ("hrnetv2_32", "hrnetv2_w32_imagenet_pretrained.pth", {"bn_classifier.0.weight": (7, 480, 1, 1)}),
])
def test_pretrained_backbone_loads_by_the_jax_resolvers_name(backbone, filename, extra, tmp_path, monkeypatch):
    """A classification-layout checkpoint the test writes itself (MobileNetV2's
    `features.{i}`, Xception's and HRNet's own keys, each with the classifier
    keys the factory drops), found in the hub cache under the name the JAX
    resolver looks for and loaded into the backbone by torch parameter name."""
    from weatherconverter_tpu_torch.training import loop_segmentation

    name = f"deeplabv3plus_{backbone}"
    with torch.device("meta"):
        donor = PF.make_seg_model(name, CLASSES).backbone
    values = {k: torch.full(v.shape, float(i)) for i, (k, v) in enumerate(donor.state_dict().items())
              if not k.endswith("num_batches_tracked")}
    sd = dict(values)
    if backbone == "mobilenet":  # the torchvision layout: one `features` list
        sd = {"features." + k.split(".", 1)[1]: v for k, v in sd.items()}
    sd.update({k: torch.zeros(shape) for k, shape in extra.items()})
    os.makedirs(tmp_path / "hub" / "checkpoints")
    torch.save(sd, tmp_path / "hub" / "checkpoints" / filename)
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    model = PF.make_seg_model(name, CLASSES)
    loop_segmentation.load_pretrained_backbone(model, "imagenet", name)
    got = model.backbone.state_dict()
    assert all(torch.equal(got[k], v) for k, v in values.items())
    sd["features.99.weight" if backbone == "mobilenet" else "stray.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "hub" / "checkpoints" / filename)
    if backbone != "mobilenet":  # MobileNetV2 takes features.0-17 only, so a stray key outside them is dropped
        with pytest.raises(RuntimeError, match="does not fit"):
            loop_segmentation.load_pretrained_backbone(model, "imagenet", name)
