"""The port's segmentation models against the JAX package's, on the CPU, in f32:
DeepLabV3 and DeepLabV3+ over the grouped and wide ResNets, the train-mode
forward and BatchNorm's running statistics, the exporters, the factory.

JAX parameters (drawn with numpy from a seed, torch_parity.seg_pair_from_shapes)
cross over through compat/from_jax and load with strict=True; the same numpy
inputs go through both models. The tolerance of a forward is the one of
tests/test_torch_models.py: rtol 1e-3 and atol 1e-4 of max |logits|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nhwc_to_nchw, seg_pair_from_shapes, to_nhwc

from weatherconverter_tpu.compat import torch_export as JE
from weatherconverter_tpu.models import factory as JF
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.models import factory as PF
from weatherconverter_tpu_torch.models.deeplab import DeepLabHead, DeepLabHeadV3Plus
from weatherconverter_tpu_torch.models.norm import BatchNorm2d

CLASSES = 5
NAMES = ["deeplabv3_resnet18", "deeplabv3plus_resnext50_32x4d", "deeplabv3_wide_resnet50_2"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: beside the suite's parallel workers more oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {name: seg_pair_from_shapes(name, 32, CLASSES) for name in NAMES}


def _input(batch, seed, hw=32):
    return np.random.default_rng(seed).standard_normal((batch, hw, hw, 3)).astype(np.float32)


def _close_logits(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=1e-3, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", NAMES)
def test_deeplab_families_match_jax(pairs, name):
    jseg, variables, port = pairs[name]
    x = _input(2, 1)
    ref = jax.jit(jseg.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(nhwc_to_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, CLASSES, 32, 32)
    _close_logits(out, ref)


@pytest.mark.parametrize("name", NAMES)
def test_from_jax_equals_the_jax_exporter(pairs, name):
    """Key for key, in order, bit for bit: the V3 head and the grouped and
    wide bottlenecks with their BatchNorm statistics."""
    _, variables, _ = pairs[name]
    ref = JE.to_torch_state_dict(JE.export_deeplab(variables["params"], variables["batch_stats"], name))
    got = from_jax.deeplab_state_dict(variables, name)
    assert list(got) == list(ref)
    for key, want in ref.items():
        assert got[key].dtype == want.dtype and got[key].shape == want.shape, key
        assert got[key].numpy().tobytes() == want.numpy().tobytes(), key


@pytest.mark.parametrize("batch", [2, 1])
def test_train_mode_forward_and_running_statistics_match_flax(batch):
    """One train-mode forward at backbone momentum 0.01: the logits, and every
    BatchNorm's running mean and variance against flax's batch_stats. At
    batch 2 the ASPP pooling branch's BatchNorm sees n = 2 values a channel,
    where torch's own update would take twice the biased variance; at batch
    1 it sees one, where torch raises and flax normalizes to the bias.

    Tolerances: flax takes a train-mode batch variance as E[x^2] - E[x]^2 in
    f32, which loses digits where a channel's mean is large against its
    spread. Against a float64 run of the port, JAX's logits here are 2.1e-4
    of max |logits| off and its running statistics up to 2.2e-4 of their
    max (the head's, downstream of the backbone's variances); the port's
    f32 run 1.5e-5 and 1.6e-5. The bound, 1e-3 of the max, is about 5x
    JAX's own error. The unbiased update torch would make moves the ASPP
    pooling branch's running variance (~1) by a tenth of its batch variance
    at batch 2, tens of times that bound."""
    name = "deeplabv3plus_resnet18"
    jseg, variables, eval_port = seg_pair_from_shapes(name, 32, CLASSES)
    jtrain = JF.make_seg_model(name, CLASSES, train=True, bn_momentum=0.01)
    port = PF.make_seg_model(name, CLASSES, train=True, bn_momentum=0.01)
    port.load_state_dict(eval_port.state_dict(), strict=True)
    assert port.training and port.backbone.bn1.momentum == 0.01 and port.classifier.project[1].momentum == 0.1
    x = _input(batch, 2)
    ref, updates = jax.jit(lambda v, x: jtrain.apply(v, x, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    out = port(nhwc_to_nchw(x)).detach()
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=1e-3, atol=1e-3 * float(np.abs(ref).max()))
    want = from_jax.deeplab_state_dict({"params": variables["params"], "batch_stats": updates["batch_stats"]}, name)
    before = eval_port.state_dict()
    got = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm2d) for m in port.modules())
    for key in stats:
        assert not torch.equal(got[key], before[key]), key
        w = want[key].numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-3 * float(np.abs(w).max()), err_msg=key)
    assert int(got["backbone.bn1.num_batches_tracked"]) == 1


def test_dropout_follows_the_deterministic_flag():
    """The JAX trainer's model is deterministic: no dropout, so two train-mode
    forwards of one input agree; deterministic=False draws a mask."""
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = PF.make_seg_model("deeplabv3plus_resnet18", CLASSES, train=True)
    assert not any(isinstance(m, torch.nn.Dropout) for m in model.modules())
    torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)
    loose = PF.make_seg_model("deeplabv3plus_resnet18", CLASSES, train=True, deterministic=False)
    loose.load_state_dict(model.state_dict())
    assert sum(isinstance(m, torch.nn.Dropout) for m in loose.modules()) == 1
    assert not torch.equal(loose(x), loose(x))


def test_factory_builds_every_resnet_family_name():
    """Every deeplabv3{,plus}_ name of the JAX factory over the nine ResNet
    family backbones builds (on the meta device: shapes only), with the
    JAX output-stride mapping; the rest of the JAX list (MobileNetV2,
    Xception, HRNetV2), which the port now builds too, is held by
    tests/test_torch_seg_zoo.py."""
    family = {"resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d",
              "wide_resnet50_2", "wide_resnet101_2"}
    assert PF.SUPPORTED_MODELS == JF.SUPPORTED_MODELS
    names = [n for n in PF.SUPPORTED_MODELS if n.partition("_")[2] in family]
    assert len(names) == 18
    for name in names:
        with torch.device("meta"):
            model = PF.make_seg_model(name, 19, output_stride=8)
        head = model.classifier
        assert isinstance(head, DeepLabHeadV3Plus if name.startswith("deeplabv3plus_") else DeepLabHead)
        aspp = head.aspp if name.startswith("deeplabv3plus_") else head.classifier[0]
        assert [c[0].dilation[0] for c in aspp.convs[1:4]] == [12, 24, 36], name
        assert (model.backbone.layer3[-1].conv2.dilation[0], model.backbone.layer4[-1].conv2.dilation[0]) == (2, 4)
        assert not model.training
        conv2 = model.backbone.layer1[0].conv2
        groups, width = {"resnext50_32x4d": (32, 128), "resnext101_32x8d": (32, 256), "wide_resnet50_2": (1, 128),
                         "wide_resnet101_2": (1, 128)}.get(name.partition("_")[2], (1, 64))
        assert (conv2.groups, conv2.out_channels) == (groups, width), name
