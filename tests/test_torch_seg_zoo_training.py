"""One train step of each new DeepLab family of the port against the JAX
package's, on the CPU: DeepLabV3+ over MobileNetV2, Xception and a narrow
HRNetV2 (c = 8, one stage module a stage, built directly as the JAX module
allows). The rest of the family's tests are in tests/test_torch_seg_zoo.py.

Both sides run in float64 (JAX under `jax.enable_x64`; see
tests/test_torch_seg_training.py: a fresh BatchNorm network's f32 step is
not reproducible), held as there: the loss and input-gradient magnitude to
1e-6, every parameter's update to 2e-4 of its largest entry, the BatchNorm
running statistics to 1e-6 of their largest. XLA's f64 convolutions on the
CPU are slow, so the sizes are the smallest each backbone takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seeded_leaves

from weatherconverter_tpu.models import deeplab as JD
from weatherconverter_tpu.models import factory as JF
from weatherconverter_tpu.models.backbones import hrnetv2 as JH
from weatherconverter_tpu.training import losses as JL
from weatherconverter_tpu.training import optim as JO
from weatherconverter_tpu.training import segmentation as JS
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.models import deeplab as PD
from weatherconverter_tpu_torch.models import factory as PF
from weatherconverter_tpu_torch.models.backbones import hrnetv2 as PH
from weatherconverter_tpu_torch.models.norm import set_bn_momentum
from weatherconverter_tpu_torch.training import losses as PL
from weatherconverter_tpu_torch.training import segmentation as PS

CLASSES = 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OptCfg:
    params = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}
    layerwise_lr = {"backbone": 0.01, "classifier": 0.05}


NARROW_HRNET = dict(c=8, num_blocks=(1, 1, 1))


def _models(family):
    """(JAX train model in f64, port train model in f64, conversion name)."""
    if family == "hrnet":
        jmodel = JD.DeepLabV3(
            backbone=JH.HRNetV2Features(**NARROW_HRNET, train=True, dtype=jnp.float64),
            head=JD.DeepLabHeadV3Plus(num_classes=CLASSES, aspp_dilate=(12, 24, 36), train=True, dtype=jnp.float64),
            train=True, bn_momentum=0.01)
        backbone = PH.HRNetV2Features(**NARROW_HRNET)
        set_bn_momentum(backbone, 0.01)
        head = PD.DeepLabHeadV3Plus(PH.LOW_LEVEL_CHANNELS, PH.out_channels(8), CLASSES, (12, 24, 36))
        return jmodel, PD.DeepLabV3(backbone, head).train().double(), "deeplabv3plus_hrnetv2_8"
    name = f"deeplabv3plus_{family}"
    jmodel = JF.make_seg_model(name, CLASSES, train=True, bn_momentum=0.01, dtype=jnp.float64)
    return jmodel, PF.make_seg_model(name, CLASSES, train=True, bn_momentum=0.01).double(), name


@pytest.mark.parametrize("family, hw", [("mobilenet", (34, 46)), ("xception", (78, 82)), ("hrnet", (64, 64))])
def test_train_step_matches_jax(family, hw):
    """One SGD+PolyLR step at batch 2 (BatchNorm on the batch's statistics,
    the input gradient taken): the loss and input-gradient magnitude, every
    parameter's update and every BatchNorm running statistic."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, *hw, 3))
    y = rng.integers(0, CLASSES, (2, *hw)).astype(np.int32)
    y[:, :4] = 255
    with jax.enable_x64(True):
        jmodel, port, name = _models(family)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float64)))
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), seeded_leaves(shapes, 7))
        state = JS.SegTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                        batch_stats=variables["batch_stats"],
                                        tx=JO.make_seg_optimizer(variables["params"], OptCfg, max_iters=4))
        step = JS.make_seg_train_step(JL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255}), input_grad=True,
                                      donate=False)
        state, jloss, jig = step(state, jnp.asarray(x), jnp.asarray(y))
        jstate = jax.device_get(state)
    start = from_jax.deeplab_state_dict(variables, name)
    port.load_state_dict(start, strict=True)
    pstate = PS.create_seg_state(port, OptCfg, 4)
    _, loss, ig = PS.make_seg_train_step(PL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255}))(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose([loss.item(), ig.item()], [float(jloss), float(jig)], rtol=1e-6)
    want = from_jax.deeplab_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats}, name)
    got = port.state_dict()
    for k, _ in port.named_parameters():
        dw, dg = want[k].numpy() - start[k].numpy(), got[k].numpy() - start[k].numpy()
        assert np.abs(dw).max() > 0, k
        np.testing.assert_allclose(dg, dw, rtol=0, atol=2e-4 * np.abs(dw).max(), err_msg=k)
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            w = want[k].numpy()
            assert not np.array_equal(w, start[k].numpy()), k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=k)
