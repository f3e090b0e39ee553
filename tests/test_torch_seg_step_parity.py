"""The seg step probe's measures (probes/seg_step_parity.py), on the CPU at a
tiny config: a step read against itself is 0 on every measure, and each
planted fault moves the measures it breaks by what its arithmetic gives
(chip_smoke.py's phase 15 gates the card's step on these measures and
checks that every fault breaks a limit)."""

import pytest
import torch

from weatherconverter_tpu_torch.core.config import load_seg_config
from weatherconverter_tpu_torch.models.factory import make_seg_model
from weatherconverter_tpu_torch.probes import seg_step_parity as SP

TINY = """
model: {name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16, bn_momentum: 0.01}
data:
  transform: {resize_resolution: [40, 48], target_resolution: [32, 32]}
"""
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """(cfg, reference model, data, the reference step, its pooled leaves) at batch 2, damped x 0.1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("seg") / "tiny.yaml"
    path.write_text(TINY)
    cfg = load_seg_config(str(path))
    reference = SP.reference_model(cfg, 0.1)
    data = SP.batch(cfg, 2)
    yield cfg, reference, data, SP.run_step(cfg, reference, data, CPU), SP.pooled_leaves(reference)
    torch.set_num_threads(n)


def test_a_step_read_against_itself_is_zero(step):
    cfg, reference, data, ref, pooled = step
    c = SP.compare(SP.run_step(cfg, reference, data, CPU), ref, pooled)
    assert (c["loss"], c["update"], c["update_without_pooled"], c["stats"], c["stats_worst"][1]) == (0, 0, 0, 0, 0)
    assert c["agree"] == 1.0


POOLED_BN_VAR = "classifier.aspp.convs.4.2.running_var"


@pytest.mark.parametrize("fault, expect", [
    # the first SGD step's update is the rate times (gradient + decay): x 2 exactly in the head
    ("head_lr_x2", lambda c: c["update_head"] == pytest.approx(1.0, rel=1e-6) and c["update_backbone"] == 0),
    # at batch 2 the pooled BatchNorm sees n = 2 values: torch's n / (n - 1) doubles its variance term
    ("unbiased_running_var", lambda c: c["stats_worst"][0] == POOLED_BN_VAR
     and c["stats_worst"][1] == pytest.approx(1.0, rel=1e-4) and c["update"] == 0),
    ("head_bn_momentum", lambda c: c["stats"] > 0.5 and c["update"] == 0),
    ("zero_logits", lambda c: c["input_grad"][0] == 0 and c["update"] == pytest.approx(1.0, abs=1e-2)
     and c["agree"] < 0.5),
    ("dropout_on", lambda c: c["loss"] > 0 and c["update_without_pooled"] > 0.05),
])
def test_each_planted_fault_moves_what_it_breaks(step, fault, expect):
    cfg, reference, data, ref, pooled = step
    c = SP.compare(SP.run_step(cfg, reference, data, CPU, fault=fault), ref, pooled)
    assert expect(c), SP.line(fault, c)
    assert torch.nn.BatchNorm2d.forward is not SP.norm.BatchNorm2d.forward  # the fault is undone


@pytest.mark.parametrize("name, leaf", [("deeplabv3plus_resnet18", "classifier.aspp.convs.4.1.weight"),
                                        ("deeplabv3_resnet18", "classifier.classifier.0.convs.4.1.weight")])
def test_pooled_leaves_name_each_aspp_pooling_conv(name, leaf):
    model = make_seg_model(name, 5)
    assert SP.pooled_leaves(model) == [leaf]
    assert dict(model.named_parameters())[leaf].shape[2:] == (1, 1)


def test_the_probe_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    assert SP.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
