"""The port's segmentation training slice against the JAX package's, on the CPU:
the losses, the metrics, the schedules and SGD groups, the train step (two
SGD+PolyLR updates, and one accumulated over two microbatches), the loop with
its validation, best checkpoint and resume, and the best step's loading by
the translation and serving loaders.

The train-step comparisons run both sides in float64 (JAX under
`jax.enable_x64`). A freshly initialised BatchNorm ResNet in train mode
amplifies rounding: against its own float64 value, JAX's f32 gradient of a
ResNet-18 step here is up to 1.6 % off (relative L2 of a tensor) and the
port's 0.3 %, so an f32 comparison could not tell a fault from rounding. In
float64 the two agree to 1e-8 (measured), and the stated bounds hold with a
margin. Both losses take their cross-entropy in f32 (each model casts its
logits), so losses and input-gradient magnitudes are compared to 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seg_pair_from_shapes

from weatherconverter_tpu.metrics import stream as JM
from weatherconverter_tpu.models import factory as JF
from weatherconverter_tpu.training import losses as JL
from weatherconverter_tpu.training import optim as JO
from weatherconverter_tpu.training import segmentation as JS
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, restore_auto
from weatherconverter_tpu_torch.core import precision
from weatherconverter_tpu_torch.core.config import SegConfig, load_translation_config
from weatherconverter_tpu_torch.metrics import stream as PM
from weatherconverter_tpu_torch.models import factory as PF
from weatherconverter_tpu_torch.training import loop_segmentation
from weatherconverter_tpu_torch.training import losses as PL
from weatherconverter_tpu_torch.training import optim as PO
from weatherconverter_tpu_torch.training import segmentation as PS

NAME, CLASSES = "deeplabv3plus_resnet18", 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OptCfg:
    """Rates large enough that every update stands well above the bounds."""

    params = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}
    layerwise_lr = {"backbone": 0.01, "classifier": 0.05}


# --- losses, metrics ---

@pytest.mark.parametrize("kind, params", [("CrossEntropyLoss", {"ignore_index": 255}),
                                          ("CrossEntropyLoss", {"reduction": "sum"}),
                                          ("FocalLoss", {"alpha": 0.5, "gamma": 2.0}), ("focal", {})])
def test_seg_losses_match_jax(kind, params):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 7, CLASSES)).astype(np.float32) * 3
    labels = rng.integers(0, CLASSES, (2, 6, 7)).astype(np.int64)
    labels[0, :2] = 255
    ref = JL.make_seg_loss(kind, params)(jnp.asarray(logits), jnp.asarray(labels))
    got = PL.make_seg_loss(kind, params)(torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    everything_ignored = torch.full((2, 6, 7), 255)
    assert PL.make_seg_loss(kind, params)(torch.from_numpy(logits).permute(0, 3, 1, 2), everything_ignored) == 0
    with pytest.raises(ValueError, match="unknown loss"):
        PL.make_seg_loss("Dice")


def test_confusion_matrix_and_metrics_match_jax():
    """Integer counts, rows gt and columns prediction, 255 and ids >= C dropped;
    the metric dict equal to JAX's to float64 rounding."""
    rng = np.random.default_rng(1)
    pred = rng.integers(0, CLASSES, (3, 9, 11))
    label = rng.integers(0, CLASSES, (3, 9, 11)).astype(np.uint8)
    label[0, :3], label[1, :2] = 255, 7
    ref = JM.confusion_update(JM.init_confusion(CLASSES), jnp.asarray(pred), jnp.asarray(label), CLASSES)
    got = PM.confusion_update(PM.init_confusion(CLASSES), torch.from_numpy(pred), torch.from_numpy(label), CLASSES)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), np.asarray(ref))
    assert got.sum() == ((label < CLASSES).sum()) and got[2, 3] == ((label == 2) & (pred == 3)).sum()
    want, have = JM.compute_metrics(np.asarray(ref)), PM.compute_metrics(got.numpy())
    assert have.keys() == want.keys() and have["Class IoU"] == pytest.approx(want["Class IoU"], rel=1e-12)
    for k in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        assert have[k] == pytest.approx(want[k], rel=1e-12), k
    jm, pm = JM.StreamSegMetrics(CLASSES), PM.StreamSegMetrics(CLASSES)
    for i in range(3):
        jm.update(label[i], pred[i])
        pm.update(label[i], pred[i])
    pm.update_confusion(got)
    jm.update_confusion(np.asarray(ref))
    assert pm.get_results()["Mean IoU"] == pytest.approx(jm.get_results()["Mean IoU"], rel=1e-12)
    assert PM.StreamSegMetrics.to_str(pm.get_results()) == JM.StreamSegMetrics.to_str(jm.get_results())
    meter = PM.AverageMeter()
    for v in (1.0, 2.0, 4.5):
        meter.update("loss", v)
    assert meter.get_results("loss") == pytest.approx(7.5 / 3)


# --- schedules, optimizer ---

@pytest.mark.parametrize("kind, params", [("PolyLR", {"power": 0.9}), ("PolyLR", {"power": 1.0, "min_lr": 1e-3}),
                                          ("StepLR", {"step_size": 3, "gamma": 0.5}), ("constant", {})])
def test_schedules_match_jax(kind, params):
    ref, got = JO.make_schedule(kind, 0.01, 10, params), PO.make_schedule(kind, 0.01, 10, params)
    for t in range(13):
        want = ref(jnp.asarray(t)) if callable(ref) else ref
        assert got(t) == pytest.approx(float(want), rel=1e-6), t


def test_seg_optimizer_groups():
    model = PF.make_seg_model(NAME, CLASSES)
    opt, schedules = PO.make_seg_optimizer(model, OptCfg, 10)
    backbone, head = opt.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].startswith("backbone.") for p in backbone["params"])
    assert len(backbone["params"]) + len(head["params"]) == len(names)
    assert (backbone["lr"], head["lr"], backbone["momentum"], head["weight_decay"]) == (0.01, 0.05, 0.9, 1e-4)
    assert schedules[0](0) == 0.01 and schedules[1](5) == pytest.approx(0.05 * 0.5 ** 0.9)


# --- the train step, both sides in float64 ---

def _f64_variables():
    _, variables, port = seg_pair_from_shapes(NAME, 32, CLASSES, seed=1)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables), port.double()


def _batches(n, b=2, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, CLASSES, (b, 32, 32)).astype(np.int32)
        y[:, :4] = 255
        out.append((rng.standard_normal((b, 32, 32, 3)), y))
    return out


def _jax_steps(variables, batches, accum_steps):
    """JAX's train step over `batches` from `variables`, float64: the final
    state and each step's (loss, input-gradient magnitude)."""
    with jax.enable_x64(True):
        model = JF.make_seg_model(NAME, CLASSES, train=True, bn_momentum=0.01, dtype=jnp.float64)
        tx = JO.make_seg_optimizer(variables["params"], OptCfg, max_iters=4)
        state = JS.SegTrainState.create(apply_fn=model.apply, params=variables["params"],
                                        batch_stats=variables["batch_stats"], tx=tx)
        step = JS.make_seg_train_step(JL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255}), input_grad=True,
                                      donate=False, accum_steps=accum_steps)
        outs = []
        for x, y in batches:
            state, loss, ig = step(state, jnp.asarray(x), jnp.asarray(y))
            outs.append((float(loss), float(ig)))
        return jax.device_get(state), outs


def _port_steps(port, batches, accum_steps):
    model = PF.make_seg_model(NAME, CLASSES, train=True, bn_momentum=0.01).double()
    model.load_state_dict(port.state_dict(), strict=True)
    state = PS.create_seg_state(model, OptCfg, 4)
    step = PS.make_seg_train_step(PL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255}), accum_steps=accum_steps)
    outs = []
    for x, y in batches:
        _, loss, ig = step(state, torch.from_numpy(x), torch.from_numpy(y).long())
        outs.append((loss.item(), ig.item()))
    return state, outs


def _close_updates(got, want, start, names, what):
    """|port - JAX| <= 2e-4 of the tensor's max |JAX|, for (new - start) of every tensor in `names`."""
    for k in names:
        dw = want[k].numpy() - start[k].numpy()
        dg = got[k].detach().numpy() - start[k].numpy()
        assert np.abs(dw).max() > 0, (what, k)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=2e-4 * np.abs(dw).max(), err_msg=f"{what} {k}")


@pytest.mark.parametrize("accum_steps, steps", [(1, 2), (2, 1)])
def test_train_step_matches_jax(accum_steps, steps):
    """Two SGD+PolyLR updates at batch 2 (accum_steps 1), or one over two
    microbatches of 1 (accum_steps 2: the mean gradient, the BatchNorm
    statistics chained through the microbatches, and the ASPP pooling
    branch's BatchNorm on one value a channel). Each step's loss and
    input-gradient magnitude; after the last, every parameter's update,
    SGD's momentum buffers and the BatchNorm running statistics; the groups'
    learning rates."""
    variables, port = _f64_variables()
    batches = _batches(steps)
    jstate, jouts = _jax_steps(variables, batches, accum_steps)
    pstate, pouts = _port_steps(port, batches, accum_steps)
    np.testing.assert_allclose(np.array(pouts), np.array(jouts), rtol=1e-6)
    assert pstate.step == steps and all(ig > 0 for _, ig in pouts)
    start = port.state_dict()
    want = from_jax.deeplab_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats}, NAME)
    got = pstate.model.state_dict()
    names = [k for k, _ in pstate.model.named_parameters()]
    _close_updates(got, want, start, names, "update")
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=k)
    # optax keeps one trace a group, over the whole tree, masked outside the group
    traces = {label: jstate.opt_state.inner_states[label].inner_state[1][0].trace[label]
              for label in ("backbone", "head")}
    want_buf = from_jax.deeplab_state_dict({"params": traces, "batch_stats": jstate.batch_stats}, NAME)
    opt = pstate.optimizer
    for name, p in pstate.model.named_parameters():
        buf = opt.state[p]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), want_buf[name].numpy(), rtol=0,
                                   atol=2e-4 * np.abs(want_buf[name].numpy()).max(), err_msg=name)
    # the groups' rates for the next update, and those the last update took
    want_lrs = [float(JO.make_schedule("PolyLR", base, 4, {"power": 0.9})(jnp.asarray(steps))) for base in (0.01, 0.05)]
    np.testing.assert_allclose(pstate.learning_rates(), want_lrs, rtol=1e-6)
    np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                               [float(JO.make_schedule("PolyLR", b, 4, {"power": 0.9})(jnp.asarray(steps - 1)))
                                for b in (0.01, 0.05)], rtol=1e-6)


def test_train_step_refuses_mesh_and_a_ragged_accumulation():
    """A mesh that is not the port's ("data",) DeviceMesh is refused by name
    (data parallelism itself: tests/test_torch_parallel.py)."""
    loss = PL.make_seg_loss("CrossEntropyLoss")
    with pytest.raises(ValueError, match="DeviceMesh"):
        PS.make_seg_train_step(loss, mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        PS.make_seg_eval_step(PF.make_seg_model(NAME, CLASSES), CLASSES, mesh=object())
    state = PS.create_seg_state(PF.make_seg_model(NAME, CLASSES, train=True), OptCfg, 4)
    with pytest.raises(ValueError, match="accum_steps"):
        PS.train_step(state, torch.zeros(3, 32, 32, 3), torch.zeros(3, 32, 32, dtype=torch.long), loss, accum_steps=2)


def test_eval_and_infer_steps_match_jax():
    _, variables, port = seg_pair_from_shapes(NAME, 32, CLASSES, seed=2)
    jmodel = JF.make_seg_model(NAME, CLASSES)
    x, y = _batches(1, b=3, seed=6)[0]
    x = x.astype(np.float32)
    ref_conf = JS.make_seg_eval_step(jmodel, CLASSES)(variables["params"], variables["batch_stats"],
                                                      JM.init_confusion(CLASSES), jnp.asarray(x), jnp.asarray(y))
    conf = PS.make_seg_eval_step(port, CLASSES)(PM.init_confusion(CLASSES), torch.from_numpy(x), torch.from_numpy(y))
    # f32 logits in another summation order: a pixel whose top two logits tie to rounding may move one cell
    assert conf.sum() == int(np.asarray(ref_conf).sum()) and np.abs(conf.numpy() - np.asarray(ref_conf)).sum() <= 4
    logits, pred = PS.make_seg_infer_step(port)(torch.from_numpy(x))
    ref_logits, ref_pred = JS.make_seg_infer_step(jmodel)(variables["params"], variables["batch_stats"], jnp.asarray(x))
    assert logits.shape == (3, CLASSES, 32, 32) and pred.shape == (3, 32, 32)
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.permute(0, 2, 3, 1).numpy(), ref_logits, rtol=1e-3,
                               atol=1e-4 * np.abs(ref_logits).max())
    assert (pred.numpy() == np.asarray(ref_pred)).mean() >= 0.99


# --- the loop ---

class Pairs:
    """(uint8 (H, W, 3), uint8 (H, W)) pairs from a seed: labels in vertical stripes of train ids."""

    def __init__(self, n, seed, hw=(23, 37)):
        self.n, self.seed, self.hw = n, seed, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        h, w = self.hw
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        lbl = np.repeat(((np.arange(w) * 19 // w + i) % 19).astype(np.uint8)[None], h, 0)
        return img, lbl


def _loop_cfg(out, **training):
    return SegConfig(
        model=dict(name=NAME, num_classes=19, output_stride=16, bn_momentum=0.01),
        data=dict(transform=dict(resize_resolution=[23, 37], target_resolution=[16, 16])),
        training=dict(dict(device="cpu", random_seed=0, epochs=2, batch_size=2, num_workers=0, log_interval=1),
                      **training),
        folders=dict(output=str(out)))


def test_loop_validates_keeps_the_best_step_and_resumes(tmp_path):
    datasets = (Pairs(4, 0), Pairs(3, 1))
    state = loop_segmentation.train(_loop_cfg(tmp_path), datasets=datasets)
    assert (state.step, state.epoch) == (4, 2)
    with open(tmp_path / "0" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len([r for r in records if "train/loss" in r]) == 4
    mious = [r["val/mIoU"] for r in records if "val/mIoU" in r]
    assert len(mious) == 2 and all(0 <= v <= 1 for v in mious)
    ck = CheckpointManager(str(tmp_path / "0" / "checkpoints"), best_metric_name="Mean IoU")
    assert ck.all_steps() == [1, 2] and ck.best_value() == pytest.approx(max(mious))
    assert ck.best_step() == 1 + mious.index(max(mious))
    saved = ck.restore(step=2)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in saved["model"].items())
    # resume from the run's directory: its latest step (2 epochs done), then one more epoch
    resumed = loop_segmentation.train(
        _loop_cfg(tmp_path, epochs=3, resume_training=True, resume_checkpoint=str(tmp_path / "0" / "checkpoints")),
        datasets=datasets)
    assert (resumed.step, resumed.epoch) == (6, 3)
    assert sorted(os.listdir(tmp_path / "1" / "checkpoints")) == ["3", "best.json"]


def test_loop_max_steps_validates_and_saves_the_epoch_it_stops_in(tmp_path):
    state = loop_segmentation.train(_loop_cfg(tmp_path), max_steps=3, datasets=(Pairs(4, 0), Pairs(2, 1)))
    assert (state.step, state.epoch) == (3, 2)
    ck = CheckpointManager(str(tmp_path / "0" / "checkpoints"), best_metric_name="Mean IoU")
    assert ck.all_steps() == [1, 2] and ck.best_step() in (1, 2)


def test_loop_f32_run_on_cuda_trains_without_tf32(tmp_path, monkeypatch):
    """An f32 run as on the card (`dtype` None, the loop's `f32_arithmetic`
    called with "cuda") takes its steps with cuDNN's TF32 off and matmuls at
    "highest", as loop_diffusion does, and the settings come back after."""
    real = precision.f32_arithmetic
    monkeypatch.setattr(loop_segmentation, "f32_arithmetic", lambda device: real("cuda"))
    seen, make = [], loop_segmentation.make_augmented_seg_train_step

    def spy_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def spy(*step_args):
            seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
            return step(*step_args)
        return spy

    monkeypatch.setattr(loop_segmentation, "make_augmented_seg_train_step", spy_make)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True  # torch's default, which an f32 run must turn off
    torch.set_float32_matmul_precision("high")
    try:
        loop_segmentation.train(_loop_cfg(tmp_path), max_steps=1, datasets=(Pairs(2, 0), Pairs(2, 1)))
        assert seen == [(False, "highest")]
        assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (True, "high")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_loop_refuses_fsdp_and_an_absent_pretrained_backbone(tmp_path, monkeypatch):
    """FSDP needs a process group (torchrun): without one the loop refuses it
    by name instead of training unsharded."""
    with pytest.raises(ValueError, match="training.fsdp=true needs a process group"):
        loop_segmentation.train(_loop_cfg(tmp_path, fsdp=True), datasets=(Pairs(2, 0), Pairs(2, 1)))
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    with pytest.raises(FileNotFoundError, match="fetches nothing"):
        loop_segmentation.resolve_backbone_checkpoint("imagenet", NAME)
    with pytest.raises(FileNotFoundError, match="neither an existing file"):
        loop_segmentation.resolve_backbone_checkpoint(str(tmp_path / "none.pth"), NAME)


def test_pretrained_backbone_loads_a_classification_checkpoint(tmp_path, monkeypatch):
    """A torchvision-layout classifier file (its fc dropped, an old file
    without num_batches_tracked) into the backbone, by path or from the hub cache."""
    os.makedirs(tmp_path / "hub" / "checkpoints")
    for backbone in ("resnet18", "resnet34"):
        donor = PF.make_seg_model(f"deeplabv3plus_{backbone}", CLASSES).backbone
        sd = {k: v + 1 for k, v in donor.state_dict().items() if not k.endswith("num_batches_tracked")}
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
        torch.save(sd, tmp_path / "hub" / "checkpoints" / f"{backbone}-f37072fd.pth")
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "hub"))
    model = PF.make_seg_model(NAME, CLASSES)
    loop_segmentation.load_pretrained_backbone(model, "imagenet", NAME)
    want = torch.load(tmp_path / "hub" / "checkpoints" / "resnet18-f37072fd.pth")
    assert torch.equal(model.backbone.layer4[1].bn2.running_var, want["layer4.1.bn2.running_var"])
    with pytest.raises(RuntimeError, match="does not fit"):  # resnet34's extra blocks
        loop_segmentation.load_pretrained_backbone(model, str(tmp_path / "hub" / "checkpoints" /
                                                              "resnet34-f37072fd.pth"), NAME)


# --- the best step, for translation and serving ---

def test_translation_loaders_take_a_seg_runs_best_step(tmp_path):
    """`translate`/`serve --seg-checkpoint <run>/checkpoints` load the best
    "Mean IoU" step, not the latest, as the JAX CLI does; a resume takes the
    latest."""
    cfg = load_translation_config(None, seg=dict(model=dict(name=NAME, num_classes=CLASSES)))
    states = []
    ck = CheckpointManager(str(tmp_path), best_metric_name="Mean IoU", max_to_keep=1)
    for step, miou in ((1, 0.5), (2, 0.3), (3, 0.4)):
        model = PF.make_seg_model(NAME, CLASSES)
        state = PS.create_seg_state(model, OptCfg, 4)
        ck.save(step, state, metrics={"Mean IoU": miou})
        states.append(model.state_dict())
    assert ck.best_step() == 1 and ck.all_steps() == [1, 3]  # pruning keeps the best step
    loaded = PC.load_seg_model(cfg.seg, str(tmp_path), seed=9).state_dict()
    assert all(torch.equal(loaded[k], states[0][k]) for k in loaded)
    unet, seg, sr, _ = PC.build_translation(cfg, torch.device("cpu"), None, str(tmp_path), None, False, 0)
    assert all(torch.equal(seg.state_dict()[k], states[0][k]) for k in loaded)
    fresh = PS.create_seg_state(PF.make_seg_model(NAME, CLASSES), OptCfg, 4)
    loop_segmentation.ckpt_restore_into(str(tmp_path), fresh)
    assert all(torch.equal(fresh.model.state_dict()[k], states[2][k]) for k in loaded)
    with pytest.raises(TypeError, match="prefer_best"):  # each caller says whether it loads or resumes
        restore_auto(str(tmp_path), fresh)
