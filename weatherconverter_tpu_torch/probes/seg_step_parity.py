"""One seg train step of configs/segmentation.yaml on the card, held against
the same step on the CPU (f32), tensor by tensor, with planted faults read
on the same measures.

Every run starts from the same seeded DeepLabV3+/ResNet-101 (optionally
with each residual block's last BatchNorm scale multiplied by
`residual_scale`, which damps the backbone's residual branches), takes the
same uint8 batch at 270 x 480 with striped labels and the same explicit
augmentation draws, and makes one SGD update; then the eval step predicts
on the same batch. A step is compared with the reference step by

  - loss: relative error;
  - update: relative L2 error of (new - old) over every parameter, by
    group (backbone, head), without the pooled leaves (`pooled_leaves`),
    and the tensors that carry the most of its squared error;
  - statistics: relative L2 error of the step's batch term of the BatchNorm
    running statistics, new - (1 - m) old = m * (the batch mean or
    variance) of every running_mean and running_var at the model's
    momentum m, over all of them and for the buffer where it is largest;
  - predictions: the share of pixels whose eval-step argmax agrees.

Runs: the CPU in f32 (the reference), float64 and bf16 autocast; the card in
f32 and in bf16 autocast (the trainer's setting), the latter twice; and the
card's step in both under each fault of FAULTS, on the last scale given.

    python -m weatherconverter_tpu_torch.probes.seg_step_parity [--batch 2] [--scales 1,0.1]

Without a card it exits with code 2. The result goes to
chiprun_out/seg_step_parity_b<batch>.json under the repository root. chip_smoke.py's
phase 15 gates its step with these functions.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import sys
import time

import torch
from torch import nn

from weatherconverter_tpu_torch.core.config import load_seg_config
from weatherconverter_tpu_torch.data.transforms import SegDraws, seg_eval_preprocess
from weatherconverter_tpu_torch.models import norm
from weatherconverter_tpu_torch.models.deeplab import ASPPPooling
from weatherconverter_tpu_torch.models.factory import make_seg_model
from weatherconverter_tpu_torch.probes import common
from weatherconverter_tpu_torch.training import loop_segmentation
from weatherconverter_tpu_torch.training.losses import make_seg_loss
from weatherconverter_tpu_torch.training.segmentation import create_seg_state, make_seg_infer_step, train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOP_TENSORS = 5


def stripes(b: int, h: int, w: int, generator: torch.Generator, classes: int = 19) -> torch.Tensor:
    """(b, h, w) uint8 train-id labels: vertical stripes of every class, shifted per image."""
    shift = torch.randint(0, classes, (b, 1, 1), generator=generator, device=generator.device)
    cols = torch.arange(w, device=generator.device)[None, None, :] * classes // w
    return ((cols + shift) % classes).expand(b, h, w).to(torch.uint8).contiguous()


def explicit_draws(b: int, hw: tuple[int, int], crop: tuple[int, int], generator: torch.Generator) -> SegDraws:
    """SegDraws for a batch of `b` images of `hw`, from a CPU generator; masking applies to every other image."""
    (h, w), (th, tw) = hw, crop
    u = lambda *shape: torch.rand(shape, generator=generator)  # noqa: E731
    return SegDraws(offsets=(torch.randint(0, h - th + 1, (b,), generator=generator),
                             torch.randint(0, w - tw + 1, (b,), generator=generator)),
                    flip=u(b) < 0.5, jitter=tuple(0.8 + 0.4 * u(b) for _ in range(3)), noise_std=0.05 * u(b),
                    noise=torch.randn((b, th, tw, 3), generator=generator), mask_apply=torch.arange(b) % 2 == 1,
                    gumbel=-torch.log(-torch.log(1e-6 + (1 - 1e-6) * u(b, 20))))


def _draws_to(draws: SegDraws, device) -> SegDraws:
    return SegDraws(*[None if f is None else tuple(x.to(device) for x in f) if isinstance(f, tuple) else f.to(device)
                      for f in draws])


def reference_model(cfg, residual_scale: float | None = None) -> nn.Module:
    """The config's model in train mode from seed 0, on the CPU; `residual_scale`
    multiplies the scale of each residual block's last BatchNorm."""
    m = cfg.model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = make_seg_model(m.name, m.num_classes, m.output_stride, train=True, bn_momentum=m.bn_momentum)
    if residual_scale is not None:
        with torch.no_grad():
            for block in model.backbone.modules():
                last = getattr(block, "bn3", None) or getattr(block, "bn2", None)
                if last is not None and hasattr(block, "conv1"):
                    last.weight.mul_(residual_scale)
    return model


def pooled_leaves(model: nn.Module) -> list[str]:
    """The weight of each ASPP pooling branch's conv. Its whole gradient
    crosses that branch's BatchNorm, which normalizes one value per image (a
    1 x 1 map): at batch 2, the two values a and b give an input gradient
    eps / (var + eps) times that of the output, var = ((a - b) / 2)^2, and so
    0 as eps -> 0. bf16 keeps 8 significant bits of a and b, so where they
    lie close var comes out coarse or 0 and that factor grows up to 1 /
    sqrt(eps); the leaf's update is then bf16's rounding (75-88 % of the
    bf16 step's squared update error on an H100, PERF.md section 6)."""
    return [f"{name}.{conv}.weight" for name, mod in model.named_modules() if isinstance(mod, ASPPPooling)
            for conv, child in mod.named_children() if isinstance(child, nn.Conv2d)]


def batch(cfg, b: int, seed: int = 12):
    """(uint8 images (b, H, W, 3), labels, SegDraws) on the CPU, from `seed`."""
    t = cfg.data.transform
    (h, w), crop = t.resize_resolution, tuple(t.target_resolution)
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
    return imgs, stripes(b, h, w, g), explicit_draws(b, (h, w), crop, g)


# planted faults: name -> what it breaks; each is applied to one run by `_fault`
FAULTS = {
    "head_lr_x2": "the head group's learning rate doubled",
    "dropout_on": "ASPP's Dropout(0.1) firing in the train step (the JAX trainer builds it deterministic)",
    "unbiased_running_var": "torch's running-variance update (unbiased batch variance) in place of flax's",
    "head_bn_momentum": "the backbone's BatchNorm momentum (0.01) in the head too, not 0.1",
    "zero_logits": "the model's logits multiplied by 0",
}


@contextlib.contextmanager
def _fault(name: str | None, model: nn.Module, state):
    if name is None:
        yield
        return
    if name == "head_lr_x2":
        inner = state.schedules[1]
        state.schedules[1] = lambda t: 2.0 * inner(t)
    elif name == "dropout_on":
        model.classifier.aspp.project[-1] = nn.Dropout(0.1)
    elif name == "head_bn_momentum":
        norm.set_bn_momentum(model.classifier, 0.01)
    hook = model.register_forward_hook(lambda mod, args, out: out * 0.0) if name == "zero_logits" else None
    forward = norm.BatchNorm2d.forward
    if name == "unbiased_running_var":
        norm.BatchNorm2d.forward = nn.BatchNorm2d.forward
    try:
        yield
    finally:
        norm.BatchNorm2d.forward = forward
        if hook is not None:
            hook.remove()


# cuDNN's algorithms by its heuristics, deterministic ones, during a step: the autotuner's picks differ
# between processes, and on the H100 they moved the same tree's bf16 update 0.30 or 0.45 from the CPU's
# (in the pooled leaf)
def _pinned_cudnn():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def run_step(cfg, reference: nn.Module, data, device, dtype=None, fault: str | None = None,
             pre_augmented: tuple[torch.Tensor, torch.Tensor] | None = None) -> dict:
    """One step of a copy of `reference` on `device` (autocast `dtype`: the
    port's on CUDA, torch.autocast on the CPU), then the eval step's
    prediction on the batch. `pre_augmented` = (x, y) runs the plain step
    on those (for float64, whose input the f32 augmentation cannot give).
    Returns the loss, the input-gradient magnitude, the update and the
    batch term of the statistics (f64 on the CPU, by name), the prediction
    and the seconds."""
    imgs, lbls, draws = data
    t = cfg.data.transform
    crop = tuple(t.target_resolution)
    loss_fn = make_seg_loss(cfg.training.loss_function.type, cfg.training.loss_function.params)
    to64 = pre_augmented is not None and pre_augmented[0].dtype == torch.float64
    model = copy.deepcopy(reference).to(device, torch.float64 if to64 else torch.float32)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    st = create_seg_state(model, cfg.optimizer, 100, cfg.training.scheduler.type, cfg.training.scheduler.params)
    cpu_autocast = (torch.autocast("cpu", dtype=dtype) if device.type == "cpu" and dtype is not None
                    else contextlib.nullcontext())
    t0 = time.perf_counter()
    with _fault(fault, model, st), cpu_autocast, _pinned_cudnn():
        if pre_augmented is None:
            step = loop_segmentation.make_augmented_seg_train_step(cfg, loss_fn, dtype=dtype)
            _, loss, ig = step(st, imgs.to(device), lbls.to(device), draws=_draws_to(draws, device))
        else:
            x, y = pre_augmented
            _, loss, ig = train_step(st, x.to(device), y.to(device), loss_fn, dtype=dtype)
        after = model.state_dict()
        x_eval = seg_eval_preprocess(imgs.to(device), crop=crop, mean=tuple(t.mean), std=tuple(t.std))
        if to64:
            x_eval = x_eval.double()
        pred = make_seg_infer_step(model, dtype=dtype)(x_eval)[1]
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    update = {k: (after[k] - before[k]).double().cpu() for k, _ in model.named_parameters()}
    stats = {f"{name}.{buf}": (after[f"{name}.{buf}"] - (1.0 - bn.momentum) * before[f"{name}.{buf}"]).double().cpu()
             for name, bn in reference.named_modules() if isinstance(bn, nn.BatchNorm2d)
             for buf in ("running_mean", "running_var")}
    return dict(loss=loss.item(), input_grad=ig.item(), update=update, stats=stats, pred=pred.cpu(), seconds=secs)


def augmented(cfg, data) -> tuple[torch.Tensor, torch.Tensor]:
    """The augmented (x, y) of `data` on the CPU, as the reference step sees them."""
    imgs, lbls, draws = data
    return loop_segmentation.make_augment(cfg)(imgs, lbls, None, draws)


def _rel(a: dict, b: dict, keys) -> float:
    num = sum(((a[k] - b[k]) ** 2).sum().item() for k in keys)
    den = sum((b[k] ** 2).sum().item() for k in keys)
    return (num / den) ** 0.5 if den > 0 else float("nan")


def compare(run: dict, ref: dict, pooled: list[str]) -> dict:
    """`run` against `ref` on the measures of the module docstring."""
    names = list(ref["update"])
    head = [k for k in names if not k.startswith("backbone.")]
    den = sum((ref["update"][k] ** 2).sum().item() for k in names)
    shares = sorted(((((run["update"][k] - ref["update"][k]) ** 2).sum().item() / den, k) for k in names),
                    reverse=True)[:TOP_TENSORS]
    return dict(
        loss=abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
        update=_rel(run["update"], ref["update"], names),
        update_backbone=_rel(run["update"], ref["update"], [k for k in names if k not in head]),
        update_head=_rel(run["update"], ref["update"], head),
        update_without_pooled=_rel(run["update"], ref["update"], [k for k in names if k not in set(pooled)]),
        top_tensors=[(k, s) for s, k in shares],
        stats=_rel(run["stats"], ref["stats"], list(ref["stats"])),
        stats_worst=max(((_rel(run["stats"], ref["stats"], [k]), k) for k in ref["stats"]
                         if ref["stats"][k].abs().max() > 0), default=(float("nan"), ""))[::-1],
        agree=(run["pred"] == ref["pred"]).float().mean().item(),
        input_grad=(run["input_grad"], ref["input_grad"]),
    )


def line(name: str, c: dict) -> str:
    top = ", ".join(f"{re.sub(r'^(backbone|classifier)[.]', '', k)} {s:.3g}" for k, s in c["top_tensors"])
    return (f"{name}: loss {c['loss']:.3e}, update {c['update']:.3e} (backbone {c['update_backbone']:.3e}, head "
            f"{c['update_head']:.3e}, without the pooled leaves {c['update_without_pooled']:.3e}), statistics' "
            f"batch term {c['stats']:.3e} (largest in {c['stats_worst'][0]}: {c['stats_worst'][1]:.3e}), predictions {c['agree']:.5f}, input-gradient magnitude "
            f"{c['input_grad'][0]:.4e} vs {c['input_grad'][1]:.4e}; largest shares of the squared update error: {top}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--scales", default="1,0.1", help="residual scales, 1 = the fresh model; faults run at the last")
    args = p.parse_args(argv)
    if not common.require_cuda("seg_step_parity"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    cfg = load_seg_config(os.path.join(REPO, "configs", "segmentation.yaml"))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    data = batch(cfg, args.batch)
    x, y = augmented(cfg, data)
    scales = [float(s) for s in args.scales.split(",")]
    result = dict(card=card, batch=args.batch, readings={})
    for scale in scales:
        reference = reference_model(cfg, None if scale == 1 else scale)
        pooled = pooled_leaves(reference)
        ref = run_step(cfg, reference, data, cpu)
        runs = {"cpu_f64": lambda: run_step(cfg, reference, data, cpu, pre_augmented=(x.double(), y)),
                "cpu_bf16": lambda: run_step(cfg, reference, data, cpu, torch.bfloat16),
                "card_f32": lambda: run_step(cfg, reference, data, cuda),
                "card_bf16": lambda: run_step(cfg, reference, data, cuda, torch.bfloat16)}
        if scale == scales[-1]:
            for dt, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
                runs.update({f"card_{tag}_{f}": (lambda f=f, dt=dt: run_step(cfg, reference, data, cuda, dt, f))
                             for f in FAULTS})
        common.log(f"residual scale {scale}, batch {args.batch}, against the CPU in f32 ({ref['seconds']:.1f} s; "
                   f"pooled leaves {pooled}):")
        readings = {}
        for name, fn in runs.items():
            run = fn()
            readings[name] = compare(run, ref, pooled)
            common.log(f"  {line(name, readings[name])} ({run['seconds']:.1f} s)")
            if name == "card_bf16":
                readings["card_bf16_rerun_vs_card_bf16"] = compare(
                    run_step(cfg, reference, data, cuda, torch.bfloat16), run, pooled)
                common.log("  " + line("card_bf16_rerun_vs_card_bf16", readings["card_bf16_rerun_vs_card_bf16"]))
            del run
        result["readings"][str(scale)] = readings
    out = os.path.join(REPO, "chiprun_out", f"seg_step_parity_b{args.batch}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    common.log(f"wrote {out} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
