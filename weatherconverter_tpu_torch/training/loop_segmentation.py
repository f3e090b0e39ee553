"""Segmentation training loop (port of weatherconverter_tpu/training/loop_segmentation.py).

Epochs over the ACDC pairs: the augmented train step (crop, flip, jitter,
noise, class-wise masking, normalize on the device; SGD in two groups under
PolyLR stepped once a batch; the input-gradient magnitude logged beside the
loss), then a validation pass (a confusion matrix kept on the device,
mIoU on the host) and a checkpoint every epoch, the best "Mean IoU" step
recorded (core/checkpoint.py). Resume restores the latest step and restarts
its epoch; SIGTERM flushes a checkpoint and returns.

One device: the CUDA card (`training.device="auto"`, the default, which
raises when there is none) or the device the config names; the CPU only on
request.

Precision. On CUDA the step runs under bf16 autocast when `training.dtype`
is "bfloat16", and in f32 otherwise, as the JAX loop builds the seg model
in f32 unless that dtype is bfloat16. An f32 run keeps f32 arithmetic
through the whole loop: it turns TF32 off for cuDNN's convolutions
(`torch.backends.cudnn.allow_tf32`, which PyTorch leaves on, so f32
convolutions would otherwise keep 10 bits of mantissa) and keeps f32
matmuls at "highest" precision (PyTorch's default), for the run's length
(`core/precision.f32_arithmetic`, which loop_diffusion and the inference
commands share). A user who asks for f32 asks for the f32 result, which
the CPU tests hold against JAX's; bf16 is the fast choice. On the CPU the
step runs in f32, as the JAX loop does off the TPU. The
train model is built deterministic (ASPP's dropout off), with the
backbone's BatchNorm momentum at `model.bn_momentum`, as in JAX. The
config's geometric legs (`scale_range`, `rotation_degrees`, `hue`) go to
the augment as the JAX loop passes them.

Data parallelism and FSDP as in loop_diffusion (`plan_mesh`): the global
batch over the processes of the run, the optimizer's rates scaled with it
under `scale_lr_with_batch` (every layerwise rate too, as in JAX), each
rank decoding its rows of each global batch, the validation's ragged last
batch padded with ignore-labelled rows (JAX's loop pads to the mesh width)
and the confusion matrix summed over the ranks.

What differs from JAX: `max_steps` ends the run after that many steps, as
in JAX, but the epoch it ends in is validated and checkpointed first, so a
short run leaves a best step to load. `model.pretrained_backbone` takes a .pth file on
disk; 'imagenet'/'auto' look for the file torch.hub would have cached,
under the names the JAX resolver uses for each backbone, and are refused
by name when it is absent: nothing is fetched.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Optional

import torch

from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, create_run
from weatherconverter_tpu_torch.core.config import SegConfig
from weatherconverter_tpu_torch.core.logging import MetricsLogger
from weatherconverter_tpu_torch.core.preempt import PreemptionGuard, preempt_save_index
from weatherconverter_tpu_torch.core.precision import f32_arithmetic
from weatherconverter_tpu_torch.core.rng import run_key, split_named
from weatherconverter_tpu_torch.data.transforms import seg_eval_preprocess, seg_train_augment
from weatherconverter_tpu_torch.metrics.stream import StreamSegMetrics, init_confusion
from weatherconverter_tpu_torch.models.factory import make_seg_model
from weatherconverter_tpu_torch.parallel import sharding
from weatherconverter_tpu_torch.parallel.fsdp import maybe_shard_state, sharded_fraction
from weatherconverter_tpu_torch.training.loop_diffusion import _device, ckpt_restore_into, plan_mesh
from weatherconverter_tpu_torch.training.losses import make_seg_loss
from weatherconverter_tpu_torch.training.segmentation import (
    SegTrainState,
    create_seg_state,
    make_seg_eval_step,
    make_seg_train_step,
)


def build_datasets(cfg: SegConfig):
    """(train, val) SegPairedDatasets at the config's resize resolution."""
    from weatherconverter_tpu_torch.data.datasets import SegPairedDataset

    d = cfg.data
    return tuple(SegPairedDataset(d.root_dir, split=split, weather=d.weather, images_dir=d.images,
                                  labels_dir=d.labels, resize_hw=tuple(d.transform.resize_resolution))
                 for split in (d.train_split, d.val_split))


def make_augment(cfg: SegConfig):
    """augment(images_u8, labels, generator, draws) -> (images, labels): the
    config's seg_train_augment."""
    t = cfg.data.transform

    def augment(images_u8, labels, generator=None, draws=None):
        return seg_train_augment(
            images_u8, labels, generator, crop=tuple(t.target_resolution), hflip_p=t.horizontal_flip,
            jitter=(t.jitter.brightness, t.jitter.contrast, t.jitter.saturation), noise_mean=t.random_noise.mean,
            noise_std_range=tuple(t.random_noise.std_range), masking_p=t.class_wise_masking.p,
            num_classes_to_keep=t.class_wise_masking.num_classes_to_keep, mean=tuple(t.mean), std=tuple(t.std),
            scale_range=tuple(t.scale_range) if t.scale_range else None, rotation_degrees=t.rotation_degrees,
            hue=t.hue, draws=draws)

    return augment


class PaddedPairs:
    """A pair dataset read by (index, is_pad) keys (parallel.sharding's
    `pad_ragged` loader): a pad row is the pair with every label 255
    (ignored), so it adds nothing to the confusion matrix."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, key):
        index, pad = key
        image, label = (torch.as_tensor(a) for a in self.ds[index])
        return image, torch.full_like(label, 255) if pad else label


def make_augmented_seg_train_step(cfg: SegConfig, loss_fn, mesh=None, input_grad: bool = True,
                                  dtype: Optional[torch.dtype] = None):
    """The train step on RAW uint8 paired batches, through make_seg_train_step's augment_fn hook."""
    return make_seg_train_step(loss_fn, mesh=mesh, input_grad=input_grad, augment_fn=make_augment(cfg),
                               fsdp=cfg.training.fsdp, accum_steps=cfg.training.accum_steps, dtype=dtype)


def make_val_fns(cfg: SegConfig, model, mesh=None, dtype: Optional[torch.dtype] = None):
    """(eval_step, prep), built once a run: the eval step and the center-crop
    preprocessing of a uint8 batch."""
    t = cfg.data.transform

    def prep(images_u8, labels):
        return seg_eval_preprocess(images_u8, labels, crop=tuple(t.target_resolution), mean=tuple(t.mean),
                                   std=tuple(t.std))

    return make_seg_eval_step(model, cfg.model.num_classes, mesh=mesh, dtype=dtype), prep


def validate(cfg: SegConfig, model, val_loader, device, val_fns=None, dtype: Optional[torch.dtype] = None,
             mesh=None) -> dict:
    """The metrics of one pass over `val_loader`, the confusion matrix kept on
    `device`. With `mesh`, the loader yields this rank's rows (ragged batches
    padded with ignored rows) and the matrix is summed over the ranks."""
    eval_step, prep = val_fns if val_fns is not None else make_val_fns(cfg, model, mesh=mesh, dtype=dtype)
    conf = init_confusion(cfg.model.num_classes, device)
    for images_u8, labels in val_loader:
        conf = eval_step(conf, *prep(images_u8.to(device), labels.to(device)))
    metrics = StreamSegMetrics(cfg.model.num_classes)
    metrics.update_confusion(conf)
    return metrics.get_results()


def _checkpoint_patterns(backbone: str) -> list[str]:
    """File names of a backbone's ImageNet checkpoint in the torch.hub cache
    (the JAX resolver's list)."""
    if backbone.startswith("mobilenet"):
        return ["mobilenet_v2-*.pth", "mobilenet_v2*.pth"]
    if backbone.startswith("hrnetv2_"):
        w = backbone.split("_")[-1]
        return [f"hrnetv2_w{w}*.pth", f"hrnet_w{w}*.pth", f"*hrnetv2_w{w}*.pth"]
    if backbone == "xception":
        return ["xception-*.pth", "xception*.pth"]
    return [f"{backbone}-*.pth", f"{backbone}.pth"]


def resolve_backbone_checkpoint(spec: str, model_name: str) -> str:
    """A .pth path as it is; 'imagenet'/'auto'/'hub' -> the backbone's file in
    the torch.hub cache (by the JAX resolver's names), refused when absent."""
    if spec not in ("auto", "imagenet", "hub"):
        if not os.path.isfile(spec):
            raise FileNotFoundError(f"pretrained_backbone {spec!r} is neither an existing file nor 'imagenet'/'auto'")
        return spec
    backbone = model_name.partition("_")[2]
    cache = os.path.join(torch.hub.get_dir(), "checkpoints")
    patterns = _checkpoint_patterns(backbone)
    for pattern in patterns:
        found = sorted(glob.glob(os.path.join(cache, pattern)))
        if found:
            return found[0]
    raise FileNotFoundError(f"pretrained_backbone={spec!r} needs {backbone}'s ImageNet checkpoint ({patterns}), "
                            f"absent from the torch.hub cache {cache}; the port fetches nothing: give the .pth path")


def backbone_keys(sd: dict, model_name: str) -> dict:
    """A classification checkpoint's keys -> the seg backbone's: MobileNetV2's
    `features.{i}` split at 4 into `low_level_features` / `high_level_features`
    (features.18 and the classifier dropped); the ResNets' and Xception's
    `fc` (and Xception's `bn4`, after the tapped conv4) and HRNet's
    `bn_classifier` dropped."""
    backbone = model_name.partition("_")[2]
    if backbone == "mobilenet":
        out = {}
        for k, v in sd.items():
            parts = k.split(".")
            if parts[0] == "features" and int(parts[1]) < 18:
                attr = "low_level_features" if int(parts[1]) < 4 else "high_level_features"
                out[f"{attr}.{k.split('.', 1)[1]}"] = v
        return out
    if backbone == "xception":
        drop = ("fc.", "bn4.")
    elif backbone.startswith("hrnetv2"):
        drop = ("bn_classifier.",)
    else:
        drop = ("fc.",)
    return {k: v for k, v in sd.items() if not k.startswith(drop)}


def load_pretrained_backbone(model, spec: str, model_name: str) -> None:
    """A classification checkpoint into `model.backbone` by torch parameter
    name (`backbone_keys`; a file without `num_batches_tracked` is accepted)."""
    sd = torch.load(resolve_backbone_checkpoint(spec, model_name), map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    missing, unexpected = model.backbone.load_state_dict(backbone_keys(sd, model_name), strict=False)
    bad = unexpected + [k for k in missing if not k.endswith("num_batches_tracked")]
    if bad:
        raise RuntimeError(f"pretrained backbone {spec!r} does not fit {model_name}: {bad[:8]}")


def train(cfg: SegConfig, max_steps: Optional[int] = None, datasets=None) -> SegTrainState:
    """Full training run; returns the final state. `max_steps` stops early
    (smoke runs); `datasets` = (train, val) replaces the ACDC folders:
    anything indexable that yields (uint8 (H, W, 3), uint8 (H, W)) pairs."""
    tr = cfg.training
    device = _device(tr.device)
    dtype = torch.bfloat16 if tr.dtype == "bfloat16" and device.type == "cuda" else None
    keys = split_named(run_key(tr.random_seed), "init", "train", device=device)

    train_ds, val_ds = datasets if datasets is not None else build_datasets(cfg)
    if len(train_ds) == 0:
        raise FileNotFoundError(f"seg train set is empty: no *_rgb_anon/*_gt_labelIds pairs under "
                                f"{cfg.data.root_dir!r} for {list(cfg.data.weather)!r}, split {cfg.data.train_split!r}")
    mesh, global_batch = plan_mesh(tr, len(train_ds), device)
    if tr.scale_lr_with_batch and global_batch != tr.batch_size:
        factor = global_batch / tr.batch_size
        cfg = cfg.model_copy(deep=True)
        cfg.optimizer.params["lr"] = cfg.optimizer.params.get("lr", 1e-4) * factor
        cfg.optimizer.layerwise_lr = {k: v * factor for k, v in cfg.optimizer.layerwise_lr.items()}
        tr = cfg.training
    m = cfg.model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(keys["init"].initial_seed())
        model = make_seg_model(m.name, m.num_classes, m.output_stride, train=True, bn_momentum=m.bn_momentum)
    if m.pretrained_backbone:
        load_pretrained_backbone(model, m.pretrained_backbone, m.name)
    model = model.to(device)

    pin = device.type == "cuda"
    # the JAX seg loop decodes on the loader's default 8 threads, whatever training.num_workers says
    loader = sharding.loader(train_ds, global_batch, mesh, shuffle=True, seed=tr.random_seed, drop_last=True,
                             accum_steps=tr.accum_steps, pin_memory=pin)
    val_loader = sharding.loader(val_ds if mesh is None else PaddedPairs(val_ds), global_batch, mesh, shuffle=False,
                                 drop_last=False, pad_ragged=mesh is not None, pin_memory=pin)
    max_iters = max(1, len(loader) * tr.epochs)
    state = create_seg_state(model, cfg.optimizer, max_iters, tr.scheduler.type, tr.scheduler.params)

    run_dir = create_run(cfg.folders.output)
    logger = MetricsLogger(run_dir, config=cfg.model_dump())
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"), best_metric_name="Mean IoU", best_mode="max")
    start_epoch = 0
    if tr.resume_training and tr.resume_checkpoint:
        state = ckpt_restore_into(tr.resume_checkpoint, state)
        start_epoch = state.step // max(1, len(loader))
        logger.print(f"resumed from {tr.resume_checkpoint} at step {state.step} (epoch {start_epoch})")
    state = maybe_shard_state(mesh, state, fsdp=tr.fsdp)
    if tr.fsdp:
        logger.print(f"FSDP: {sharded_fraction(state):.1%} of state bytes sharded across "
                     f"{sharding.mesh_width(mesh)} ranks")
    if global_batch != tr.batch_size:
        logger.print(f"DP x{sharding.mesh_width(mesh)}: global batch {global_batch} ({tr.batch_size}/rank)")
    if datasets is None:
        from weatherconverter_tpu_torch.data import native

        logger.print(native.describe())
    step_fn = make_augmented_seg_train_step(cfg, make_seg_loss(tr.loss_function.type, tr.loss_function.params),
                                            mesh=mesh, dtype=dtype)
    val_fns = make_val_fns(cfg, state.model, mesh=mesh, dtype=dtype)
    flag_group = sharding.host_group(mesh)

    global_step = state.step
    with PreemptionGuard() as guard, f32_arithmetic(device) if dtype is None else contextlib.nullcontext():
        for epoch in range(start_epoch, tr.epochs):
            t0, stop = time.time(), False
            for images_u8, labels in loader:
                state, loss, ig = step_fn(state, images_u8.to(device, non_blocking=True),
                                          labels.to(device, non_blocking=True), keys["train"])
                global_step += 1
                if global_step % tr.log_interval == 0:
                    logger.log({"train/loss": loss, "train/input_grad": ig, "epoch": epoch}, step=global_step)
                if guard.triggered_anywhere(flag_group):
                    # SIGTERM mid-epoch: flush the post-step state; a resume restarts this epoch
                    ckpt.save(preempt_save_index(ckpt, global_step), state)
                    ckpt.wait()
                    logger.print(f"preempted (signal {guard.received}): checkpoint flushed at step "
                                 f"{global_step} (epoch {epoch}), exiting")
                    logger.finish()
                    return state
                if max_steps is not None and global_step >= max_steps:
                    stop = True
                    break
            results = validate(cfg, state.model, val_loader, device, val_fns, mesh=mesh)
            logger.log({"val/mIoU": results["Mean IoU"], "val/OverallAcc": results["Overall Acc"], "epoch": epoch,
                        "epoch/sec": time.time() - t0}, step=global_step)
            state.epoch = epoch + 1
            ckpt.save(epoch + 1, state, metrics={"Mean IoU": results["Mean IoU"]})
            if stop:
                break
    ckpt.wait()
    logger.finish()
    return state
