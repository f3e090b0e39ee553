"""Segmentation training: the train state, the train step, the eval step and
the infer step (port of weatherconverter_tpu/training/segmentation.py).

Per step: the (optional) on-device augmentation, the forward in train mode
(BatchNorm on the batch's statistics, updating its running ones as flax
does: models/norm.py), the seg loss in f32, one backward that gives the
parameters' gradients and the input gradient, and one SGD update in two
groups whose learning rates follow their schedules at the update's index.
Images are NHWC at this module's functions, as in JAX; the model runs NCHW
inside. The step returns `input_grad_mag`, the mean over pixels of the L2
norm over channels of dL/d(normalized image): JAX's axis -1 of NHWC.

What differs from JAX:
  - The step runs eagerly and updates the state IN PLACE (parameters,
    momentum buffers, BatchNorm statistics, step count), as the JAX step's
    donation of the state did. The returned state is the one passed in.
  - The augmentation draws from a `torch.Generator`; `draws=` replays given
    draws (data/transforms.SegDraws) instead.
  - On CUDA, compute runs under autocast in `dtype` (bf16 in training);
    parameters and SGD's state stay f32, and the loss is f32.
  - Data parallelism (`mesh=`, parallel/): each rank holds its rows of the
    global batch (parallel.sharding.shard_batch: its microbatch i is its
    share of the global microbatch i) and the step is JAX's global-batch
    program: the augmentation's draws are the global batch's
    (parallel.sharding.global_draws; `draws=` holds the global draws, of
    which each rank takes its rows),
    BatchNorm takes each microbatch's statistics over every rank
    (models/norm.synced_batchnorm), the loss divides by the valid pixels of
    the whole microbatch (training/losses.py, `group=`), the gradients are
    summed across ranks before the one update, and the loss and
    `input_grad_mag` returned are the global batch's on every rank.
    `fsdp=True` takes a state that parallel.fsdp sharded. The eval step
    all-reduces each batch's confusion counts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.metrics.stream import confusion_update
from weatherconverter_tpu_torch.models.norm import synced_batchnorm
from weatherconverter_tpu_torch.parallel.sharding import (
    all_reduce_sum,
    check_mesh,
    data_group,
    global_draws,
    mesh_width,
    shard_batch,
    sync_grads,
)
from weatherconverter_tpu_torch.training import optim as optim_lib
from weatherconverter_tpu_torch.training.diffusion import _compute_context

# (uint8 NHWC images, uint8 labels, generator, draws) -> (normalized f32 NHWC images, labels)
SegAugmentFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]
LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class SegTrainState:
    """The model (parameters and BatchNorm statistics), SGD's state, the two
    groups' schedules, the step count and the epoch. A checkpoint holds all
    but the schedules, which the config rebuilds."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: list[optim_lib.Schedule]
    step: int = 0
    epoch: int = 0

    def state_dict(self) -> dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step,
                "epoch": self.epoch}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])

    def learning_rates(self) -> list[float]:
        """The groups' learning rates for the next update."""
        return [s(self.step) for s in self.schedules]


def create_seg_state(model: nn.Module, opt_cfg, max_iters: int, sched_type: str = "PolyLR",
                     sched_params: Optional[dict] = None) -> SegTrainState:
    """SGD in its two groups over a built model, already on its device."""
    opt, schedules = optim_lib.make_seg_optimizer(model, opt_cfg, max_iters, sched_type, sched_params)
    return SegTrainState(model=model, optimizer=opt, schedules=schedules)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # a view: the model sees NHWC memory as channels-last NCHW
    return x.permute(0, 3, 1, 2)


def train_step(
    state: SegTrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    loss_fn: LossFn,
    generator: Optional[torch.Generator] = None,
    augment_fn: Optional[SegAugmentFn] = None,
    accum_steps: int = 1,
    input_grad: bool = True,
    *,
    draws=None,
    dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> tuple[SegTrainState, torch.Tensor, torch.Tensor]:
    """One seg update, in place; returns (state, loss, input_grad_mag) as 0-d
    f32 tensors (input_grad_mag 0 when `input_grad` is False).

    `augment_fn(images, labels, generator, draws)` runs the on-device
    augmentation first, in the same step body as the plain path.
    `accum_steps > 1` splits the batch into that many microbatches in order
    (the BatchNorm statistics chain through them) and takes the MEAN of
    their gradients, losses and input-gradient magnitudes before the one
    update. `dtype` is the autocast type on CUDA (None: the parameters').
    With `mesh`, images and labels are this rank's rows of the global batch
    (module docstring)."""
    if augment_fn is not None:
        images, labels = augment_fn(images, labels, global_draws(mesh, accum_steps, generator),
                                    shard_batch(mesh, draws, accum_steps))
    group, width = data_group(mesh), mesh_width(mesh)
    b = images.shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} is not divisible by accum_steps {accum_steps}")
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    micro = b // accum_steps
    total = torch.zeros((), device=images.device)
    ig_total = torch.zeros((), device=images.device)
    with synced_batchnorm(model, group):
        for i in range(accum_steps):
            part = slice(i * micro, (i + 1) * micro)
            x = images[part].detach().requires_grad_(input_grad)
            with _compute_context(images.device, dtype):
                logits = model(_nchw(x))
                # under a mesh: this rank's share of the global mean (losses.py)
                loss = loss_fn(logits, labels[part]) if mesh is None else loss_fn(logits, labels[part], group=group)
            loss.backward()
            total += loss.detach()
            if input_grad:
                norms = torch.sqrt(torch.sum(x.grad.float() ** 2, dim=-1))
                ig_total += norms.mean() if mesh is None else norms.sum() / (norms.numel() * width)
    sync_grads(model.parameters(), mesh)
    if accum_steps > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        torch._foreach_mul_(grads, 1.0 / accum_steps)
    lrs = state.learning_rates()
    for i, pg in enumerate(opt.param_groups):
        pg["lr"] = lrs[pg.get("origin", i)]  # FSDP splits each group in two (parallel.fsdp)
    opt.step()
    state.step += 1
    if mesh is not None:
        sums = all_reduce_sum(torch.stack([total, ig_total]), mesh)
        total, ig_total = sums[0], sums[1]
    return state, total / accum_steps, ig_total / accum_steps


def make_seg_train_step(
    loss_fn: LossFn,
    mesh=None,
    input_grad: bool = True,
    augment_fn: Optional[SegAugmentFn] = None,
    fsdp: bool = False,
    accum_steps: int = 1,
    dtype: Optional[torch.dtype] = None,
):
    """step(state, images, labels, generator=None, *, draws=None) -> (state,
    loss, input_grad_mag): `train_step` with its options bound. The update
    is in place (see the module docstring). With `mesh`, images and labels
    are this rank's rows (parallel.sharding.shard_batch with `accum_steps`)
    and `loss_fn` takes `group=` (training/losses.make_seg_loss's do);
    `fsdp` needs a mesh and a state that parallel.fsdp sharded."""
    check_mesh(mesh, "make_seg_train_step")
    if fsdp and mesh is None:
        raise ValueError("make_seg_train_step: fsdp=True needs a mesh (parallel.make_mesh under torchrun)")

    def step(state, images, labels, generator=None, *, draws=None):
        return train_step(state, images, labels, loss_fn, generator, augment_fn, accum_steps, input_grad,
                          draws=draws, dtype=dtype, mesh=mesh)

    return step


def make_seg_eval_step(model: nn.Module, num_classes: int, mesh=None, dtype: Optional[torch.dtype] = None):
    """step(conf, images, labels) -> conf: the eval-mode forward (running
    BatchNorm statistics), argmax over the classes, and the confusion
    matrix's update, all on the device. With `mesh`, images and labels are
    this rank's rows and the batch's counts are summed over the ranks, so
    `conf` is the global one on every rank."""
    check_mesh(mesh, "make_seg_eval_step")

    def step(conf, images, labels):
        model.eval()
        with torch.no_grad(), _compute_context(images.device, dtype):
            pred = model(_nchw(images)).argmax(dim=1)
        if mesh is None:
            return confusion_update(conf, pred, labels, num_classes)
        return conf + all_reduce_sum(confusion_update(torch.zeros_like(conf), pred, labels, num_classes), mesh)

    return step


def make_seg_infer_step(model: nn.Module, dtype: Optional[torch.dtype] = None):
    """step(images NHWC) -> (logits (B, C, H, W) f32, prediction (B, H, W)
    int64); JAX's logits are NHWC with the argmax over -1."""

    def step(images):
        model.eval()
        with torch.no_grad(), _compute_context(images.device, dtype):
            logits = model(_nchw(images))
        return logits, logits.argmax(dim=1)

    return step
