"""DDPM training: the train state and the train step.

Port of weatherconverter_tpu/training/diffusion.py. Per step: draw
t ~ U[0, T) and noise ~ N(0, I), q-sample, predict eps with the UNet, take
the eps-MSE in f32, then one Adam update and one EMA update. Images are
NHWC at this module's functions, as in JAX; the UNet runs NCHW inside.

What differs from JAX:
  - The step runs eagerly and updates the state IN PLACE: the parameters,
    Adam's moments, the EMA shadow and the step count. That is what the
    JAX step's donation of the state did. The returned state is the one
    passed in.
  - Randomness comes from a `torch.Generator`; `t=` and `noise=` replay
    given draws instead (a test replays JAX's).
  - On CUDA, compute runs under autocast in `dtype` (bf16 in training);
    parameters, Adam's state and the EMA stay f32, and the loss is f32.
    The attention layers at N >= 1024 go through the flash kernels, K1
    forward and K3 backward (ops/attention.FlashAttentionFunction).
  - Data parallelism (`mesh=`, parallel/): one process per card, each with
    its rows of the global batch (parallel.sharding.shard_batch). The step
    is JAX's global-batch program: t and the noise are drawn (or replayed
    through `t=`/`noise=`) for the global batch and each rank takes its
    rows, the augmentation's draws likewise (parallel.sharding.
    global_draws); each rank's loss is its share of the global mean,
    the gradients are summed across ranks before the one Adam update, and
    the loss returned is the global mean on every rank. `fsdp=True` takes a
    state that parallel.fsdp.shard_state_fsdp sharded (parameters, Adam's
    moments, the EMA); FSDP reduce-scatters the sharded gradients, the rest
    are all-reduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.diffusion.schedule import NoiseSchedule, q_sample
from weatherconverter_tpu_torch.parallel.sharding import (
    all_reduce_sum,
    check_mesh,
    mesh_rank,
    mesh_width,
    global_draws,
    sync_grads,
)
from weatherconverter_tpu_torch.training import optim as optim_lib
from weatherconverter_tpu_torch.training.losses import mse_loss

# (uint8 or float NHWC images, generator) -> [-1, 1] f32 NHWC images; under a mesh the generator is a
# parallel.sharding.GlobalDraws, which data/transforms' draws take
AugmentFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


class EMA:
    """Exponential moving average of the parameters: f32 shadow copies that
    do not alias the live parameters, updated after each optimizer step as
    e <- e * decay + p * (1 - decay)."""

    def __init__(self, decay: float, params: dict[str, torch.Tensor]):
        self.decay = decay
        self.params = params

    @classmethod
    def create(cls, model: nn.Module, decay: float = 0.999) -> "EMA":
        return cls(decay, {n: p.detach().float().clone() for n, p in model.named_parameters()})

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        from torch.distributed.tensor import DTensor

        pairs = list(zip(self.params.values(), (p.detach().float() for _, p in model.named_parameters())))
        # FSDP leaves sharded (DTensor) and replicated shadows side by side: one foreach call each
        for kind in (True, False):
            shadow = [e for e, _ in pairs if isinstance(e, DTensor) == kind]
            live = [p for e, p in pairs if isinstance(e, DTensor) == kind]
            if shadow:
                torch._foreach_mul_(shadow, self.decay)
                torch._foreach_add_(shadow, live, alpha=1.0 - self.decay)

    def state_dict(self) -> dict[str, Any]:
        return {"decay": self.decay, "params": dict(self.params)}

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.decay = float(state["decay"])
        for name, value in state["params"].items():
            self.params[name].copy_(value)


@dataclasses.dataclass
class DDPMTrainState:
    """The model (its parameters), the optimizer (Adam's state), the EMA
    shadow, the step count and the epoch: what a checkpoint holds."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[EMA] = None
    step: int = 0
    epoch: int = 0

    def state_dict(self) -> dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema is None else self.ema.state_dict(),
            "step": self.step,
            "epoch": self.epoch,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """A checkpoint without an EMA leaves this state's EMA as it is."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None and state.get("ema") is not None:
            self.ema.load_state_dict(state["ema"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])


def create_ddpm_state(
    model: nn.Module,
    lr: float = 1e-4,
    optimizer: Optional[torch.optim.Optimizer] = None,
    ema_decay: float = 0.0,
) -> DDPMTrainState:
    """Adam(lr) over an initialized model, and an EMA shadow when
    ema_decay > 0. The model is already on its device."""
    opt = optimizer if optimizer is not None else optim_lib.adam(model.parameters(), lr)
    ema = EMA.create(model, ema_decay) if ema_decay > 0 else None
    return DDPMTrainState(model=model, optimizer=opt, ema=ema)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def ddpm_loss_fn(
    model: nn.Module,
    sched: NoiseSchedule,
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rows: Optional[slice] = None,
    batch_of: Optional[int] = None,
) -> torch.Tensor:
    """images (B, H, W, C) in [-1, 1] -> eps-MSE, f32. t ~ U[0, T) and
    noise ~ N(0, I) are drawn from `generator` unless given. With `rows`,
    `images` are those rows of a batch of `batch_of`: t and noise are drawn
    (or given) for that batch and these rows taken."""
    dev = images.device
    b = images.shape[0] if rows is None else batch_of
    shape = (b,) + tuple(images.shape[1:])
    if t is None:
        t = torch.randint(0, sched.T, (b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=dev, dtype=images.dtype)
    t = torch.as_tensor(t, device=dev).long()
    noise = torch.as_tensor(noise).to(dev, images.dtype)
    if rows is not None:
        t, noise = t[rows], noise[rows]
    xt = q_sample(sched, images, noise, t)
    return mse_loss(model(_nchw(xt), t), _nchw(noise))


def _compute_context(device: torch.device, dtype: Optional[torch.dtype]):
    if dtype is None or device.type != "cuda":
        return contextlib.nullcontext()
    return torch.autocast("cuda", dtype=dtype)


def train_step(
    state: DDPMTrainState,
    images: torch.Tensor,
    sched: NoiseSchedule,
    generator: Optional[torch.Generator] = None,
    augment_fn: Optional[AugmentFn] = None,
    accum_steps: int = 1,
    *,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> tuple[DDPMTrainState, torch.Tensor]:
    """One DDPM step, in place; returns (state, loss as a 0-d f32 tensor).

    `augment_fn(images, generator)` runs the on-device augmentation first,
    in the same step body as the plain path, so the optimizer and EMA
    updates cannot drift apart between the two. `accum_steps > 1` splits
    the batch into that many microbatches, each with its own draws, and
    takes the MEAN of their gradients before the one optimizer and EMA
    update; `t`/`noise` then hold the whole batch's draws. `dtype` is the
    autocast type on CUDA (None: the parameters' own). With `mesh`,
    `images` are this rank's rows of the global batch and `t`/`noise` the
    global batch's draws (module docstring)."""
    width, rank = mesh_width(mesh), mesh_rank(mesh)
    if augment_fn is not None:
        images = augment_fn(images, global_draws(mesh, accum_steps, generator))
    b = images.shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} is not divisible by accum_steps {accum_steps}")
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    micro = b // accum_steps
    total = torch.zeros((), device=images.device)
    for i in range(accum_steps):
        part = slice(i * micro, (i + 1) * micro)
        glob = slice(i * micro * width, (i + 1) * micro * width)  # this microbatch's rows of the global draws
        with _compute_context(images.device, dtype):
            loss = ddpm_loss_fn(model, sched, images[part], generator,
                                t=None if t is None else t[glob], noise=None if noise is None else noise[glob],
                                **({} if mesh is None else dict(rows=slice(rank * micro, (rank + 1) * micro),
                                                                batch_of=micro * width)))
        if mesh is not None:
            loss = loss / width  # this rank's share of the global mean
        (loss / accum_steps).backward()
        total += loss.detach()
    sync_grads(model.parameters(), mesh)
    opt.step()
    if state.ema is not None:
        state.ema.update(model)
    state.step += 1
    return state, all_reduce_sum(total, mesh) / accum_steps


def make_train_step(
    sched: NoiseSchedule,
    mesh=None,
    augment_fn: Optional[AugmentFn] = None,
    fsdp: bool = False,
    accum_steps: int = 1,
    dtype: Optional[torch.dtype] = None,
):
    """step(state, images, generator=None, *, t=None, noise=None) ->
    (state, loss): `train_step` with its options bound. The update is in
    place (see the module docstring), as the donated JAX step's was. With
    `mesh`, images are this rank's rows (parallel.sharding.shard_batch);
    `fsdp` needs a mesh and a state that parallel.fsdp sharded."""
    check_mesh(mesh, "make_train_step")
    if fsdp and mesh is None:
        raise ValueError("make_train_step: fsdp=True needs a mesh (parallel.make_mesh under torchrun)")

    def step(state, images, generator=None, *, t=None, noise=None):
        return train_step(state, images, sched, generator, augment_fn, accum_steps, t=t, noise=noise, dtype=dtype,
                          mesh=mesh)

    return step


def make_eval_loss(sched: NoiseSchedule, model: nn.Module, mesh=None, dtype: Optional[torch.dtype] = None):
    """eval_loss(images, generator=None, *, t=None, noise=None) -> the eps-MSE
    without gradients; fix the generator's seed (or t and noise) for a
    deterministic validation loss. With `mesh`, images are this rank's rows
    and t/noise the global batch's; the loss is the global batch's mean on
    every rank."""
    check_mesh(mesh, "make_eval_loss")
    width, rank = mesh_width(mesh), mesh_rank(mesh)

    def eval_loss(images, generator=None, *, t=None, noise=None):
        b = images.shape[0]
        rows = {} if mesh is None else dict(rows=slice(rank * b, (rank + 1) * b), batch_of=b * width)
        with torch.no_grad(), _compute_context(images.device, dtype):
            loss = ddpm_loss_fn(model, sched, images, generator, t=t, noise=noise, **rows)
        return loss if mesh is None else all_reduce_sum(loss / width, mesh)

    return eval_loss
