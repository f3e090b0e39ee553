"""Swift-SRGAN training: generator pretraining on a pixel loss, then
adversarial fine-tuning against the Discriminator (port of
weatherconverter_tpu/training/srgan.py).

Images are NHWC at this module's functions, as in JAX; the models run NCHW
inside. Both networks train their BatchNorms as flax does
(models/norm.BatchNorm2d). Per GAN step, as in JAX:
  - D update: G's output on the LR batch (train-mode BatchNorm), then D on
    the HR batch and on that output, in that order, each forward moving D's
    running statistics; BCE(D(hr), 1) + BCE(D(sr), 0); one Adam update.
  - G update against the UPDATED D: pixel loss + adv_weight * BCE(D(sr), 1),
    D in train mode with its statistics' update discarded; one Adam update.

What differs from JAX:
  - The steps run eagerly and update the states IN PLACE (parameters,
    Adam's moments, BatchNorm statistics, step counts), as the donated JAX
    steps did. The returned states are the ones passed in.
  - JAX runs G twice a GAN step (in the D update with its statistics'
    update discarded, then in the G update) on the same parameters and
    statistics, so the two outputs are equal; the port runs it once, with
    gradients, and uses it detached in the D update. G's statistics move
    once, as in JAX.
  - On CUDA, compute runs under autocast in `dtype` (bf16 in training);
    parameters and Adam's state stay f32, and the losses are f32.
  - Data parallelism (`mesh=`, parallel/): each rank holds its rows of the
    global batch; the BatchNorms of G and D take their statistics over the
    global batch (models/norm.synced_batchnorm), each rank's losses are its
    shares of the global means, and the gradients are summed across ranks
    by an explicit all-reduce after each backward (parallel.sharding.
    sync_grads): D's after the D loss's, G's after the G loss's. Stock DDP
    would not do here: D runs forward three times a step (real, fake, and
    in the G update), and DDP's reducer expects one forward per backward
    and a fixed set of parameters that receive gradients. The losses
    returned are the global batch's on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.models.norm import synced_batchnorm
from weatherconverter_tpu_torch.parallel.sharding import (
    all_reduce_sum,
    check_mesh,
    data_group,
    mesh_width,
    sync_grads,
)
from weatherconverter_tpu_torch.training import optim as optim_lib
from weatherconverter_tpu_torch.training.diffusion import _compute_context
from weatherconverter_tpu_torch.training.losses import bce_logits


@dataclasses.dataclass
class SRGANState:
    """One network (parameters and BatchNorm statistics), its Adam, its step
    count and the completed-epoch counter (kept on G's state: the phase of
    a resumed run derives from it)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0


@dataclasses.dataclass
class SRGANStates:
    """(G, D): what an SRGAN checkpoint holds. G's entries are under the keys
    a generator loader reads (`model`), so a run's checkpoint directory loads
    into `super-resolve` and `translate` as it is."""

    gen: SRGANState
    disc: SRGANState

    def state_dict(self) -> dict[str, Any]:
        return {"model": self.gen.model.state_dict(), "optimizer": self.gen.optimizer.state_dict(),
                "disc": self.disc.model.state_dict(), "disc_optimizer": self.disc.optimizer.state_dict(),
                "step": self.gen.step, "disc_step": self.disc.step, "epoch": self.gen.epoch}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.gen.model.load_state_dict(state["model"])
        self.gen.optimizer.load_state_dict(state["optimizer"])
        self.disc.model.load_state_dict(state["disc"])
        self.disc.optimizer.load_state_dict(state["disc_optimizer"])
        self.gen.step, self.disc.step = int(state["step"]), int(state["disc_step"])
        self.gen.epoch = self.disc.epoch = int(state["epoch"])


def create_srgan_states(gen: nn.Module, disc: nn.Module, g_lr: float = 1e-4,
                        d_lr: float = 1e-4) -> tuple[SRGANState, SRGANState]:
    """Adam (optax's default) over each built network, already on its device."""
    return (SRGANState(gen, optim_lib.adam(gen.parameters(), g_lr)),
            SRGANState(disc, optim_lib.adam(disc.parameters(), d_lr)))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _pixel(sr: torch.Tensor, hr: torch.Tensor, pixel_loss: str) -> torch.Tensor:
    """L1 or L2 between the generator's NCHW f32 output and the NHWC HR batch
    (in the wider of their types, as JAX promotes)."""
    d = sr.float() - _nchw(hr)
    return torch.mean(torch.abs(d)) if pixel_loss == "l1" else torch.mean(d * d)


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Train-mode forwards inside leave the module's buffers (BatchNorm's
    running statistics and counters) as they were."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


def _check(mesh, pixel_loss: str, where: str) -> None:
    check_mesh(mesh, where)
    if pixel_loss not in ("l1", "l2"):
        raise ValueError(f"pixel_loss must be 'l1' or 'l2', not {pixel_loss!r}")


def make_pretrain_step(pixel_loss: str = "l1", mesh=None, dtype: Optional[torch.dtype] = None):
    """step(gs, lr_img, hr_img) -> (gs, loss): supervised G training on NHWC
    (LR, HR) pairs, in place; the loss a 0-d f32 tensor. With `mesh`, the
    pairs are this rank's rows of the global batch."""
    _check(mesh, pixel_loss, "make_pretrain_step")
    width = mesh_width(mesh)

    def step(gs: SRGANState, lr_img: torch.Tensor, hr_img: torch.Tensor):
        gs.model.train()
        gs.optimizer.zero_grad(set_to_none=True)
        with synced_batchnorm(gs.model, data_group(mesh)), _compute_context(lr_img.device, dtype):
            loss = _pixel(gs.model(_nchw(lr_img)), hr_img, pixel_loss) / width  # this rank's share
        loss.backward()
        sync_grads(gs.model.parameters(), mesh)
        gs.optimizer.step()
        gs.step += 1
        return gs, all_reduce_sum(loss.detach(), mesh)

    return step


def make_gan_step(adv_weight: float = 1e-3, pixel_weight: float = 1.0, mesh=None, pixel_loss: str = "l1",
                  dtype: Optional[torch.dtype] = None):
    """step(gs, ds, lr_img, hr_img) -> (gs, ds, g_loss, d_loss): the D update,
    then the G update against the updated D, in place (module docstring).
    With `mesh`, the pairs are this rank's rows of the global batch."""
    _check(mesh, pixel_loss, "make_gan_step")
    width, group = mesh_width(mesh), data_group(mesh)

    def step(gs: SRGANState, ds: SRGANState, lr_img: torch.Tensor, hr_img: torch.Tensor):
        with synced_batchnorm(gs.model, group), synced_batchnorm(ds.model, group):
            return _gan_step(gs, ds, lr_img, hr_img)

    def _gan_step(gs: SRGANState, ds: SRGANState, lr_img: torch.Tensor, hr_img: torch.Tensor):
        gen, disc = gs.model, ds.model
        gen.train()
        disc.train()
        gs.optimizer.zero_grad(set_to_none=True)
        ds.optimizer.zero_grad(set_to_none=True)
        with _compute_context(lr_img.device, dtype):
            sr = gen(_nchw(lr_img))
            # D update: real, then fake, each forward moving D's statistics
            d_real = disc(_nchw(hr_img))
            d_fake = disc(sr.detach())
            d_loss = (bce_logits(d_real, torch.ones_like(d_real))
                      + bce_logits(d_fake, torch.zeros_like(d_fake))) / width  # this rank's share
        d_loss.backward()
        sync_grads(disc.parameters(), mesh)
        ds.optimizer.step()
        ds.step += 1
        # G update against the updated D, whose statistics this forward leaves as they are (restored
        # after the backward, which reads the running statistics the forward saved)
        disc.requires_grad_(False)
        try:
            with frozen_statistics(disc):
                with _compute_context(lr_img.device, dtype):
                    d_out = disc(sr)
                    g_loss = (pixel_weight * _pixel(sr, hr_img, pixel_loss) + adv_weight * bce_logits(
                        d_out, torch.ones_like(d_out))) / width
                g_loss.backward()
        finally:
            disc.requires_grad_(True)
        sync_grads(gen.parameters(), mesh)
        gs.optimizer.step()
        gs.step += 1
        losses = all_reduce_sum(torch.stack([g_loss.detach(), d_loss.detach()]), mesh)
        return gs, ds, losses[0], losses[1]

    return step
