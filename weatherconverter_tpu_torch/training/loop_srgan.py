"""Swift-SRGAN training loop (port of weatherconverter_tpu/training/loop_srgan.py).

Raw uint8 HR batches from the loader; the random crop, flip and LR
synthesis (a box-filter downsample by the upscale factor) run on the
device; `pretrain_epochs` of pixel-loss pretraining, then the adversarial
phase; (G, D) checkpoints every `save_interval` epochs, JSONL metrics and
resume. The completed-epoch counter rides on G's state, so a resumed run
lands in the right phase; `max_steps` counts steps across both phases.

One device: the CUDA card (`training.device="auto"`, the default, which
raises when there is none) or the device the config names; the CPU only on
request. On CUDA the steps run under bf16 autocast when `training.dtype` is
"bfloat16"; on the CPU in f32, as the JAX loop does off the TPU.

What differs from JAX: `max_steps` ends the run after that many steps, as
in JAX, but saves the epoch it stops in first, so a short run leaves a
generator to load. An epoch cut short is not counted as done: its
checkpoint holds the counter at the epoch's start, so a resume runs that
epoch again, in its own phase.

Data parallelism as in loop_diffusion (`plan_mesh`): each rank decodes its
rows of each global batch, the crops and flips are drawn for the global
batch (parallel.sharding.global_draws), G and D are replicated from
rank 0. `training.fsdp` shards nothing here, as the JAX SRGAN loop, which
replicates G and D whatever the flag; the loop says so once.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.nn.functional as F

from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, create_run, restore_auto
from weatherconverter_tpu_torch.core.config import SRGANTrainConfig
from weatherconverter_tpu_torch.core.logging import MetricsLogger
from weatherconverter_tpu_torch.core.rng import run_key, split_named
from weatherconverter_tpu_torch.data.transforms import random_crop, random_hflip, to_float
from weatherconverter_tpu_torch.models.srgan import Discriminator, Generator
from weatherconverter_tpu_torch.parallel import sharding
from weatherconverter_tpu_torch.parallel.fsdp import maybe_shard_state
from weatherconverter_tpu_torch.training.loop_diffusion import _device, plan_mesh
from weatherconverter_tpu_torch.training.srgan import (
    SRGANState,
    SRGANStates,
    create_srgan_states,
    make_gan_step,
    make_pretrain_step,
)


def build_dataset(cfg: SRGANTrainConfig):
    """The HR image pool: the merged weather-image tree the diffusion model
    trains on (ACDC, plus the BDD and DAWN trees when present), at
    `resize_to=hr_crop`."""
    from weatherconverter_tpu_torch.data.datasets import DiffusionImageDataset

    ds = DiffusionImageDataset(os.path.join(cfg.data.root_dir, cfg.data.acdc_images),
                               selected_conditions=cfg.data.weather, resize_to=cfg.training.hr_crop)
    for extra in (cfg.data.bdd_dir, cfg.data.dawn_dir):
        path = os.path.join(cfg.data.root_dir, extra)
        if extra and os.path.isdir(path):
            ds.add_images(path)
    return ds


def make_pair_fn(hr_crop: int, upscale: int):
    """pairs(images_u8, generator, *, offsets=None, flip=None) -> (lr, hr):
    a uint8 NHWC HR batch -> a random (hr_crop, hr_crop) crop and a random
    horizontal flip, HR in [0, 1] (the generator's range), LR its average
    pool by `upscale`; all on the batch's device, NHWC f32. Crop and flip
    move uint8 values before the conversion (the same result as JAX's
    order). `offsets`/`flip` replay given draws."""

    def pairs(images_u8, generator=None, *, offsets=None, flip=None):
        hr = random_crop(images_u8, (hr_crop, hr_crop), generator, offsets)
        hr = to_float(random_hflip(hr, 0.5, generator, flip))
        lr = F.avg_pool2d(hr.permute(0, 3, 1, 2), upscale).permute(0, 2, 3, 1)
        return lr, hr

    return pairs


def train(cfg: SRGANTrainConfig, max_steps: Optional[int] = None, dataset=None) -> tuple[SRGANState, SRGANState]:
    """Full training run; returns the final (G, D) states. `max_steps` stops
    early (smoke runs; counts steps across both phases); `dataset` replaces
    the image folders: anything indexable that yields uint8 (H, W, C)
    arrays of at least hr_crop on each side."""
    tr = cfg.training
    device = _device(tr.device)
    dtype = torch.bfloat16 if tr.dtype == "bfloat16" and device.type == "cuda" else None
    keys = split_named(run_key(tr.random_seed), "init", "train", device=device)

    ds = dataset if dataset is not None else build_dataset(cfg)
    if len(ds) < tr.batch_size:
        raise FileNotFoundError(
            f"SRGAN dataset holds {len(ds)} images, fewer than one batch of {tr.batch_size}: images under "
            f"{os.path.join(cfg.data.root_dir, cfg.data.acdc_images)!r} for conditions {list(cfg.data.weather)!r}")
    mesh, global_batch = plan_mesh(tr.model_copy(update=dict(fsdp=False)), len(ds), device)
    s = cfg.srgan
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(keys["init"].initial_seed())
        gen = Generator(s.in_channels, s.num_channels, s.num_blocks, s.upscale_factor)
        disc = Discriminator(s.in_channels)
    gs, dstate = create_srgan_states(gen.to(device), disc.to(device), tr.g_lr, tr.d_lr)
    states = SRGANStates(gs, dstate)

    run_dir = create_run(cfg.folders.output)
    logger = MetricsLogger(run_dir, config=cfg.model_dump())
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    if tr.resume_training and tr.resume_checkpoint:
        restore_auto(tr.resume_checkpoint, states, prefer_best=False)
        logger.print(f"resumed from {tr.resume_checkpoint} at epoch {gs.epoch}, step {gs.step}")
    maybe_shard_state(mesh, states)
    if tr.fsdp:
        logger.print("training.fsdp: the SRGAN loop replicates G and D, as the JAX loop does")
    if global_batch != tr.batch_size:
        logger.print(f"DP x{sharding.mesh_width(mesh)}: global batch {global_batch} ({tr.batch_size}/rank)")
    if dataset is None:
        from weatherconverter_tpu_torch.data import native

        logger.print(native.describe())

    pairs = make_pair_fn(tr.hr_crop, s.upscale_factor)

    def pair_fn(batch, generator):
        return pairs(batch, sharding.global_draws(mesh, 1, generator))

    pre_step = make_pretrain_step(tr.pixel_loss, mesh=mesh, dtype=dtype)
    gan_step = make_gan_step(tr.adv_weight, mesh=mesh, pixel_loss=tr.pixel_loss, dtype=dtype)
    loader = sharding.loader(ds, global_batch, mesh, shuffle=True, seed=tr.random_seed, drop_last=True,
                             num_workers=tr.num_workers, pin_memory=device.type == "cuda")

    global_step = gs.step
    for epoch in range(gs.epoch, tr.epochs):
        phase = "pretrain" if epoch < tr.pretrain_epochs else "gan"
        # the epoch's losses add up on the device; one read per epoch
        ep_g, ep_d, nb, t0, stop = torch.zeros((), device=device), None, 0, time.time(), False
        for batch in loader:
            lr_img, hr_img = pair_fn(batch.to(device, non_blocking=True), keys["train"])
            if phase == "pretrain":
                _, g_loss = pre_step(gs, lr_img, hr_img)
                d_loss = None
            else:
                _, _, g_loss, d_loss = gan_step(gs, dstate, lr_img, hr_img)
                ep_d = d_loss if ep_d is None else ep_d + d_loss
            ep_g += g_loss
            global_step += 1
            nb += 1
            if global_step % tr.log_interval == 0:
                rec = {"train/g_loss": g_loss, "epoch": epoch, "phase": phase}
                if d_loss is not None:
                    rec["train/d_loss"] = d_loss
                logger.log(rec, step=global_step)
            if max_steps is not None and global_step >= max_steps:
                stop = True
                break
        dt = time.time() - t0
        logger.log({"epoch": epoch, "phase": phase, "epoch/g_loss": ep_g.item() / nb if nb else 0.0,
                    "epoch/d_loss": ep_d.item() / nb if ep_d is not None and nb else 0.0,
                    "epoch/img_per_sec": nb * global_batch / max(dt, 1e-9)}, step=global_step)
        if nb == len(loader):
            gs.epoch = dstate.epoch = epoch + 1
        if stop or (epoch + 1) % tr.save_interval == 0:
            ckpt.save(epoch + 1, states)
        if stop:
            break
    ckpt.wait()
    logger.finish()
    return gs, dstate
