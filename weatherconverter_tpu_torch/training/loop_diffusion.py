"""DDPM training loop (port of weatherconverter_tpu/training/loop_diffusion.py).

Epochs over the merged ACDC (+ BDD, DAWN) image set, eps-MSE steps, interval
logging, epoch-cadence checkpoints, resume with the step count carried over,
and a checkpoint flush on SIGTERM. The loader ships uint8 (B, H, W, C)
batches; the random crop, flip and [-1, 1] scaling run on the device inside
the train step. Each process runs on one device: the CUDA card
(`training.device="auto"`, the default, which raises when there is none)
or the device the config names; the CPU only on request
(`training.device="cpu"`).

Data parallelism as the JAX loop plans it (parallel.sharding.
plan_data_parallel): under torchrun every process is a data rank, the
global batch is `batch_size` a rank (`scale_batch_to_mesh`, the default;
batch_size as the global batch where the dataset is smaller than that),
`scale_lr_with_batch` scales lr with it, and each rank decodes only its
rows of each global batch, from JAX's index order (parallel.sharding.loader,
data/loader.py; `training.num_workers` 0 means JAX's 8 decode threads).
`training.fsdp` shards the state after any restore (parallel.fsdp); it
needs a process group. The primary alone writes the run directory, the
log and the checkpoints; every rank restores.

Precision. On CUDA the step runs under bf16 autocast when `training.dtype`
is "bfloat16" (the flash-length attention layers through K1 and K3), and in
f32 otherwise, as the JAX loop builds its UNet in f32 unless that dtype is
bfloat16: the flash-length layers then take K1-f32 and K3-f32 (3xTF32 on the
tensor cores, about 21 bits of each product), and a UNet with a flash-length
head dim those kernels lack is refused by name before anything runs. An f32
run keeps f32 arithmetic in the rest of the step too: it turns TF32 off for
cuDNN's convolutions (`torch.backends.cudnn.allow_tf32`, which PyTorch
leaves on, so f32 convolutions would otherwise keep 10 bits of mantissa)
and keeps f32 matmuls at "highest" precision (PyTorch's default), for the
run's length. A user who asks for f32 asks for the f32 result, which the
CPU tests hold against JAX's; bf16 is the fast choice. On the CPU the step
runs in f32, as the JAX loop does off the TPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from functools import partial
from typing import Optional

import torch

from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, create_run, restore_auto
from weatherconverter_tpu_torch.core.config import DiffusionConfig
from weatherconverter_tpu_torch.core.logging import MetricsLogger
from weatherconverter_tpu_torch.core.preempt import PreemptionGuard, preempt_save_index
from weatherconverter_tpu_torch.core.rng import run_key, split_named
from weatherconverter_tpu_torch.data.transforms import diffusion_train_augment
from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
from weatherconverter_tpu_torch.models.unet import Unet, unet_attention_shapes
from weatherconverter_tpu_torch.ops.attention import check_flash_precision
from weatherconverter_tpu_torch.parallel import distributed as pdist
from weatherconverter_tpu_torch.parallel import sharding
from weatherconverter_tpu_torch.parallel.fsdp import maybe_shard_state, sharded_fraction
from weatherconverter_tpu_torch.training.diffusion import DDPMTrainState, create_ddpm_state, make_train_step


def build_dataset(cfg: DiffusionConfig):
    """ACDC plus the BDD/DAWN trees where present, as uint8 HWC images at
    (im_size, im_size * 16/9). The dataset module (numpy and PIL) is imported
    here only, so that `train(cfg, dataset=...)` never imports PIL."""
    from weatherconverter_tpu_torch.data.datasets import DiffusionImageDataset

    ds = DiffusionImageDataset(
        os.path.join(cfg.data.root_dir, cfg.data.acdc_images),
        selected_conditions=cfg.data.weather,
        resize_to=cfg.model.im_size,
    )
    for extra in (cfg.data.bdd_dir, cfg.data.dawn_dir):
        path = os.path.join(cfg.data.root_dir, extra)
        if extra and os.path.isdir(path):
            ds.add_images(path)
    return ds


def make_augmented_train_step(sched, crop: int, mesh=None, fsdp: bool = False, accum_steps: int = 1,
                              dtype: Optional[torch.dtype] = None):
    """The train step on RAW uint8 batches: crop/flip/scale, q-sample,
    eps-MSE, Adam and EMA in one step body, through make_train_step's
    augment_fn hook."""
    return make_train_step(sched, mesh=mesh, fsdp=fsdp, accum_steps=accum_steps, dtype=dtype,
                           augment_fn=partial(diffusion_train_augment, crop=crop))


def _device(name: str) -> torch.device:
    """`training.device` as a torch.device. "auto" is the CUDA card and raises
    without one: training runs on the card unless the config asks for "cpu"."""
    if name == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError('training.device="auto" needs a CUDA card and found none; '
                               'set training.device="cpu" to train on the CPU')
        return torch.device("cuda")
    return torch.device(name)


@contextlib.contextmanager
def f32_arithmetic(device: torch.device, dtype: Optional[torch.dtype]):
    """Inside the block, an f32 step on CUDA (`dtype` None) computes in f32:
    cuDNN's convolutions without TF32 and matmuls at "highest" precision;
    the settings are restored after it. Nothing changes for autocast
    (`dtype` set) or the CPU."""
    if device.type != "cuda" or dtype is not None:
        yield
        return
    cudnn, prev = torch.backends.cudnn, torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def plan_mesh(tr, n_items: int, device: torch.device):
    """(mesh, global_batch) for a loop: JAX's plan (`plan_data_parallel`,
    and batch_size as the global batch where the dataset holds fewer items
    than the scaled batch) over the processes of the run. At one process
    the mesh is None, as in JAX, and the step runs no collective, except
    under `fsdp`, which shards through the process group even at one rank
    (where JAX's FSDP at one device is a no-op). A plan whose width is not
    the process count, or `fsdp` without a process group, raises: no rank
    is left out."""
    dp, global_batch = sharding.plan_data_parallel(tr.batch_size, scale_to_mesh=tr.scale_batch_to_mesh)
    if global_batch > n_items:
        dp, global_batch = sharding.plan_data_parallel(tr.batch_size, scale_to_mesh=False)
    world = pdist.process_count()
    if dp != world:
        raise ValueError(f"global batch {global_batch} does not split over {world} processes (a plan of {dp}); "
                         "set training.batch_size to a multiple of the process count")
    if tr.fsdp and not torch.distributed.is_initialized():
        raise ValueError("training.fsdp=true needs a process group: run under torchrun "
                         "(torchrun --nproc-per-node N -m weatherconverter_tpu_torch.cli.main ...)")
    if world == 1 and not tr.fsdp:
        return None, global_batch
    return sharding.make_mesh(device_type=device.type), global_batch


def train(cfg: DiffusionConfig, max_steps: Optional[int] = None, dataset=None) -> DDPMTrainState:
    """Full training run; returns the final state. `max_steps` stops early
    (smoke runs); `dataset` replaces the image folders: anything indexable
    that yields uint8 (H, W, C) arrays."""
    tr = cfg.training
    device = _device(tr.device)
    dtype = torch.bfloat16 if tr.dtype == "bfloat16" else None
    # parameters are f32 (param_dtype); without autocast the attention layers compute in f32
    check_flash_precision(device.type, torch.float32 if dtype is None else dtype,
                          unet_attention_shapes(cfg.model, cfg.model.im_size), f"train (training.dtype={tr.dtype!r})")
    keys = split_named(run_key(tr.random_seed), "init", "train", device=device)

    ds = dataset if dataset is not None else build_dataset(cfg)
    if len(ds) == 0:
        raise FileNotFoundError(
            "diffusion dataset is empty: no images under "
            f"{os.path.join(cfg.data.root_dir, cfg.data.acdc_images)!r} for conditions "
            f"{list(cfg.data.weather)!r} (expected <root>/rgb_anon/<condition>/<split>/**.png)"
        )
    mesh, global_batch = plan_mesh(tr, len(ds), device)
    lr = tr.lr * (global_batch / tr.batch_size) if tr.scale_lr_with_batch else tr.lr
    sched = make_schedule(cfg.diffusion.schedule, cfg.diffusion.num_timesteps, cfg.diffusion.beta_start,
                          cfg.diffusion.beta_end, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(keys["init"].initial_seed())
        model = Unet(cfg.model)
    state = create_ddpm_state(model.to(device), lr=lr, ema_decay=tr.ema_decay)

    run_dir = create_run(cfg.folders.output)
    logger = MetricsLogger(run_dir, config=cfg.model_dump())
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    if tr.resume_training and tr.resume_checkpoint:
        state = ckpt_restore_into(tr.resume_checkpoint, state)
        logger.print(f"resumed from {tr.resume_checkpoint} at epoch {state.epoch}, step {state.step}")
    state = maybe_shard_state(mesh, state, fsdp=tr.fsdp)
    if tr.fsdp:
        logger.print(f"FSDP: {sharded_fraction(state):.1%} of state bytes sharded across "
                     f"{sharding.mesh_width(mesh)} ranks")
    if global_batch != tr.batch_size:
        logger.print(f"DP x{sharding.mesh_width(mesh)}: global batch {global_batch} ({tr.batch_size}/rank), lr={lr}")
    if dataset is None:
        from weatherconverter_tpu_torch.data import native

        logger.print(native.describe())

    loader = sharding.loader(ds, global_batch, mesh, shuffle=True, seed=tr.random_seed, drop_last=True,
                             accum_steps=tr.accum_steps, num_workers=tr.num_workers,
                             pin_memory=device.type == "cuda")
    step_fn = make_augmented_train_step(sched, cfg.model.im_size, mesh=mesh, fsdp=tr.fsdp,
                                        accum_steps=tr.accum_steps, dtype=dtype)
    flag_group = sharding.host_group(mesh)

    global_step = state.step
    with PreemptionGuard() as guard, f32_arithmetic(device, dtype):
        for epoch in range(state.epoch, tr.epochs):
            # the epoch's loss adds up on the device; one read per epoch
            epoch_loss, nb, t0 = torch.zeros((), device=device), 0, time.time()
            for batch in loader:
                state, loss = step_fn(state, batch.to(device, non_blocking=True), keys["train"])
                epoch_loss += loss
                global_step += 1
                nb += 1
                if global_step % tr.log_interval == 0:
                    logger.log({"train/loss": loss, "epoch": epoch}, step=global_step)
                if guard.triggered_anywhere(flag_group):
                    # SIGTERM mid-epoch: flush the post-step state; state.epoch
                    # is still `epoch`, so a resume restarts this epoch
                    ckpt.save(preempt_save_index(ckpt, global_step), state)
                    ckpt.wait()
                    logger.print(f"preempted (signal {guard.received}): checkpoint flushed at step "
                                 f"{global_step} (epoch {epoch}), exiting")
                    logger.finish()
                    return state
                if max_steps is not None and global_step >= max_steps:
                    logger.finish()
                    return state
            dt = time.time() - t0
            logger.log({"epoch": epoch, "epoch/loss": epoch_loss.item() / nb if nb else 0.0, "epoch/sec": dt,
                        "epoch/img_per_sec": nb * global_batch / max(dt, 1e-9)}, step=global_step)
            state.epoch = epoch + 1
            if (epoch + 1) % tr.save_interval == 0:
                ckpt.save(epoch + 1, state)
    ckpt.wait()
    logger.finish()
    return state


def ckpt_restore_into(path: str, state):
    """Restore a checkpoint file, a CheckpointManager directory (its latest
    step, not its best: a resume continues the run) or one step directory
    into `state`, in place."""
    return restore_auto(path, state, prefer_best=False)
