"""Data parallelism and FSDP in the port (weatherconverter_tpu_torch/parallel,
the train steps under `mesh=`, the loops and the CLI under two processes),
against the JAX package's steps on a 2-device mesh, on the CPU.

One process group per module: the fixture `dp` writes the inputs (numpy from
seeds, JAX parameters carried across by compat/from_jax), starts this file
as `__main__` twice, rank 0 and rank 1 of a gloo group (they import no JAX),
and while they run every case computes JAX's references on
`make_mesh(devices=jax.devices()[:2])`. The ranks write what each case gave
to one results file; the tests below read it. Where JAX draws from a key,
its draws are replayed in the port through `t=`/`noise=` as the GLOBAL
batch's, of which each rank takes its rows.

Tolerances, stated where used: the DDPM steps in f32 as
tests/test_torch_training.py holds the single-process step (loss rtol 1e-5;
a first Adam update to lr/100 where |g| is large and to lr everywhere), the
seg and SRGAN steps in f64 as tests/test_torch_seg_training.py and
tests/test_torch_srgan_training.py hold theirs (losses 1e-6, updates 2e-4 of
a tensor's largest, statistics 1e-6). The planted faults (a per-rank
BatchNorm, a per-rank valid-pixel count, contiguous microbatch rows, draws
per rank) must break those bounds.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
T_STEPS = 50
LR = 1e-3
# a two-level UNet at 16 px, attention at 8 x 8 (plain softmax): the smallest ladder, so that JAX compiles its
# steps quickly
MH_UNET = dict(im_size=16, down_channels=[8, 16], mid_channels=[16, 16, 8], down_sample=[True],
               time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
               attn_resolutions=[8])
SEG_NAME, CLASSES, SEG_HW = "deeplabv3plus_resnet18", 5, 32
G_KW = dict(num_channels=8, num_blocks=1, upscale_factor=2)
D_FEATURES = (8, 8, 16, 16)
SEG_FAULTS = ("per_rank_batchnorm", "per_rank_valid_count", "contiguous_microbatch_rows")
WORKER_TIMEOUT_S = 300


class OptCfg:
    """The seg optimizer: rates large enough that every update stands well above the bounds."""

    params = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}
    layerwise_lr = {"backbone": 0.01, "classifier": 0.05}


def _ddpm_images():
    return np.random.default_rng(5).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)


def _seg_batch():
    """4 f64 images and labels whose ignored band differs by row: the ranks' valid counts differ."""
    rng = np.random.default_rng(6)
    y = rng.integers(0, CLASSES, (4, SEG_HW, SEG_HW)).astype(np.int64)
    for i in range(4):
        y[i, :3 * (i + 1)] = 255
    return rng.standard_normal((4, SEG_HW, SEG_HW, 3)), y


def _srgan_batch():
    rng = np.random.default_rng(7)
    hr = rng.uniform(0, 1, (4, 12, 14, 3))
    return hr.reshape(4, 6, 2, 7, 2, 3).mean(axis=(2, 4)), hr


def _val_set():
    """5 (f32 image, label) pairs: a global batch of 4, then a ragged one of 1."""
    rng = np.random.default_rng(8)
    return [(rng.standard_normal((SEG_HW, SEG_HW, 3)).astype(np.float32),
             rng.integers(0, CLASSES, (SEG_HW, SEG_HW)).astype(np.uint8)) for _ in range(5)]


def _translate_inputs():
    rng = np.random.default_rng(9)
    return ((rng.standard_normal((2, 16, 16, 3)) * 0.2).astype(np.float32),
            rng.integers(0, CLASSES, (2, 32, 32)).astype(np.int64),
            rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
            rng.standard_normal((3, 2, 16, 16, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# the ranks (this file as __main__): torch and the port only
# ---------------------------------------------------------------------------


def _np(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().cpu().numpy().copy()


def _moments(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: _np(s["exp_avg"]) for p, s in state.optimizer.state.items()}


def _same_on_ranks(tensors) -> bool:
    """Whether every tensor equals rank 0's, on every rank."""
    import torch.distributed as dist

    same = torch.tensor([1])
    for t in tensors:
        t = torch.as_tensor(_np(t))
        ref = t.clone()
        dist.broadcast(ref, 0)
        same &= torch.tensor([int(torch.equal(ref, t))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def _unet(sd):
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.unet import Unet

    model = Unet(UnetModelConfig(**MH_UNET))
    model.load_state_dict(sd, strict=True)
    return model


def _ddpm_case(mesh, inp, accum=1, fsdp=False, ckpt=None):
    from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.parallel.fsdp import shard_state_fsdp, sharded_fraction
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import diffusion as PD

    model = _unet(inp["unet"])
    # under FSDP Adam's foreach kernels, which the CPU takes only when asked
    opt = torch.optim.Adam(model.parameters(), lr=LR, foreach=True) if fsdp else None
    state = PD.create_ddpm_state(model, lr=LR, optimizer=opt, ema_decay=0.5)
    out = {}
    if fsdp:
        from torch.distributed.tensor import DTensor

        shard_state_fsdp(mesh, state)
        out["fraction"] = sharded_fraction(state)
        out["groups"] = [(g["origin"], g["foreach"], sorted({isinstance(p, DTensor) for p in g["params"]}))
                         for g in state.optimizer.param_groups]
    step = PD.make_train_step(linear_schedule(T_STEPS), mesh=mesh, accum_steps=accum, fsdp=fsdp)
    images = shard_batch(mesh, torch.from_numpy(inp["ddpm_x"]), accum)
    t, noise = inp["ddpm_draws"][accum]
    state, loss = step(state, images, t=t, noise=noise)
    params = {k: _np(v) for k, v in state.model.state_dict().items()}
    out.update(loss=loss.item(), params=params, moments=_moments(state),
               ema={k: _np(v) for k, v in state.ema.params.items()},
               same=_same_on_ranks(list(state.model.state_dict().values())))
    if ckpt:
        CheckpointManager(ckpt).save(1, state)
    return out


def _preempt_case(mesh):
    """A signal's flag set on rank 1 alone: before it neither rank reads it,
    after it both do, over the host group."""
    import torch.distributed as dist

    from weatherconverter_tpu_torch.core.preempt import PreemptionGuard
    from weatherconverter_tpu_torch.parallel.sharding import host_group

    group = host_group(mesh)
    guard = PreemptionGuard()
    quiet = guard.triggered_anywhere(group)
    if dist.get_rank() == 1:
        guard._event.set()
    agreed = [None] * WORLD
    dist.all_gather_object(agreed, (guard.triggered, guard.triggered_anywhere(group)))
    return dict(quiet=quiet, agreed=agreed, backend=dist.get_backend(group))


def _eval_case(mesh, inp):
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import diffusion as PD

    t, noise = inp["ddpm_draws"][1]
    fn = PD.make_eval_loss(linear_schedule(T_STEPS), _unet(inp["unet"]), mesh=mesh)
    return fn(shard_batch(mesh, torch.from_numpy(inp["ddpm_x"])), t=t, noise=noise).item()


def _generator_case(mesh, inp, fault=None):
    """The augmented step drawing from a generator (crop, flip, t, noise): the
    global batch's draws. Fault: each rank draws for its own rows only."""
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import diffusion as PD
    from weatherconverter_tpu_torch.training.loop_diffusion import make_augmented_train_step

    state = PD.create_ddpm_state(_unet(inp["unet"]), lr=LR)
    step = make_augmented_train_step(linear_schedule(T_STEPS), 16, mesh=mesh)
    ctx = contextlib.nullcontext()
    if fault == "draws_per_rank":
        real = PD.ddpm_loss_fn
        ctx = _patched(PD, "ddpm_loss_fn", lambda *a, rows=None, batch_of=None, **kw: real(*a, **kw))
    with ctx:
        state, loss = step(state, shard_batch(mesh, torch.from_numpy(inp["u8"])), torch.Generator().manual_seed(11))
    return dict(loss=loss.item(), params={k: _np(v) for k, v in state.model.state_dict().items()})


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _seg_case(mesh, inp, fault=None):
    from weatherconverter_tpu_torch.models import factory as PF
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import losses as PL
    from weatherconverter_tpu_torch.training import segmentation as PS

    model = PF.make_seg_model(SEG_NAME, CLASSES, train=True, bn_momentum=0.01).double()
    model.load_state_dict(inp["seg64"], strict=True)
    state = PS.create_seg_state(model, OptCfg, 4)
    loss_fn = PL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255})
    if fault == "per_rank_valid_count":
        loss_fn = (lambda f: lambda logits, labels, group=None: f(logits, labels))(loss_fn)
    x, y = (torch.from_numpy(a) for a in inp["seg_batch"])
    x, y = shard_batch(mesh, (x, y), 1 if fault == "contiguous_microbatch_rows" else 2)
    ctx = (_patched(PS, "synced_batchnorm", lambda m, g: contextlib.nullcontext())
           if fault == "per_rank_batchnorm" else contextlib.nullcontext())
    with ctx:
        _, loss, ig = PS.make_seg_train_step(loss_fn, mesh=mesh, accum_steps=2)(state, x, y)
    names = {id(p): n for n, p in model.named_parameters()}
    return dict(loss=loss.item(), ig=ig.item(), sd={k: _np(v) for k, v in model.state_dict().items()},
                buffers={names[id(p)]: _np(s["momentum_buffer"]) for p, s in state.optimizer.state.items()})


def _srgan_case(mesh, inp):
    from weatherconverter_tpu_torch.models.srgan import Discriminator, Generator
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import srgan as PT

    gen, disc = Generator(3, **G_KW).double(), Discriminator(3, D_FEATURES).double()
    gen.load_state_dict(inp["gen64"], strict=True)
    disc.load_state_dict(inp["disc64"], strict=True)
    gs, ds = PT.create_srgan_states(gen, disc, 1e-3, 2e-3)
    lr, hr = shard_batch(mesh, tuple(torch.from_numpy(a) for a in inp["srgan_batch"]))
    _, pre = PT.make_pretrain_step("l1", mesh=mesh)(gs, lr, hr)
    _, _, g_loss, d_loss = PT.make_gan_step(adv_weight=0.1, mesh=mesh)(gs, ds, lr, hr)
    return dict(losses=[pre.item(), g_loss.item(), d_loss.item()],
                gen={k: _np(v) for k, v in gen.state_dict().items()},
                disc={k: _np(v) for k, v in disc.state_dict().items()},
                mu_g=_moments(gs), mu_d=_moments(ds))


def _confusion_case(mesh, inp):
    from weatherconverter_tpu_torch.metrics.stream import init_confusion
    from weatherconverter_tpu_torch.models import factory as PF
    from weatherconverter_tpu_torch.parallel import sharding
    from weatherconverter_tpu_torch.training.loop_segmentation import PaddedPairs
    from weatherconverter_tpu_torch.training.segmentation import make_seg_eval_step

    model = PF.make_seg_model(SEG_NAME, CLASSES)
    model.load_state_dict(inp["seg32"], strict=True)
    step = make_seg_eval_step(model, CLASSES, mesh=mesh)
    conf, shapes = init_confusion(CLASSES), []
    for x, y in sharding.loader(PaddedPairs(inp["val"]), 4, mesh, shuffle=False, drop_last=False, pad_ragged=True):
        shapes.append(tuple(x.shape))
        conf = step(conf, x, y)
    return dict(conf=conf.numpy(), shapes=shapes)


def _translate_case(mesh, inp):
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn, translate_across_ranks

    x, gt, n0, z = (torch.from_numpy(a) for a in inp["translate"])
    fn = make_translate_fn(*_translate_models(inp), **_TRANSLATE_KW)
    return translate_across_ranks(fn, mesh, x, gt, (n0, z), start_t=2).numpy()


_TRANSLATE_KW = dict(lam=10.0, num_steps=3, num_classes=CLASSES, mode="fixed", guidance_style="alternate")


def _translate_models(inp):
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models import factory as PF
    from weatherconverter_tpu_torch.models.srgan import Generator

    seg = PF.make_seg_model(SEG_NAME, CLASSES)
    seg.load_state_dict(inp["seg32"], strict=True)
    gen = Generator(3, **G_KW)
    gen.load_state_dict(inp["gen32"], strict=True)
    return _unet(inp["unet"]), linear_schedule(T_STEPS), seg, gen


def _resume_case(mesh, inp, workdir):
    """A DP step, a primary-only save, the next step; then a fresh state
    restored on every rank takes the same next step. Also the single-process
    checkpoint written by the test restored into the ranks."""
    import torch.distributed as dist

    from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, restore_auto
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.parallel.distributed import is_primary
    from weatherconverter_tpu_torch.parallel.sharding import shard_batch
    from weatherconverter_tpu_torch.training import diffusion as PD

    ckdir = os.path.join(workdir, "ck_resume")
    step = PD.make_train_step(linear_schedule(T_STEPS), mesh=mesh)
    images = shard_batch(mesh, torch.from_numpy(inp["ddpm_x"]))
    state = PD.create_ddpm_state(_unet(inp["unet"]), lr=LR)
    step(state, images, torch.Generator().manual_seed(1))
    CheckpointManager(ckdir).save(1, state)
    _, cont = step(state, images, torch.Generator().manual_seed(2))
    torch.manual_seed(99 + dist.get_rank())  # every leaf must come from the checkpoint
    fresh = PD.create_ddpm_state(Unet(UnetModelConfig(**MH_UNET)), lr=LR)
    restore_auto(ckdir, fresh, prefer_best=False)
    _, res = step(fresh, images, torch.Generator().manual_seed(2))
    primaries = [None] * WORLD
    dist.all_gather_object(primaries, is_primary())
    single = PD.create_ddpm_state(Unet(UnetModelConfig(**MH_UNET)), lr=LR)
    restore_auto(os.path.join(workdir, "single.pt"), single, prefer_best=False)
    return dict(cont=cont.item(), res=res.item(), primaries=primaries, files=sorted(os.listdir(ckdir)),
                single={k: _np(v) for k, v in single.model.state_dict().items()},
                single_same=_same_on_ranks(list(single.model.state_dict().values())))


def _loops_case(inp, workdir):
    """`train-ddpm --device cpu` through the CLI, and the seg and SRGAN loops,
    under the two ranks; each returns its state's parameters."""
    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.config import SegConfig, SRGANTrainConfig
    from weatherconverter_tpu_torch.training import loop_segmentation, loop_srgan

    code = cli_main(["train-ddpm", "--config", os.path.join(workdir, "ddpm.yaml"), "--max-steps", "3",
                     "--device", "cpu"])
    seg_cfg = SegConfig(
        model=dict(name=SEG_NAME, num_classes=19, output_stride=16, bn_momentum=0.01),
        data=dict(transform=dict(resize_resolution=[23, 37], target_resolution=[16, 16])),
        training=dict(device="cpu", random_seed=0, epochs=1, batch_size=1, num_workers=0, log_interval=1),
        folders=dict(output=os.path.join(workdir, "seg_runs")))
    seg = loop_segmentation.train(seg_cfg, datasets=(_Pairs(4, 0), _Pairs(3, 1)))
    sr_cfg = SRGANTrainConfig(srgan=dict(num_channels=8, num_blocks=1, upscale_factor=2),
                              training=dict(device="cpu", random_seed=0, epochs=2, pretrain_epochs=1, batch_size=1,
                                            hr_crop=16, num_workers=0, log_interval=1, save_interval=1),
                              folders=dict(output=os.path.join(workdir, "srgan_runs")))
    gs, ds = loop_srgan.train(sr_cfg, dataset=_Images(4))
    return dict(cli_exit=code, seg_step=seg.step, seg_same=_same_on_ranks(list(seg.model.state_dict().values())),
                srgan_steps=(gs.step, ds.step), srgan_same=_same_on_ranks(list(gs.model.state_dict().values())
                                                                          + list(ds.model.state_dict().values())))


class _Pairs:
    """(uint8 (H, W, 3), uint8 (H, W)) pairs from a seed (tests/test_torch_seg_training.py's)."""

    def __init__(self, n, seed, hw=(23, 37)):
        self.n, self.seed, self.hw = n, seed, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        h, w = self.hw
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        return img, np.repeat(((np.arange(w) * 19 // w + i) % 19).astype(np.uint8)[None], h, 0)


class _Images:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.default_rng(i).integers(0, 256, (20, 24, 3), dtype=np.uint8)


def _worker(workdir: str) -> None:
    import torch.distributed as dist

    from weatherconverter_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from weatherconverter_tpu_torch.parallel.distributed import is_primary

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu") and dist.get_backend() == "gloo"
    mesh = make_mesh()
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out, times = {}, {}
    cases = [("ddpm", lambda: _ddpm_case(mesh, inp)),
             ("ddpm_accum2", lambda: _ddpm_case(mesh, inp, accum=2)),
             ("ddpm_fsdp", lambda: _ddpm_case(mesh, inp, fsdp=True, ckpt=os.path.join(workdir, "ck_fsdp"))),
             ("eval", lambda: _eval_case(mesh, inp)),
             ("preempt", lambda: _preempt_case(mesh)),
             ("generator", lambda: _generator_case(mesh, inp)),
             ("generator_draws_per_rank", lambda: _generator_case(mesh, inp, "draws_per_rank")),
             ("seg", lambda: _seg_case(mesh, inp))]
    cases += [(f"seg_{f}", (lambda f: lambda: _seg_case(mesh, inp, f))(f)) for f in SEG_FAULTS]
    cases += [("srgan", lambda: _srgan_case(mesh, inp)), ("confusion", lambda: _confusion_case(mesh, inp)),
              ("translate", lambda: _translate_case(mesh, inp)), ("resume", lambda: _resume_case(mesh, inp, workdir)),
              ("loops", lambda: _loops_case(inp, workdir))]
    for name, case in cases:
        t0 = time.perf_counter()
        out[name] = case()
        times[name] = round(time.perf_counter() - t0, 2)
    out["times"] = times
    out["jax_imported"] = [m for m in sys.modules if m in ("jax", "weatherconverter_tpu")
                           or m.startswith(("jax.", "weatherconverter_tpu."))]
    if is_primary():
        torch.save(out, os.path.join(workdir, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the test process: inputs, the ranks, JAX's references
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_inputs():
    """Parameters (numpy from seeds over JAX's shapes) and the port's state
    dicts made from them."""
    import jax
    import jax.numpy as jnp
    from torch_parity import seeded_leaves

    from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
    from weatherconverter_tpu.models import srgan as JM
    from weatherconverter_tpu.models.factory import make_seg_model as j_make_seg_model
    from weatherconverter_tpu.models.unet import Unet as JUnet
    from weatherconverter_tpu_torch.compat import from_jax
    from weatherconverter_tpu_torch.core.config import UnetModelConfig

    def leaves(module, args, seed, dtype=np.float32):
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
        return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), seeded_leaves(shapes, seed))

    junet = JUnet(config=JUnetConfig(**MH_UNET), fused=False)
    uparams = leaves(junet, (jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)), 1)["params"]
    jseg = j_make_seg_model(SEG_NAME, num_classes=CLASSES)
    seg_vars = leaves(jseg, (jnp.zeros((1, SEG_HW, SEG_HW, 3)),), 2)
    jgen = JM.Generator(**G_KW)
    gvars = leaves(jgen, (jnp.zeros((1, 6, 7, 3)),), 3)
    jdisc = JM.Discriminator(features=D_FEATURES)
    dvars = leaves(jdisc, (jnp.zeros((1, 12, 14, 3)),), 4)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    ports = dict(
        unet=from_jax.unet_state_dict(uparams, UnetModelConfig(**MH_UNET)),
        seg32=from_jax.deeplab_state_dict(seg_vars, SEG_NAME),
        seg64=from_jax.deeplab_state_dict(f64(seg_vars), SEG_NAME),
        gen32=from_jax.srgan_generator_state_dict(gvars, G_KW["num_blocks"]),
        gen64=from_jax.srgan_generator_state_dict(f64(gvars), G_KW["num_blocks"]),
        disc64=from_jax.srgan_discriminator_state_dict(f64(dvars)))
    return dict(junet=junet, uparams=uparams, jseg=jseg, seg_vars=seg_vars, gvars=gvars, dvars=dvars), ports


def _jax_draws(key, shape):
    """(t, noise) of JAX's ddpm_loss_fn from `key` (training/diffusion.py:74-77)."""
    import jax
    import jax.numpy as jnp

    tkey, nkey = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.randint(tkey, (shape[0],), 0, T_STEPS))).long(),
            torch.tensor(np.asarray(jax.random.normal(nkey, shape, dtype=jnp.float32))))


DDPM_KEY = 21


def _ddpm_draws():
    """The global batch's draws of JAX's step: one key (accum 1), or one a
    microbatch of 2 (accum 2), concatenated."""
    import jax

    key = jax.random.PRNGKey(DDPM_KEY)
    one = _jax_draws(key, (4, 16, 16, 3))
    two = [_jax_draws(k, (2, 16, 16, 3)) for k in jax.random.split(key, 2)]
    return {1: one, 2: (torch.cat([d[0] for d in two]), torch.cat([d[1] for d in two]))}


def _write_ddpm_tree(root, n=8):
    from PIL import Image

    folder = os.path.join(root, "ACDC", "rgb_anon", "fog", "train")
    os.makedirs(folder)
    rng = np.random.default_rng(12)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(os.path.join(folder, f"{i}.png"))


def _jax_references(j):
    """Every case's JAX counterpart on a 2-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from weatherconverter_tpu.diffusion import schedule as JS
    from weatherconverter_tpu.models import factory as JF
    from weatherconverter_tpu.models import srgan as JM
    from weatherconverter_tpu.parallel import fsdp as JFS
    from weatherconverter_tpu.parallel.sharding import make_mesh, replicate, shard_batch
    from weatherconverter_tpu.training import diffusion as JD
    from weatherconverter_tpu.training import losses as JL
    from weatherconverter_tpu.training import optim as JO
    from weatherconverter_tpu.training import segmentation as JSeg
    from weatherconverter_tpu.training import srgan as JT

    mesh = make_mesh(devices=jax.devices()[:WORLD])
    ref = {}
    sched = JS.linear_schedule(T_STEPS)
    images = jnp.asarray(_ddpm_images())
    key = jax.random.PRNGKey(DDPM_KEY)
    for name, accum in (("ddpm", 1), ("ddpm_accum2", 2)):
        state = JD.DDPMTrainState.create(apply_fn=j["junet"].apply, params=j["uparams"], tx=JO.adam(LR),
                                         ema=JD.EMA.create(j["uparams"], decay=0.5))
        if accum == 1:
            ref["fraction"] = JFS.sharded_fraction(JFS.shard_state_fsdp(mesh, state))
        step = JD.make_train_step(sched, mesh=mesh, donate=False, accum_steps=accum)
        state, loss = step(replicate(mesh, state), shard_batch(mesh, images), replicate(mesh, key))
        ref[name] = dict(loss=float(loss), params=jax.device_get(state.params), mu=jax.device_get(state.opt_state[0].mu),
                         ema=jax.device_get(state.ema.params))
    # the port's FSDP step is held to JAX's replicated step, as JAX's tests hold its FSDP step
    # (tests/test_fsdp.py::test_fsdp_train_step_matches_replicated_dp)
    ref["ddpm_fsdp"] = ref["ddpm"]
    ref["eval"] = float(JD.make_eval_loss(sched, j["junet"].apply, mesh=mesh)(
        replicate(mesh, j["uparams"]), shard_batch(mesh, images), replicate(mesh, key)))

    x, y = _seg_batch()
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
        variables = f64(j["seg_vars"])
        model = JF.make_seg_model(SEG_NAME, CLASSES, train=True, bn_momentum=0.01, dtype=jnp.float64)
        tx = JO.make_seg_optimizer(variables["params"], OptCfg, max_iters=4)
        state = replicate(mesh, JSeg.SegTrainState.create(apply_fn=model.apply, params=variables["params"],
                                                          batch_stats=variables["batch_stats"], tx=tx))
        step = JSeg.make_seg_train_step(JL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255}), mesh=mesh,
                                        input_grad=True, donate=False, accum_steps=2)
        state, loss, ig = step(state, *shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y.astype(np.int32)))))
        state = jax.device_get(state)
        traces = {label: state.opt_state.inner_states[label].inner_state[1][0].trace[label]
                  for label in ("backbone", "head")}
        ref["seg"] = dict(loss=float(loss), ig=float(ig), params=state.params, batch_stats=state.batch_stats,
                          traces=traces)

        lr, hr = (jnp.asarray(a) for a in _srgan_batch())
        jgen = JM.Generator(**G_KW, train=True, dtype=jnp.float64)
        jdisc = JM.Discriminator(features=D_FEATURES, train=True, dtype=jnp.float64)
        gv, dv = f64(j["gvars"]), f64(j["dvars"])
        gs = replicate(mesh, JT.SRGANState.create(apply_fn=jgen.apply, params=gv["params"],
                                                  batch_stats=gv["batch_stats"], tx=optax.adam(1e-3)))
        ds = replicate(mesh, JT.SRGANState.create(apply_fn=jdisc.apply, params=dv["params"],
                                                  batch_stats=dv["batch_stats"], tx=optax.adam(2e-3)))
        lr, hr = shard_batch(mesh, (lr, hr))
        gs, pre = JT.make_pretrain_step("l1", mesh=mesh)(gs, lr, hr)
        gs, ds, g_loss, d_loss = JT.make_gan_step(adv_weight=0.1, mesh=mesh)(gs, ds, lr, hr)
        gs, ds = jax.device_get(gs), jax.device_get(ds)
        ref["srgan"] = dict(losses=[float(pre), float(g_loss), float(d_loss)],
                            gen={"params": gs.params, "batch_stats": gs.batch_stats},
                            disc={"params": ds.params, "batch_stats": ds.batch_stats},
                            mu_g={"params": gs.opt_state[0].mu, "batch_stats": gs.batch_stats},
                            mu_d={"params": ds.opt_state[0].mu, "batch_stats": ds.batch_stats})

    # the confusion matrix as JAX's validate builds it: batches of 4, the ragged one padded to the mesh
    # width with ignored rows (training/loop_segmentation.py:110-135)
    from weatherconverter_tpu.metrics.stream import init_confusion

    eval_model = JF.make_seg_model(SEG_NAME, CLASSES)
    eval_step = JSeg.make_seg_eval_step(eval_model, CLASSES, mesh=mesh)
    conf = replicate(mesh, init_confusion(CLASSES))
    val = _val_set()
    for start in (0, 4):
        xs = np.stack([a for a, _ in val[start:start + 4]])
        ys = np.stack([b for _, b in val[start:start + 4]]).astype(np.int32)
        rem = (-xs.shape[0]) % WORLD
        if rem:
            xs = np.concatenate([xs, np.repeat(xs[-1:], rem, 0)])
            ys = np.concatenate([ys, np.full((rem,) + ys.shape[1:], 255, ys.dtype)])
        conf = eval_step(j["seg_vars"]["params"], j["seg_vars"]["batch_stats"], conf,
                         *shard_batch(mesh, (jnp.asarray(xs), jnp.asarray(ys))))
    ref["confusion"] = np.asarray(jax.device_get(conf))
    return ref


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(the ranks' results, JAX's references, the inputs, the work directory)."""
    from weatherconverter_tpu_torch.training import diffusion as PD

    workdir = str(tmp_path_factory.mktemp("dp"))
    j, ports = _jax_inputs()
    inp = dict(ports, ddpm_x=_ddpm_images(), ddpm_draws=_ddpm_draws(), seg_batch=_seg_batch(),
               srgan_batch=_srgan_batch(), val=_val_set(), translate=_translate_inputs(),
               u8=np.random.default_rng(13).integers(0, 256, (4, 20, 20, 3), dtype=np.uint8))
    torch.save(inp, os.path.join(workdir, "inputs.pt"))
    single = PD.create_ddpm_state(_unet(ports["unet"]), lr=LR)
    with torch.no_grad():
        for p in single.model.parameters():
            p.add_(0.01)
    torch.save(single.state_dict(), os.path.join(workdir, "single.pt"))
    _write_ddpm_tree(os.path.join(workdir, "acdc"))
    with open(os.path.join(workdir, "ddpm.yaml"), "w") as f:
        json.dump({"model": MH_UNET, "diffusion": {"num_timesteps": T_STEPS},
                   "data": {"root_dir": os.path.join(workdir, "acdc"), "weather": ["fog"]},
                   "training": {"batch_size": 2, "epochs": 2, "save_interval": 1, "log_interval": 1,
                                "num_workers": 0, "dtype": "float32"},
                   "folders": {"output": os.path.join(workdir, "ddpm_runs")}}, f)
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), workdir],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = _jax_references(j)
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, f"ranks exited {codes}:\n" + "\n".join(log[-4000:] for log in logs)
    return torch.load(os.path.join(workdir, "results.pt"), weights_only=False), ref, inp, workdir


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def _close_adam_update(got_params, want_params, start, bound, what):
    """A first Adam update is about lr * sign(g): held to bound/100 where
    |update| >= 0.9 bound (tests/test_torch_training.py), to the bound
    everywhere, and those firm elements are most of those of each tensor that
    moves (over 0.8 on average: 0.88 at this UNet, whose small tensors hold
    many entries whose gradient is within ten eps of 0); a tensor JAX leaves
    in place stays in place."""
    firm_total, moving = 0.0, 0
    for name, ref in want_params.items():
        step_ref = ref.numpy() - start[name].numpy()
        step_got = got_params[name] - start[name].numpy()
        if not np.any(step_ref):
            np.testing.assert_array_equal(step_got, 0, err_msg=f"{what} {name}")
            continue
        firm = np.abs(step_ref) >= 0.9 * bound
        firm_total, moving = firm_total + firm.mean(), moving + 1
        _close(step_got[firm], step_ref[firm], 0, bound / 100, f"{what} {name}")
        _close(step_got, step_ref, 0, bound, f"{what} {name}")
    assert moving and firm_total / moving > 0.8, what


def _unet_sd(tree):
    from weatherconverter_tpu_torch.compat import from_jax
    from weatherconverter_tpu_torch.core.config import UnetModelConfig

    import jax

    return from_jax.unet_state_dict(jax.tree_util.tree_map(np.asarray, tree), UnetModelConfig(**MH_UNET))


# ---------------------------------------------------------------------------
# the pure functions, case by case against JAX's
# ---------------------------------------------------------------------------

FSDP_CASES = [((3, 3, 64, 128), 8, 0), ((3, 3, 3, 3), 8, 0), ((64,), 8, None), ((), 8, 0), ((768, 3, 3, 3), 2, None),
              ((96, 96), 4, 0), ((5, 7), 2, 0), ((4096,), 2, None), ((4095, 2), 2, None)]


@pytest.mark.parametrize("shape, width, min_bytes", FSDP_CASES)
def test_fsdp_spec_matches_jax(shape, width, min_bytes):
    """JAX's test_fsdp_spec_policy shapes (tests/test_fsdp.py) and a few
    more: the same axis sharded, or () where JAX replicates."""
    from weatherconverter_tpu.parallel.fsdp import fsdp_spec as jax_spec
    from weatherconverter_tpu_torch.parallel.fsdp import fsdp_spec

    kw = {} if min_bytes is None else dict(min_shard_bytes=min_bytes)
    assert fsdp_spec(shape, width, **kw) == tuple(jax_spec(shape, width, **kw))


@pytest.mark.parametrize("batch, scale, n", [(4, True, 1), (4, True, 2), (4, False, 2), (6, False, 4), (3, False, 8),
                                             (8, True, 8), (1, True, 4), (5, False, 5)])
def test_plan_data_parallel_and_choose_dp_width_match_jax(batch, scale, n):
    from weatherconverter_tpu.parallel import sharding as JS
    from weatherconverter_tpu_torch.parallel import sharding as PS

    assert PS.plan_data_parallel(batch, scale, n) == JS.plan_data_parallel(batch, scale, n)
    assert PS.choose_dp_width(batch, n) == JS.choose_dp_width(batch, n)


@pytest.mark.parametrize("rows, multiple", [(5, 2), (4, 2), (7, 4), (1, 3)])
def test_pad_to_multiple_matches_jax(rows, multiple):
    """Edge padding of every leaf: numpy leaves against JAX's function, and a
    tensor leaf equal to its numpy twin."""
    from weatherconverter_tpu.parallel import sharding as JS
    from weatherconverter_tpu_torch.parallel import sharding as PS

    tree = {"x": np.arange(rows * 6, dtype=np.float32).reshape(rows, 2, 3), "y": np.arange(rows)}
    want = JS.pad_to_multiple(tree, multiple)
    got = PS.pad_to_multiple(tree, multiple)
    for k in tree:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(PS.pad_to_multiple(torch.from_numpy(tree["x"]), multiple).numpy(),
                                  np.asarray(want["x"]))


class _FakeMesh:
    """What local_rows and local_batch_slice read of a mesh: its width and this rank."""

    def __init__(self, width, rank):
        self.width, self.rank = width, rank

    def size(self):
        return self.width

    def get_local_rank(self):
        return self.rank


@pytest.mark.parametrize("batch, width", [(8, 2), (12, 4), (6, 3)])
def test_local_batch_slice_and_the_rows_layout(batch, width):
    """local_batch_slice equals JAX's; local_rows gives rank r of each
    microbatch its share of the global microbatch, and the ranks together
    every row once."""
    import jax

    from weatherconverter_tpu.parallel import sharding as JS
    from weatherconverter_tpu_torch.parallel import sharding as PS

    jmesh = JS.make_mesh(devices=jax.devices()[:width])
    assert PS.local_batch_slice(batch, _FakeMesh(width, 0)) == JS.local_batch_slice(batch, jmesh)
    for accum in (1, 2):
        if batch % (width * accum):
            continue
        all_rows = [PS.local_rows(batch, _FakeMesh(width, r), accum) for r in range(width)]
        assert sorted(sum(all_rows, [])) == list(range(batch))
        micro, share = batch // accum, batch // accum // width
        for r, rows in enumerate(all_rows):
            for i in range(accum):
                assert rows[i * share:(i + 1) * share] == list(range(i * micro + r * share, i * micro + (r + 1) * share))
    with pytest.raises(ValueError, match="not divisible"):
        PS.local_rows(5, _FakeMesh(2, 0))


def _global_draws_augments():
    """name -> (augment(images_u8, labels, generator, draws), accum_steps, replayed draws or None) for
    the three on-device augmentations of the loops; the seg one with its geometric legs on."""
    from weatherconverter_tpu_torch.data.transforms import SegDraws, diffusion_train_augment, seg_train_augment
    from weatherconverter_tpu_torch.training.loop_srgan import make_pair_fn

    pairs = make_pair_fn(8, 2)
    seg = dict(crop=(12, 12), scale_range=(0.5, 2.0), rotation_degrees=10.0, hue=0.1, num_classes_to_keep=2,
               masking_p=0.5)
    g = torch.Generator().manual_seed(4)
    b = 8
    replay = SegDraws(offsets=(torch.randint(0, 5, (b,), generator=g), torch.randint(0, 5, (b,), generator=g)),
                      flip=torch.rand((b,), generator=g) < 0.5, jitter=tuple(torch.rand((b,), generator=g) + 0.5
                                                                              for _ in range(3)),
                      noise_std=torch.rand((b,), generator=g) * 0.05, noise=torch.randn((b, 12, 12, 3), generator=g),
                      mask_apply=torch.rand((b,), generator=g) < 0.5, gumbel=torch.randn((b, 20), generator=g))
    return {"diffusion": (lambda x, y, gen, d: diffusion_train_augment(x, gen, crop=12), 2, None),
            "seg": (lambda x, y, gen, d: seg_train_augment(x, y, gen, draws=d, **seg), 2, None),
            "seg_replayed": (lambda x, y, gen, d: seg_train_augment(x, y, gen, draws=d, crop=(12, 12)), 2, replay),
            "srgan_pairs": (lambda x, y, gen, d: pairs(x, gen), 1, None)}


@pytest.mark.parametrize("name", ["diffusion", "seg", "seg_replayed", "srgan_pairs"])
def test_global_draws_give_each_rank_its_rows_of_the_global_augmentation(name):
    """Each of two ranks augments only its rows (`shard_batch`, two
    microbatches where the step takes them), drawing through GlobalDraws
    from a generator seeded alike, or taking its rows of the replayed
    draws: exactly its rows of the single-process augmentation of the
    global batch of 8 (labels and uint8-derived images bit-equal: each row's
    arithmetic is the same, only the batch around it differs)."""
    from weatherconverter_tpu_torch.parallel.sharding import global_draws, shard_batch

    augment, accum, replay = _global_draws_augments()[name]
    rng = np.random.default_rng(14)
    images = torch.from_numpy(rng.integers(0, 256, (8, 16, 18, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.choice(np.array([0, 2, 6, 7, 8, 13, 255], np.uint8), (8, 16, 18)))
    want = augment(images, labels, torch.Generator().manual_seed(3), replay)
    for rank in range(2):
        mesh = _FakeMesh(2, rank)
        x, y = shard_batch(mesh, (images, labels), accum)
        draws = global_draws(mesh, accum, torch.Generator().manual_seed(3))
        got = augment(x, y, draws, shard_batch(mesh, replay, accum))
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, shard_batch(mesh, w, accum), rtol=0, atol=0)


def test_plan_mesh_at_one_process_has_no_mesh_unless_fsdp():
    """Under a process group of one, plain data parallelism plans no mesh,
    as JAX does at one device, so its step runs no collective; FSDP keeps
    the ("data",) mesh to shard through, and host_group of a gloo mesh is its
    own group."""
    import torch.distributed as dist

    from weatherconverter_tpu_torch.core.config import TrainingConfig
    from weatherconverter_tpu_torch.parallel.sharding import DATA_AXIS, host_group
    from weatherconverter_tpu_torch.training.loop_diffusion import plan_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        tr = TrainingConfig(batch_size=4)
        assert plan_mesh(tr, 10, torch.device("cpu")) == (None, 4)
        mesh, batch = plan_mesh(tr.model_copy(update=dict(fsdp=True)), 10, torch.device("cpu"))
        assert batch == 4 and mesh.mesh_dim_names == (DATA_AXIS,) and mesh.size() == 1
        assert host_group(mesh) is mesh.get_group() and host_group(None) is None
    finally:
        dist.destroy_process_group()


def test_seg_step_under_fsdp_at_one_rank_equals_the_plain_step():
    """SGD's two groups (backbone, head) split by FSDP into four, each
    marked with its group: two f64 steps at one gloo rank equal the plain
    steps (every parameter to 1e-12), each split group at its own group's
    rate, and the state dict holds the two groups as they were."""
    import copy

    import torch.distributed as dist

    from weatherconverter_tpu_torch.models import factory as PF
    from weatherconverter_tpu_torch.parallel import make_mesh
    from weatherconverter_tpu_torch.parallel.fsdp import full_state, shard_state_fsdp
    from weatherconverter_tpu_torch.training import losses as PL
    from weatherconverter_tpu_torch.training import segmentation as PS

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        torch.manual_seed(0)
        model = PF.make_seg_model(SEG_NAME, CLASSES, train=True).double()
        plain = PS.create_seg_state(model, OptCfg, 4)
        sharded = PS.create_seg_state(copy.deepcopy(model), OptCfg, 4)
        mesh = make_mesh()
        shard_state_fsdp(mesh, sharded)
        assert [g["origin"] for g in sharded.optimizer.param_groups] == [0, 0, 1, 1]
        rng = np.random.default_rng(15)
        x, y = torch.from_numpy(rng.standard_normal((2, SEG_HW, SEG_HW, 3))), torch.from_numpy(
            rng.integers(0, CLASSES, (2, SEG_HW, SEG_HW)))
        loss_fn = PL.make_seg_loss("CrossEntropyLoss", {"ignore_index": 255})
        for _ in range(2):
            PS.make_seg_train_step(loss_fn)(plain, x, y)
            PS.make_seg_train_step(loss_fn, mesh=mesh, fsdp=True)(sharded, x, y)
        assert [g["lr"] for g in sharded.optimizer.param_groups] == [
            g["lr"] for g in plain.optimizer.param_groups for _ in range(2)]
        want, got = plain.model.state_dict(), full_state(sharded.model.state_dict())
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-12)
        assert len(full_state(sharded.optimizer.state_dict())["param_groups"]) == 2
    finally:
        dist.destroy_process_group()


def test_maybe_initialize_distributed_does_nothing_without_torchrun(monkeypatch):
    """No torchrun variables: no group, False; a partial set raises by name."""
    from weatherconverter_tpu_torch.parallel import distributed as D

    for v in D.TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    assert D.maybe_initialize_distributed("cpu") is False
    assert (D.process_count(), D.is_primary()) == (1, True)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        D.maybe_initialize_distributed("cpu")


# ---------------------------------------------------------------------------
# two ranks against JAX's 2-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ddpm", "ddpm_accum2", "ddpm_fsdp"])
def test_ddpm_dp_step_matches_jax_on_two_devices(dp, case):
    """One Adam and EMA update at global batch 4 (2 a rank), plain, over two
    microbatches, and FSDP-sharded (held to JAX's replicated step, as JAX's
    tests/test_fsdp.py holds its own FSDP step): the loss (rtol 1e-5), every
    parameter's update (lr/100 where firm, lr everywhere), Adam's first
    moments (0.1 g: 2e-4 of the largest, the single-process step's gradient
    bound) and the EMA's move ((1 - decay) lr); both ranks hold the same
    parameters."""
    got, ref, inp, _ = dp
    got, want = got[case], ref[case]
    assert got["same"]
    _close(got["loss"], want["loss"], 1e-5, 0, case)
    start = inp["unet"]
    _close_adam_update(got["params"], _unet_sd(want["params"]), start, LR, case)
    mu = _unet_sd(want["mu"])
    scale = max(float(np.abs(v.numpy()).max()) for v in mu.values())
    for k, v in mu.items():
        _close(got["moments"][k], v.numpy(), 0, 2e-4 * scale, f"{case} moment {k}")
    _close_adam_update(got["ema"], _unet_sd(want["ema"]), start, 0.5 * LR, f"{case} ema")


def test_sharded_fraction_of_the_unet_state_matches_jax(dp):
    """The share of the state's bytes FSDP shards (parameters, Adam's moments,
    the EMA) at 2 ranks, against JAX's sharded_fraction of its sharded
    state: rtol 1e-4, for JAX's four 0-d counters (16 bytes), which the
    port's count leaves out."""
    got, ref, _, _ = dp
    assert 0 < got["ddpm_fsdp"]["fraction"] < 1
    _close(got["ddpm_fsdp"]["fraction"], ref["fraction"], 1e-4, 0)


def test_fsdp_optimizer_keeps_foreach_in_groups_of_one_kind(dp):
    """FSDP splits Adam's one group into its sharded parameters and its
    replicated ones, both marked as group 0, foreach kept: a foreach kernel
    takes DTensors or plain tensors, not both in one list. Its state dict
    keeps the unsharded layout (test_fsdp_checkpoint_from_two_ranks_loads_in_one_process)."""
    got = dp[0]["ddpm_fsdp"]
    assert got["groups"] == [(0, True, [True]), (0, True, [False])]


def test_preemption_flag_set_on_one_rank_is_agreed_by_all(dp):
    """The flag set on rank 1 alone is read as set on both ranks, through a
    gloo group on the host; unset before, on both."""
    got = dp[0]["preempt"]
    assert got["quiet"] is False and got["backend"] == "gloo"
    assert got["agreed"] == [(False, True), (True, True)]


def test_ddpm_eval_loss_matches_jax(dp):
    got, ref, _, _ = dp
    _close(got["eval"], ref["eval"], 1e-5, 0)


def test_dp_draws_are_the_global_batch_draws_and_per_rank_draws_break_it(dp):
    """The augmented step drawing from one seeded generator (crop, flip, t,
    noise) on two ranks equals the single-process step at the global batch
    (loss rtol 1e-5, parameters to lr/100 where firm); drawing for each
    rank's rows alone breaks it."""
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.training import diffusion as PD
    from weatherconverter_tpu_torch.training.loop_diffusion import make_augmented_train_step

    got, _, inp, _ = dp
    state = PD.create_ddpm_state(_unet(inp["unet"]), lr=LR)
    state, loss = make_augmented_train_step(linear_schedule(T_STEPS), 16)(
        state, torch.from_numpy(inp["u8"]), torch.Generator().manual_seed(11))
    want = {k: v.detach() for k, v in state.model.state_dict().items()}
    _close(got["generator"]["loss"], loss.item(), 1e-5, 0)
    _close_adam_update(got["generator"]["params"], want, inp["unet"], LR, "generator")
    with pytest.raises(AssertionError):
        _close(got["generator_draws_per_rank"]["loss"], loss.item(), 1e-5, 0)
        _close_adam_update(got["generator_draws_per_rank"]["params"], want, inp["unet"], LR, "per rank")


def _seg_checks(got, want):
    from weatherconverter_tpu_torch.compat import from_jax

    _close([got["loss"], got["ig"]], [want["loss"], want["ig"]], 1e-6, 0, "loss, input grad")
    want_sd = from_jax.deeplab_state_dict({"params": want["params"], "batch_stats": want["batch_stats"]}, SEG_NAME)
    from weatherconverter_tpu_torch.models import factory as PF

    names = [k for k, _ in PF.make_seg_model(SEG_NAME, CLASSES).named_parameters()]
    return want_sd, names


def test_seg_dp_step_with_batchnorm_and_accumulation_matches_jax_f64(dp):
    """DeepLabV3+/ResNet-18 in f64, global batch 4 (2 a rank) over two
    microbatches: BatchNorm on each global microbatch's statistics, the CE
    over its valid pixels, the input-gradient magnitude over it. Loss and
    input gradient to 1e-6; every parameter's update and SGD's momentum to
    2e-4 of the tensor's largest; the running statistics to 1e-6."""
    from weatherconverter_tpu_torch.compat import from_jax

    got, ref, inp, _ = dp
    got, want = got["seg"], ref["seg"]
    want_sd, names = _seg_checks(got, want)
    for k in names:
        dw = want_sd[k].numpy() - inp["seg64"][k].numpy()
        assert np.abs(dw).max() > 0, k
        _close(got["sd"][k] - inp["seg64"][k].numpy(), dw, 0, 2e-4 * np.abs(dw).max(), k)
    for k in want_sd:
        if k.endswith(("running_mean", "running_var")):
            w = want_sd[k].numpy()
            _close(got["sd"][k], w, 0, 1e-6 * np.abs(w).max(), k)
    want_buf = from_jax.deeplab_state_dict({"params": want["traces"], "batch_stats": want["batch_stats"]}, SEG_NAME)
    for k in names:
        w = want_buf[k].numpy()
        _close(got["buffers"][k], w, 0, 2e-4 * np.abs(w).max(), f"momentum {k}")


@pytest.mark.parametrize("fault", SEG_FAULTS)
def test_seg_planted_faults_break_the_comparison(dp, fault):
    """Each planted fault moves the step out of the bounds above: BatchNorm
    on each rank's rows alone, the CE over each rank's valid pixels alone,
    and each rank's rows taken as a contiguous block (its microbatches are
    then not its shares of JAX's)."""
    got, ref, inp, _ = dp
    bad, want = got[f"seg_{fault}"], ref["seg"]
    with pytest.raises(AssertionError):
        want_sd, names = _seg_checks(bad, want)
        for k in names:
            dw = want_sd[k].numpy() - inp["seg64"][k].numpy()
            _close(bad["sd"][k] - inp["seg64"][k].numpy(), dw, 0, 2e-4 * np.abs(dw).max(), k)


def test_srgan_dp_pretrain_and_gan_steps_match_jax_f64(dp):
    """A pretrain step, then a GAN step, at global batch 4 (2 a rank), f64:
    the three losses to 1e-6, G's and D's BatchNorm statistics (1e-6), Adam's
    first moments (1e-6 of the network's largest), and every parameter's
    update from the start to 2e-4 of the tensor's largest, except where the
    gradient is within a hundred eps of 0 (|first moment| < 1e-7): there
    Adam's update, g / (|g| + eps), hangs on g's last bits, and the BCE, which
    both frameworks take in f32, leaves g some 1e-10 apart (measured: 1e-2 of
    g at 8.5e-9 in an element of D's classifier, in the single-process step
    too), so those are held to the update's bound, lr a step."""
    from weatherconverter_tpu_torch.compat import from_jax

    got, ref, inp, _ = dp
    got, want = got["srgan"], ref["srgan"]
    _close(got["losses"], want["losses"], 1e-6, 0, "losses")
    g_conv = lambda v: from_jax.srgan_generator_state_dict(v, G_KW["num_blocks"])  # noqa: E731
    for key, conv, start, bound in (("gen", g_conv, inp["gen64"], 2e-3),
                                    ("disc", from_jax.srgan_discriminator_state_dict, inp["disc64"], 2e-3)):
        mu = conv(want["mu_g" if key == "gen" else "mu_d"])
        moments = got["mu_g" if key == "gen" else "mu_d"]
        scale = max(float(np.abs(mu[k].numpy()).max()) for k in moments)
        for k in moments:
            _close(moments[k], mu[k].numpy(), 0, 1e-6 * scale, f"{key} moment {k}")
        for k, w in conv(want[key]).items():
            w = w.numpy()
            if k.endswith(("running_mean", "running_var")):
                _close(got[key][k], w, 0, 1e-6 * np.abs(w).max(), k)
            elif k in moments:
                dw, dg = w - start[k].numpy(), got[key][k] - start[k].numpy()
                firm = np.abs(mu[k].numpy()) >= 1e-7
                assert firm.mean() > 0.99, k
                _close(dg[firm], dw[firm], 0, 2e-4 * np.abs(dw).max(), k)
                _close(dg, dw, 0, bound, k)


def test_seg_confusion_over_a_ragged_last_batch_matches_jax(dp):
    """Five validation pairs at global batch 4: the ragged last batch padded
    with ignore-labelled rows on each rank, the counts summed over the ranks:
    JAX's confusion matrix exactly (integer counts)."""
    got, ref, _, _ = dp
    assert got["confusion"]["shapes"] == [(2, SEG_HW, SEG_HW, 3)] * 2
    np.testing.assert_array_equal(got["confusion"]["conf"], ref["confusion"])
    assert got["confusion"]["conf"].sum() == 5 * SEG_HW * SEG_HW


def test_guided_translation_across_two_ranks_equals_the_single_process(dp):
    """sample_with_sgg on each rank's row, with its rows of the replayed
    draws, gathered: the single-process translation of the batch, to 1e-5
    (a row at batch 1 against batch 2: convolutions sum in another order)."""
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    got, _, inp, _ = dp
    x, gt, n0, z = (torch.from_numpy(a) for a in inp["translate"])
    want = make_translate_fn(*_translate_models(inp), **_TRANSLATE_KW)(x, gt, noise=(n0, z), start_t=2)
    assert got["translate"].shape == tuple(want.shape) == (2, 32, 32, 3)
    _close(got["translate"], want.numpy(), 0, 1e-5)


def test_primary_only_checkpoint_then_resume_bit_equal(dp):
    """Exactly one primary; its save holds one step, restored on both ranks
    into a fresh state, whose next step's loss equals the uninterrupted run's
    bit for bit; a single-process checkpoint restores into both ranks."""
    got, _, _, workdir = dp
    r = got["resume"]
    assert r["primaries"] == [True, False]
    assert r["files"] == ["1"] and os.listdir(os.path.join(workdir, "ck_resume", "1")) == ["state.pt"]
    assert r["cont"] == r["res"]
    single = torch.load(os.path.join(workdir, "single.pt"), weights_only=True)["model"]
    assert r["single_same"] and all(np.array_equal(r["single"][k], v.numpy()) for k, v in single.items())


def test_fsdp_checkpoint_from_two_ranks_loads_in_one_process(dp):
    """The FSDP run's checkpoint (the full state, gathered before the save)
    loads strictly into a plain single-process state: the parameters the
    ranks held, the EMA and Adam's moments whole."""
    from weatherconverter_tpu_torch.core.checkpoint import restore_auto
    from weatherconverter_tpu_torch.training import diffusion as PD

    got, _, inp, workdir = dp
    state = PD.create_ddpm_state(_unet(inp["unet"]), lr=LR, ema_decay=0.5)
    restore_auto(os.path.join(workdir, "ck_fsdp"), state, prefer_best=False)
    sd = state.model.state_dict()
    assert all(np.array_equal(got["ddpm_fsdp"]["params"][k], v.numpy()) for k, v in sd.items())
    assert all(np.array_equal(got["ddpm_fsdp"]["ema"][k], v.numpy()) for k, v in state.ema.params.items())
    names = {id(p): n for n, p in state.model.named_parameters()}
    moments = {names[id(p)]: s["exp_avg"] for p, s in state.optimizer.state.items()}
    assert moments.keys() == got["ddpm_fsdp"]["moments"].keys() and state.step == 1
    assert all(np.array_equal(got["ddpm_fsdp"]["moments"][k], v.numpy()) for k, v in moments.items())


def test_cli_train_ddpm_under_two_ranks_leaves_one_run(dp):
    """`train-ddpm --device cpu` on both ranks (global batch 4 from 2 a
    rank, 8 images: an epoch of 2 steps, a save, then the third step ends
    the run): exit 0, one run directory with one metrics log and one
    checkpoint set; the seg and SRGAN loops under the same ranks end with
    the same parameters on both."""
    got, _, _, workdir = dp
    loops = got["loops"]
    assert loops["cli_exit"] == 0
    runs = os.path.join(workdir, "ddpm_runs")
    assert sorted(os.listdir(runs)) == ["0"]
    assert sorted(os.listdir(os.path.join(runs, "0", "checkpoints"))) == ["1"]
    with open(os.path.join(runs, "0", "metrics.jsonl")) as f:
        steps = [json.loads(line).get("_step") for line in f]
    assert 3 in steps or 2 in steps
    assert loops["seg_step"] == 2 and loops["seg_same"]  # 4 pairs at global batch 2 (1 a rank): 2 steps
    assert sorted(os.listdir(os.path.join(workdir, "seg_runs"))) == ["0"]
    assert loops["srgan_steps"] == (4, 2) and loops["srgan_same"]
    assert sorted(os.listdir(os.path.join(workdir, "srgan_runs", "0", "checkpoints"))) == ["1", "2"]


def test_the_ranks_imported_no_jax(dp):
    got = dp[0]
    assert got["jax_imported"] == []
    assert sum(got["times"].values()) < WORKER_TIMEOUT_S
