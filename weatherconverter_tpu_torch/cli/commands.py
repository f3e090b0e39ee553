"""The CLI's subcommands and the checkpoint loaders (port of
weatherconverter_tpu/cli/commands.py): sample (the legacy UNet's loop too),
translate (with --debug-dir's chain dumps), super-resolve, infer-seg,
quality, visualize, export-hlo, train-ddpm, train-seg and train-srgan, on
the CUDA card
unless `--device cpu` asks for the CPU.

Checkpoints: a reference torch file (.pt, .pth, .ckpt, .tar; its
`model_state_dict` / `state_dict` / `model` entry when wrapped) loads with
`strict=True`, since the port keeps the reference's parameter names; a JAX
.npz goes through `compat/from_jax.py`; a training-run directory of this
package through `core/checkpoint.restore_auto`, the EMA preferred and a seg
run's best "Mean IoU" step taken; None gives
random weights from the seed. An Orbax directory of the JAX package is
refused by name: the port has no Orbax.

int8 attention: on the card the inference commands build the UNet with
`qk_int8=True`, as the JAX CLI defaults to its int8 kernel on the TPU;
`--no-int8-attn` keeps K1. Such a model takes K2 (the int8 Q K^T flash
forward, and its quantizer) in every flash-length layer, D = 24 of the
legacy UNet and D = 192 of a 256 px UNet included, as JAX's int8 kernel
takes any head dim. The quality check
(`probes/int8_quality.py`) passed K2 at 20, 50 and 1000 steps on the H100
(PERF.md section 6). The CPU has no int8 path, and training never takes K2
(it has no backward).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

TORCH_SUFFIXES = (".pt", ".pth", ".ckpt", ".tar")


def resolve_device(name: str) -> torch.device:
    """The `--device` flag as a torch.device: "cuda" (the default) needs a
    card and stops the command without one; "cpu" runs on the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this command runs on the card by default; pass --device cpu to run it on "
                         "the CPU")
    return torch.device(name)


def use_qk_int8(args, device: torch.device) -> bool:
    """K2 for the inference commands on the card, unless --no-int8-attn."""
    return device.type == "cuda" and not getattr(args, "no_int8_attn", False)


def autocast(device: torch.device):
    """bf16 autocast on the card (the flash kernels take bf16); f32 on the CPU."""
    if device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


@contextlib.contextmanager
def seeded(seed: int):
    """Random weights from `seed`, without touching the caller's global generator."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def load_torch_checkpoint(path: str) -> dict:
    """torch.load on the CPU, unwrapping the reference's wrapper dicts
    (`model_state_dict`, `state_dict`, `model`)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if isinstance(obj.get(key), dict):
                return obj[key]
    return obj


def load_npz_tree(path: str) -> dict:
    """A JAX .npz (keys are "/"-joined paths of a parameter tree) as the nested tree of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def _port_checkpoint(path: str):
    """The saved tree of a training run's checkpoint directory (its best step
    where the run recorded one, as a seg run records its best "Mean IoU";
    else its latest), a step directory or a state file of this package; an
    Orbax directory is refused by name."""
    from weatherconverter_tpu_torch.core.checkpoint import STATE_FILE, restore_auto

    if os.path.isdir(path):
        steps = [d for d in os.listdir(path) if d.isdigit()]
        ours = os.path.isfile(os.path.join(path, STATE_FILE)) or any(
            os.path.isfile(os.path.join(path, d, STATE_FILE)) for d in steps)
        if not ours:
            raise SystemExit(f"{path}: not a checkpoint of this package (no {STATE_FILE}); an Orbax checkpoint of the "
                             "JAX package cannot be read here (no Orbax on the card): export it as .npz")
    return restore_auto(path, None, prefer_best=True)


def load_state(model: torch.nn.Module, checkpoint: str | None, from_npz, what: str) -> torch.nn.Module:
    """Load `checkpoint` into `model` (strict) by its kind: a torch file, a
    JAX .npz (`from_npz(tree)` gives the state dict) or a directory of this
    package; None keeps the model's own (seeded random) weights."""
    if checkpoint is None:
        return model
    if checkpoint.endswith(".npz"):
        tree = load_npz_tree(checkpoint)
        sd = from_npz(tree)
    elif checkpoint.endswith(TORCH_SUFFIXES) and os.path.isfile(checkpoint):
        sd = load_torch_checkpoint(checkpoint)
    else:
        tree = _port_checkpoint(checkpoint)
        sd = tree.get("model", tree) if isinstance(tree, dict) else tree
        ema = tree.get("ema") if isinstance(tree, dict) else None
        if ema and ema.get("params"):
            # a training run's EMA shadow over its live parameters, as the JAX CLI prefers it
            sd = {**sd, **ema["params"]}
    model.load_state_dict(sd, strict=True)
    print(f"loaded {what} from {checkpoint}")
    return model


def load_unet(model_cfg, checkpoint: str | None, seed: int, qk_int8: bool = False, qk_int8_per_item: bool = False,
              fused: bool = True):
    """The DDPM UNet (counterpart of `_load_unet_params`)."""
    from weatherconverter_tpu_torch.compat.from_jax import unet_state_dict
    from weatherconverter_tpu_torch.models.unet import Unet

    with seeded(seed):
        model = Unet(model_cfg, qk_int8=qk_int8, fused=fused, qk_int8_per_item=qk_int8_per_item)
    return load_state(model, checkpoint, lambda t: unet_state_dict(t.get("params", t), model_cfg), "the UNet")


def load_seg_model(seg_cfg, checkpoint: str | None, seed: int):
    """The DeepLabV3(+) seg model in eval mode (counterpart of `load_seg_variables`)."""
    from weatherconverter_tpu_torch.compat.from_jax import deeplab_state_dict
    from weatherconverter_tpu_torch.models.factory import make_seg_model

    m = seg_cfg.model
    with seeded(seed):
        model = make_seg_model(m.name, m.num_classes, m.output_stride)
    return load_state(model, checkpoint, lambda t: deeplab_state_dict(t, m.name), "the seg model").eval()


def load_srgan(sr_cfg, checkpoint: str | None, seed: int):
    """The Swift-SRGAN generator in eval mode."""
    from weatherconverter_tpu_torch.compat.from_jax import srgan_generator_state_dict
    from weatherconverter_tpu_torch.models.srgan import Generator

    with seeded(seed):
        model = Generator(in_channels=sr_cfg.in_channels, num_channels=sr_cfg.num_channels,
                          num_blocks=sr_cfg.num_blocks, upscale_factor=sr_cfg.upscale_factor)
    return load_state(model, checkpoint, lambda t: srgan_generator_state_dict(t, sr_cfg.num_blocks),
                      "the SRGAN generator").eval()


def load_legacy_unet(image_size: int, checkpoint: str | None, seed: int):
    """The legacy UNet (the reference's old_modules.UNet): a reference torch
    file (old_model/1000-checkpoint.ckpt) through
    `compat/from_jax.load_legacy_reference`, or seeded random weights."""
    from weatherconverter_tpu_torch.compat.from_jax import load_legacy_reference
    from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet

    with seeded(seed):
        model = LegacyUNet(image_size=image_size)
    if checkpoint is None:
        return model
    if not (checkpoint.endswith(TORCH_SUFFIXES) and os.path.isfile(checkpoint)):
        raise SystemExit(f"{checkpoint}: the legacy UNet loads a reference torch file ({', '.join(TORCH_SUFFIXES)})")
    load_legacy_reference(model, load_torch_checkpoint(checkpoint))
    print(f"loaded the legacy UNet from {checkpoint}")
    return model


def make_schedule_from(process_cfg, device):
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule

    return make_schedule(process_cfg.schedule, process_cfg.num_timesteps, process_cfg.beta_start,
                         process_cfg.beta_end, device=device)


def _load_image(path: str, size: int) -> np.ndarray:
    """(size, size, 3) f32 in [0, 1], bilinear (as the JAX CLI loads an input)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _resolve_lcg_present_k(spec, gt, num_classes: int):
    """--lcg-present-k: 'auto' = the number of distinct train-ids in the label
    (a covering K, bit-exact against the full sweep), 'off'/None = the full
    sweep, an integer = a truncating K."""
    if spec in (None, "off"):
        return None
    if spec == "auto":
        k = int(np.unique(np.asarray(gt)[np.asarray(gt) != 255]).size)
        return min(max(k, 1), num_classes)
    try:
        k = int(spec)
    except ValueError:
        raise SystemExit(f"--lcg-present-k must be 'auto', 'off', or an integer; got {spec!r}")
    if not 1 <= k <= num_classes:
        raise SystemExit(f"--lcg-present-k out of range 1..{num_classes}: {k}")
    return k


def run_sample(args) -> int:
    """Unconditional sampling (ddpm, ddim, dpm, and legacy: the legacy UNet
    at the config's im_size through `ddpm_sample_legacy`) into a PNG grid.
    The legacy UNet runs in f32 on the card too, as in JAX (K1-f32 at its
    flash-length layers, no TF32): its bf16 chain failed the precision
    check of probes/legacy_precision.py on the H100 (PERF.md section 6)."""
    from weatherconverter_tpu_torch.core.config import load_diffusion_config
    from weatherconverter_tpu_torch.diffusion.sampling import (ddim_sample, ddpm_sample, ddpm_sample_legacy,
                                                               dpm_solver_pp_2m_sample)
    from weatherconverter_tpu_torch.utils.images import save_images

    device = resolve_device(args.device)
    cfg = load_diffusion_config(args.config)
    sched = make_schedule_from(cfg.diffusion, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (args.batch, cfg.model.im_size, cfg.model.im_size, cfg.model.im_channels)
    if args.sampler == "legacy":
        from weatherconverter_tpu_torch.models.unet_legacy import full_f32

        unet = load_legacy_unet(cfg.model.im_size, args.checkpoint, args.seed).to(device)
        with full_f32():
            out = ddpm_sample_legacy(unet, sched, shape, gen, num_steps=args.steps)
    else:
        unet = load_unet(cfg.model, args.checkpoint, args.seed, use_qk_int8(args, device)).to(device).eval()
        with autocast(device):
            if args.sampler == "ddim":
                out = ddim_sample(unet, sched, shape, gen, num_steps=args.steps or 50)
            elif args.sampler == "dpm":
                out = dpm_solver_pp_2m_sample(unet, sched, shape, gen, num_steps=args.steps or 20)
            else:
                out = ddpm_sample(unet, sched, shape, gen, num_steps=args.steps)
    path = save_images(out, args.out, nrow=4)
    print(f"saved {path}")
    return 0


def build_translation(cfg, device, unet_ckpt, seg_ckpt, srgan_ckpt, qk_int8: bool, seed: int,
                      qk_int8_per_item: bool = False):
    """The three models of a translation on `device` (the seg model frozen)
    and the schedule; `qk_int8_per_item` as `models.unet.Unet` takes it."""
    unet = load_unet(cfg.diffusion.model, unet_ckpt, seed, qk_int8, qk_int8_per_item).to(device).eval()
    seg = load_seg_model(cfg.seg, seg_ckpt, seed + 1).to(device).requires_grad_(False)
    sr = load_srgan(cfg.srgan, srgan_ckpt, seed + 2).to(device)
    return unet, seg, sr, make_schedule_from(cfg.diffusion.diffusion, device)


def fast_translate_fn(sampler: str, unet, sched, seg, sr, device, **kw):
    """translate(input_128, gt, generator) on the DDIM or DPM-Solver++(2M) chain, under `device`'s autocast."""
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg_ddim, sample_with_sgg_dpm

    chain = sample_with_sgg_dpm if sampler == "dpm" else sample_with_sgg_ddim

    def translate(input_128, gt, generator=None, noise=None):
        with autocast(device):
            return chain(unet, sched, seg, sr, input_128, gt, generator, noise=noise, **kw)

    return translate


def run_translate(args) -> int:
    """Guided translation of one image and its labelIds map (reference:
    translation.py:100-164)."""
    from PIL import Image

    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.data.labels import encode_target
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn
    from weatherconverter_tpu_torch.utils.images import save_images

    device = resolve_device(args.device)
    cfg = load_translation_config(args.config)
    sampler = args.sampler
    if args.steps is None:
        # the fast samplers exist for few-step translation: 500 would defeat them
        args.steps = {"ddim": 50, "dpm": 20}.get(sampler, 500)
    if args.debug_dir and sampler != "ddpm":
        raise SystemExit("--debug-dir traces the DDPM reverse chain through its bit-identical segments "
                         "(guidance/translate.py xt_init/t_offset); the few-step ddim/dpm trajectories have no "
                         "segment continuation: use --sampler ddpm.")
    if sampler in ("ddim", "dpm") and args.mode == "reference":
        raise SystemExit(f"--sampler {sampler} with --mode reference would disable guidance entirely (the "
                         "reference's x_t overwrite has no fast-solver analog). Use --mode fixed for guided fast "
                         "translation, or --sampler ddpm for the reference's behaviour.")
    size = cfg.diffusion.model.im_size
    hr = size * cfg.srgan.upscale_factor
    num_classes = cfg.seg.model.num_classes

    img = _load_image(args.image, size) * 2.0 - 1.0
    lbl = Image.open(args.label).resize((hr, hr), Image.NEAREST)
    gt = encode_target(np.asarray(lbl, dtype=np.uint8))
    lcg_k = _resolve_lcg_present_k(args.lcg_present_k, gt, num_classes)

    unet, seg, sr, sched = build_translation(cfg, device, args.ddpm_checkpoint, args.seg_checkpoint,
                                             args.srgan_checkpoint, use_qk_int8(args, device), args.seed)
    common = dict(lam=args.lam, num_steps=args.steps, mode=args.mode, num_classes=num_classes, lcg_present_k=lcg_k)
    if sampler in ("ddim", "dpm"):
        span_t = args.span_t if args.span_t is not None else cfg.guidance.num_steps
        extra = dict(eta=args.eta) if sampler == "ddim" else {}
        translate = fast_translate_fn(sampler, unet, sched, seg, sr, device, span_t=span_t, **extra, **common)
    else:
        translate = make_translate_fn(unet, sched, seg, sr, dtype=torch.bfloat16 if device.type == "cuda" else None,
                                      **common)
    x = torch.from_numpy(img)[None].to(device)
    g = torch.from_numpy(gt.astype(np.int64))[None].to(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.debug_dir:
        return _run_translate_debug(args, translate, sched, seg, sr, device, x, g, generator)
    out = translate(x, g, generator)
    save_images(out, args.out, nrow=1, from_range="unit")
    print(f"saved {args.out}")
    return 0


def _run_translate_debug(args, translate, sched, seg, sr, device, x, g, generator) -> int:
    """`translate --debug-dir`: the chain's intermediates (the original
    code's debug dumps, translation.py:17-39, 58-92): input.png, gt.png,
    xt_{steps}_noised.png, xt_{lo}.png after every --debug-every steps,
    sr_x0.png and its seg prediction sr_x0_pred.png, then the output. The
    chain runs in segments (sample_with_sgg's xt_init / t_offset,
    final_sr=False) from `translate_entry`'s draws, so the trajectory and
    the output are the plain translate's for the same seed, bit for bit."""
    from weatherconverter_tpu_torch.diffusion.sampling import nchw, nhwc
    from weatherconverter_tpu_torch.guidance.translate import translate_entry
    from weatherconverter_tpu_torch.utils.debug import debug_tensor
    from weatherconverter_tpu_torch.utils.images import save_images

    d, steps, every = args.debug_dir, args.steps, max(1, args.debug_every)
    debug_tensor(x, os.path.join(d, "input.png"), "input_tensor")
    debug_tensor(g, os.path.join(d, "gt.png"), "gt")
    xt = translate_entry(sched, x, steps, generator)
    debug_tensor(xt, os.path.join(d, f"xt_{steps}_noised.png"), "xt_noised")
    prev = steps
    for lo in range((steps - 1) // every * every, -1, -every):
        xt = translate(x, g, generator, xt_init=xt, t_offset=lo, num_steps=prev - lo, final_sr=False)
        # xt_{lo}.png: the latent after step lo, the original code's naming
        debug_tensor(xt, os.path.join(d, f"xt_{lo}.png"), f"xt after step {lo}")
        prev = lo
    with torch.no_grad(), autocast(device):
        sr_out = nhwc(sr(nchw(xt)))
        pred = seg(nchw(sr_out)).argmax(dim=1).to(torch.uint8)
    debug_tensor(sr_out.float(), os.path.join(d, "sr_x0.png"), "sr_x0", from_range="unit")
    debug_tensor(pred, os.path.join(d, "sr_x0_pred.png"), "seg pred of output")
    save_images(sr_out, args.out, nrow=1, from_range="unit")
    print(f"saved {args.out} (debug dumps in {d})")
    return 0


EXPORT_ATTN = ("bf16", "int8")


def inference_models(cfg, program: str, attn: str, device=None, seed: int = 0) -> dict:
    """The models of `export-hlo`'s program, {"unet"} for `sample` and
    {"unet", "seg", "srgan"} for `translate`, in eval mode: with seeded
    random weights on `device` (the frozen seg model as `build_translation`
    makes it), or with `device=None` on the meta device, shapes only (the
    exported program takes the weights as arguments). `attn` "bf16" is JAX's
    fused=False UNet (plain softmax attention, no kernel); "int8" its fused
    UNet with K2 and one int8 scale per tensor, as JAX traces its kernel
    over the batch."""
    if attn not in EXPORT_ATTN:
        raise ValueError(f"attn must be one of {EXPORT_ATTN}, got {attn!r}")
    int8 = attn == "int8"
    with torch.device("meta") if device is None else contextlib.nullcontext():
        models = {"unet": load_unet(cfg.diffusion.model, None, seed, qk_int8=int8, fused=int8)}
        if program == "translate":
            models["seg"] = load_seg_model(cfg.seg, None, seed + 1).requires_grad_(False)
            models["srgan"] = load_srgan(cfg.srgan, None, seed + 2)
    return {k: (m if device is None else m.to(device)).eval() for k, m in models.items()}


def _weights(model: torch.nn.Module):
    return [*model.named_parameters(), *model.named_buffers()]


def program_arguments(cfg, program: str, steps: int, batch: int, models: dict):
    """The exported program's flat arguments in order, as (name, shape,
    dtype): each model's parameters then buffers ("unet.<name>", then for
    `translate` "seg.<name>" and "srgan.<name>"; weights are never baked
    in), then the data. `sample`: x_init (B, s, s, 3) and z_steps (steps, B,
    s, s, 3), the chain's N(0, I) draws (JAX draws them from its key);
    `translate`: input (B, s, s, 3) in [-1, 1], labels (B, hr, hr) int64
    train ids (255 ignored), noise0 (B, s, s, 3), the q-sample's draw, and
    z_steps (steps, B, s, s, 3), each step's. s is the UNet's im_size, hr
    s times the SRGAN's factor."""
    weights = [(f"{k}.{n}", tuple(t.shape), t.dtype) for k, m in models.items() for n, t in _weights(m)]
    s, f32 = cfg.diffusion.model.im_size, torch.float32
    latent, draws = (batch, s, s, 3), (steps, batch, s, s, 3)
    if program == "sample":
        return weights + [("x_init", latent, f32), ("z_steps", draws, f32)]
    hr = s * cfg.srgan.upscale_factor
    return weights + [("input", latent, f32), ("labels", (batch, hr, hr), torch.int64), ("noise0", latent, f32),
                      ("z_steps", draws, f32)]


def weight_arguments(models: dict) -> list:
    """The weight tensors of `models` in `program_arguments`' order."""
    return [t.detach() for m in models.values() for _, t in _weights(m)]


def inference_program(cfg, program: str, steps: int, models: dict, device):
    """fn(*args) over `program_arguments`: JAX's exported function
    (cli/commands.py run_export_hlo) with the weights and the draws as
    arguments. `sample`: ddpm_sample over `steps` strided steps, (B, s, s,
    3) in [-1, 1]; `translate`: sample_with_sgg at the config's lambda and
    mode, the JAX defaults otherwise (the alternate schedule on the SRGAN
    upscale every step), start_t = steps - 1, (B, hr, hr, 3) in [0, 1]. On
    CUDA under bf16 autocast, as every inference command runs there."""
    from torch.func import functional_call

    from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg

    names = {k: [n for n, _ in _weights(m)] for k, m in models.items()}
    sched = make_schedule_from(cfg.diffusion.diffusion, device)
    g = cfg.guidance

    def fn(*args):
        it = iter(args)
        state = {k: {n: next(it) for n in ns} for k, ns in names.items()}
        call = {k: (lambda *x, k=k: functional_call(models[k], state[k], x)) for k in models}
        data = list(it)
        with autocast(device):
            if program == "sample":
                x_init, z_steps = data
                return ddpm_sample(call["unet"], sched, tuple(x_init.shape), None, num_steps=steps,
                                   noise=(x_init, z_steps))
            inp, gt, noise0, z_steps = data
            return sample_with_sgg(call["unet"], sched, call["seg"], call["srgan"], inp, gt, None, lam=g.lambda_,
                                   num_steps=steps, num_classes=cfg.seg.model.num_classes, mode=g.mode,
                                   start_t=steps - 1, noise=(noise0, z_steps))

    return fn


def export_program(fn, args: list, out: str, info: dict) -> dict:
    """Trace fn(*args) and write it to `out` with torch.export, and its
    description (`info` and the arguments' names, shapes and dtypes) to
    `out`.json (with the returned numbers under "export"). The trace is make_fx's (fake tensors): the guidance's
    torch.autograd.grad is recorded as the aten ops of its backward, which
    torch.export cannot trace itself, and autocast as explicit casts. Returns
    the seconds of each stage, the graph's nodes and the artifact's MiB."""
    import json
    import time

    from torch.fx.experimental.proxy_tensor import make_fx

    t0 = time.perf_counter()
    graph = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    # make_fx records a view where the strides of its trace allowed one; under autocast on CUDA the strides that
    # torch.export derives again can differ (a cast there keeps a transposed layout), so every view becomes a
    # reshape: the same values, a view where the strides allow it and a copy where they do not
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    for node in graph.graph.nodes:
        if node.op == "call_function" and node.target in views:
            node.target = torch.ops.aten.reshape.default
    graph.recompile()
    t1 = time.perf_counter()
    exported = torch.export.export(graph, tuple(args))
    exported.example_inputs = None  # not saved with the program: the weights are arguments, not part of it
    t2 = time.perf_counter()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.export.save(exported, out)
    t3 = time.perf_counter()
    stats = dict(trace_s=t1 - t0, export_s=t2 - t1, save_s=t3 - t2, nodes=len(graph.graph.nodes),
                 mib=os.path.getsize(out) / 2**20)
    with open(out + ".json", "w") as fh:
        json.dump(dict(info, export=stats), fh, indent=1)
    return stats


def run_export_hlo(args) -> int:
    """Export the inference program (counterpart of JAX's StableHLO export,
    cli/commands.py run_export_hlo) as a torch.export archive: `translate`
    (the guided chain with its three models at the config's shapes) or
    `sample` (the unconditional chain), `--steps` steps at `--batch`, on
    `--device`. Weights and the chain's draws are arguments
    (`program_arguments`); `serving/hlo_runtime.load_exported` runs the
    file with no model code. `--attn bf16` is JAX's portable form, plain
    softmax attention with no kernel: any PyTorch runtime loads it. `--attn
    int8` holds K2 and its quantizer as custom ops (`ops/attention.OPS`), so
    it is traced on CUDA only (JAX refuses its int8 export off its
    accelerator), and its runtime imports `ops/attention`."""
    from weatherconverter_tpu_torch.core.config import load_translation_config

    device = resolve_device(args.device)
    if args.attn == "int8" and device.type != "cuda":
        raise SystemExit("--attn int8 exports K2 and its quantizer as CUDA custom ops and must be traced on CUDA "
                         f"(--device cuda; this run asked for {device.type}); use --attn bf16 for a portable export")
    cfg = load_translation_config(args.config)
    steps = args.steps or cfg.guidance.num_steps
    models = inference_models(cfg, args.program, args.attn)
    spec = program_arguments(cfg, args.program, steps, args.batch, models)
    example = [torch.empty(shape, dtype=dtype, device=device) for _, shape, dtype in spec]
    info = dict(program=args.program, steps=steps, batch=args.batch, attn=args.attn, device=device.type,
                args=[[name, list(shape), str(dtype).replace("torch.", "")] for name, shape, dtype in spec])
    t = export_program(inference_program(cfg, args.program, steps, models, device), example, args.out, info)
    print(f"exported {args.program} ({steps} steps, batch {args.batch}, attention {args.attn}, {device.type}) with "
          f"torch.export: {args.out} ({t['mib']:.1f} MiB, {t['nodes']} nodes, {len(spec)} arguments); trace "
          f"{t['trace_s']:.1f} s, export {t['export_s']:.1f} s, save {t['save_s']:.1f} s")
    return 0


def run_visualize(args) -> int:
    """The forward and backward process strips and the augmentation
    galleries of one image (reference: visualizer.py:39-109, 160-191) into
    `--out`: forward.png (q(x_t | x_0) every --every steps), backward.png (a
    batch-1 ddpm_sample over the config's full T, a frame every --every
    steps), aug_photometric.png and aug_geometric.png. The UNet takes K1 on
    the card (no int8: as in JAX, this command never turns it on)."""
    from weatherconverter_tpu_torch.core.config import load_diffusion_config
    from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample
    from weatherconverter_tpu_torch.utils.images import (augmentation_galleries, backward_process_strip,
                                                         forward_process_strip, save_strip)

    device = resolve_device(args.device)
    cfg = load_diffusion_config(args.config)
    sched = make_schedule_from(cfg.diffusion, device)
    size = cfg.model.im_size
    x0 = torch.from_numpy(_load_image(args.image, size) * 2.0 - 1.0).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    save_strip(forward_process_strip(sched, x0, generator, every=args.every), os.path.join(args.out, "forward.png"))

    unet = load_unet(cfg.model, args.checkpoint, 0).to(device).eval()
    with autocast(device):
        _, traj = ddpm_sample(unet, sched, (1, size, size, cfg.model.im_channels), generator,
                              return_trajectory_every=args.every)
    save_strip(backward_process_strip(traj), os.path.join(args.out, "backward.png"))

    galleries = augmentation_galleries((x0 + 1.0) / 2.0, torch.Generator(device=device).manual_seed(1))
    for name, strip in galleries.items():
        save_strip(strip, os.path.join(args.out, f"aug_{name}.png"), from_range="unit")
    print(f"saved strips under {args.out}")
    return 0


def run_super_resolve(args) -> int:
    """The SRGAN's upscale of one image (reference: srgan_model/inference.py:35-53)."""
    from PIL import Image

    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.utils.images import to_uint8_image

    device = resolve_device(args.device)
    cfg = load_translation_config(args.config)
    sr = load_srgan(cfg.srgan, args.checkpoint, 0).to(device)
    img = np.asarray(Image.open(args.image).convert("RGB"), dtype=np.float32) / 255.0
    with torch.no_grad():
        out = sr(torch.from_numpy(img).permute(2, 0, 1)[None].to(device)).permute(0, 2, 3, 1)
    arr = to_uint8_image(out, "unit")[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    Image.fromarray(arr).save(args.out)
    print(f"saved {args.out} ({out.shape[2]}x{out.shape[1]})")
    return 0


def run_train_ddpm(args) -> int:
    """DDPM training through training/loop_diffusion.train, on `--device`."""
    from weatherconverter_tpu_torch.cli.main import parse_overrides
    from weatherconverter_tpu_torch.core.config import load_diffusion_config
    from weatherconverter_tpu_torch.training import loop_diffusion

    device = resolve_device(args.device)
    overrides = parse_overrides(args.set)
    overrides.setdefault("training", {})["device"] = device.type
    cfg = load_diffusion_config(args.config, **overrides)
    loop_diffusion.train(cfg, max_steps=args.max_steps)
    return 0


def run_train_seg(args) -> int:
    """Segmentation training through training/loop_segmentation.train, on `--device`."""
    from weatherconverter_tpu_torch.cli.main import parse_overrides
    from weatherconverter_tpu_torch.core.config import load_seg_config
    from weatherconverter_tpu_torch.training import loop_segmentation

    device = resolve_device(args.device)
    overrides = parse_overrides(args.set)
    overrides.setdefault("training", {})["device"] = device.type
    loop_segmentation.train(load_seg_config(args.config, **overrides), max_steps=args.max_steps)
    return 0


def run_train_srgan(args) -> int:
    """Swift-SRGAN training through training/loop_srgan.train, on `--device`.
    The run's checkpoint directory loads into super-resolve and translate."""
    from weatherconverter_tpu_torch.cli.main import parse_overrides
    from weatherconverter_tpu_torch.core.config import load_srgan_train_config
    from weatherconverter_tpu_torch.training import loop_srgan

    device = resolve_device(args.device)
    overrides = parse_overrides(args.set)
    overrides.setdefault("training", {})["device"] = device.type
    loop_srgan.train(load_srgan_train_config(args.config, **overrides), max_steps=args.max_steps)
    return 0


def run_infer_seg(args) -> int:
    """Seg inference of one image into `<out>/pred.png` and, given a labelIds
    map, the input-gradient probe (`gradient_magnitude.png`) and the six-panel
    strip `panels.png`: the image, the denormalized input, the colorized
    prediction, the gradient magnitude, the train-id plane and the colorized
    ground truth (reference: seg_model/inference.py:118-200)."""
    from PIL import Image

    from weatherconverter_tpu_torch.core.config import load_seg_config
    from weatherconverter_tpu_torch.data.labels import decode_target, encode_target
    from weatherconverter_tpu_torch.data.transforms import normalize
    from weatherconverter_tpu_torch.guidance.sgg import gradient_magnitude, seg_input_gradients
    from weatherconverter_tpu_torch.utils.images import to_uint8_image

    device = resolve_device(args.device)
    cfg = load_seg_config(args.config)
    t = cfg.data.transform
    hw = tuple(t.target_resolution)
    model = load_seg_model(cfg, args.checkpoint or cfg.model.path or None, seed=0).to(device)

    img = Image.open(args.image).convert("RGB").resize((hw[1], hw[0]), Image.BILINEAR)
    x = torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None]
    xn = normalize(x, tuple(t.mean), tuple(t.std)).to(device).permute(0, 3, 1, 2)
    with torch.no_grad(), autocast(device):
        pred = model(xn).argmax(dim=1)[0].cpu().numpy().astype(np.int32)
    os.makedirs(args.out, exist_ok=True)
    pred_color = decode_target(pred).astype(np.uint8)
    Image.fromarray(pred_color).save(os.path.join(args.out, "pred.png"))

    if args.label:
        lbl = Image.open(args.label).resize((hw[1], hw[0]), Image.NEAREST)
        enc = encode_target(np.asarray(lbl, np.uint8))
        gt = torch.from_numpy(enc.astype(np.int64))[None].to(device)
        with autocast(device):
            grads = seg_input_gradients(model, xn, gt)
        m = gradient_magnitude(grads)[0, 0].cpu().numpy()
        m = (m - m.min()) / max(m.max() - m.min(), 1e-12)
        mag = to_uint8_image(m, "unit")
        Image.fromarray(mag).save(os.path.join(args.out, "gradient_magnitude.png"))
        ids = np.where(enc == 255, 0, enc) * (255 // max(cfg.model.num_classes - 1, 1))
        panels = [np.asarray(img, np.uint8), to_uint8_image(x[0], "unit"), pred_color,
                  np.repeat(mag[..., None], 3, -1), np.repeat(ids.astype(np.uint8)[..., None], 3, -1),
                  decode_target(enc.astype(np.int32)).astype(np.uint8)]
        Image.fromarray(np.concatenate(panels, axis=1)).save(os.path.join(args.out, "panels.png"))
    print(f"saved outputs under {args.out}")
    return 0


def _discover_image_label_pairs(root: str) -> list:
    """Paired (image, labelIds) paths under `root`, in two layouts: (a) ACDC
    naming anywhere under the tree, `*_rgb_anon.*` beside `*_gt_labelIds.*`;
    (b) flat `rgb/` and `gt/` directories paired by basename stem. Sorted
    order alone never pairs: a mispaired label would corrupt the
    mIoU-consistency gate."""
    import glob
    import sys

    pairs = []
    for img in sorted(glob.glob(os.path.join(root, "**", "*_rgb_anon.*"), recursive=True)):
        label = img.replace("_rgb_anon", "_gt_labelIds")
        for cand in (label, label.replace(f"{os.sep}rgb_anon{os.sep}", f"{os.sep}gt{os.sep}")):
            if os.path.exists(cand) and cand != img:
                pairs.append((img, cand))
                break
    if pairs:
        return pairs
    rgb_dir, gt_dir = os.path.join(root, "rgb"), os.path.join(root, "gt")
    if not (os.path.isdir(rgb_dir) and os.path.isdir(gt_dir)):
        return []

    def images(d):
        return sorted(p for p in glob.glob(os.path.join(d, "*")) if p.lower().endswith((".png", ".jpg", ".jpeg")))

    def stem(p):
        return os.path.splitext(os.path.basename(p))[0]

    rgbs, gts = images(rgb_dir), images(gt_dir)
    if not rgbs:
        return []
    gt_by_stem = {stem(p): p for p in gts}
    by_stem = [(r, gt_by_stem[stem(r)]) for r in rgbs if stem(r) in gt_by_stem]
    if len(by_stem) == len(rgbs):
        return by_stem
    if by_stem and len(rgbs) != len(gts):
        print(f"quality: pairing {len(by_stem)}/{len(rgbs)} images by basename stem (unmatched files skipped)",
              file=sys.stderr)
        return by_stem
    if len(rgbs) == len(gts):
        raise SystemExit(f"--images: rgb/ and gt/ hold {len(rgbs)} files each but only {len(by_stem)} basename stems "
                         "match; refusing to pair by sorted order (a mispaired label silently corrupts the "
                         "mIoU-consistency gate). Name labels after their images.")
    return []


def quality_inputs(args, size: int, hr: int, num_classes: int) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(inputs (N, size, size, 3) in [-1, 1], labels (N, hr, hr) train ids,
    synthetic?): seeded random ones with --synthetic N (no --images), else the
    pairs under --images."""
    if args.images is None:
        g = torch.Generator().manual_seed(args.seed)
        inputs = torch.rand((args.synthetic, size, size, 3), generator=g) * 2.0 - 1.0
        return inputs, torch.randint(0, num_classes, (args.synthetic, hr, hr), generator=g), True
    from PIL import Image

    from weatherconverter_tpu_torch.data.labels import encode_target

    pairs = _discover_image_label_pairs(args.images)
    if not pairs:
        raise SystemExit(f"--images {args.images}: no pairs found. Expected either ACDC naming (*_rgb_anon.* with "
                         "matching *_gt_labelIds.*) anywhere under the directory, or rgb/ + gt/ subdirectories with "
                         "the same basenames.")
    imgs = [_load_image(img, size) * 2.0 - 1.0 for img, _ in pairs]
    lbls = [encode_target(np.asarray(Image.open(lbl).resize((hr, hr), Image.NEAREST), dtype=np.uint8))
            for _, lbl in pairs]
    print(f"quality: {len(pairs)} image/label pairs from {args.images}")
    return torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(lbls).astype(np.int64)), False


def load_inception(checkpoint: str):
    """InceptionV3 (pool3 features) from a torchvision-layout torch file."""
    from weatherconverter_tpu_torch.compat.from_jax import load_torchvision_inception
    from weatherconverter_tpu_torch.models.inception import InceptionV3

    return load_torchvision_inception(InceptionV3(), load_torch_checkpoint(checkpoint), classify=False)


def run_quality(args) -> int:
    """The translation quality gates (BASELINE.md north-star: throughput "at
    FID and mIoU-consistency parity"): translate the inputs batch by batch,
    then report the mIoU of seg(original) and of seg(translated) against the
    labels and their gap (metrics/quality.consistency_gap), and the FID
    between the original and the translated images (metrics/fid), on
    InceptionV3 pool3 features with --inception-checkpoint, else on the seg
    backbone's pooled features ("relative tracking only": not comparable to
    published FIDs). The SRGAN has seeded random weights, as in JAX."""
    import json

    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.diffusion.sampling import nchw, nhwc
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn
    from weatherconverter_tpu_torch.metrics.fid import fid_from_batches
    from weatherconverter_tpu_torch.metrics.quality import consistency_gap
    from weatherconverter_tpu_torch.models.inception import fid_input_resize
    from weatherconverter_tpu_torch.ops.image import resize_bilinear

    device = resolve_device(args.device)
    cfg = load_translation_config(args.config)
    size = cfg.diffusion.model.im_size
    hr = size * cfg.srgan.upscale_factor
    num_classes = cfg.seg.model.num_classes
    inputs, gts, synthetic = quality_inputs(args, size, hr, num_classes)
    unet, seg, sr, sched = build_translation(cfg, device, args.ddpm_checkpoint, args.seg_checkpoint, None,
                                             use_qk_int8(args, device), args.seed)
    translate = make_translate_fn(unet, sched, seg, sr, dtype=torch.bfloat16 if device.type == "cuda" else None,
                                  lam=args.lam, num_steps=args.steps, num_classes=num_classes, mode="fixed",
                                  guidance_style=args.guidance)
    originals_hr, translated, gt_batches = [], [], []
    for i in range(0, inputs.shape[0], args.batch):
        xb, gb = inputs[i:i + args.batch].to(device), gts[i:i + args.batch].to(device)
        translated.append(translate(xb, gb, torch.Generator(device=device).manual_seed(args.seed + i)))
        originals_hr.append(nhwc(resize_bilinear(nchw((xb + 1.0) / 2.0), (hr, hr))))
        gt_batches.append(gb)

    def seg_fn(x):
        with autocast(device):
            return seg(nchw(x))

    gap = consistency_gap(seg_fn, list(zip(originals_hr, gt_batches)), list(zip(translated, gt_batches)), num_classes)
    if args.inception_checkpoint:
        inception = load_inception(args.inception_checkpoint).to(device)

        def feature_fn(x):
            with autocast(device):
                return inception(fid_input_resize(nchw(x)))

        fid_kind = "inception_v3_pool3"
    else:
        def feature_fn(x):
            with autocast(device):
                return seg.backbone(nchw(x))["out"].float().mean(dim=(2, 3))

        fid_kind = "seg_backbone_pooled (relative tracking only)"
    fid = fid_from_batches(feature_fn, originals_hr, translated)
    report = {
        "data": f"synthetic (seeded random, n={inputs.shape[0]})" if synthetic else args.images,
        "weights": {"ddpm": args.ddpm_checkpoint or "random-init", "seg": args.seg_checkpoint or "random-init",
                    "srgan": "random-init"},
        "guidance": args.guidance,
        "steps": args.steps,
        "fid_kind": fid_kind,
        "fid_original_vs_translated": round(fid, 4),
        "miou_original": round(gap["original_miou"], 4),
        "miou_translated": round(gap["translated_miou"], 4),
        "miou_consistency_gap": round(gap["miou_consistency_gap"], 4),
    }
    print(json.dumps(report, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"saved {args.out}")
    return 0
