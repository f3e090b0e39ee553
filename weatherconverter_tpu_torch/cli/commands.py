"""The CLI's subcommands and the checkpoint loaders (port of
weatherconverter_tpu/cli/commands.py): sample, translate, super-resolve,
infer-seg, train-ddpm and train-seg, on the CUDA card unless `--device cpu`
asks for the CPU.

Checkpoints: a reference torch file (.pt, .pth, .ckpt, .tar; its
`model_state_dict` / `state_dict` / `model` entry when wrapped) loads with
`strict=True`, since the port keeps the reference's parameter names; a JAX
.npz goes through `compat/from_jax.py`; a training-run directory of this
package through `core/checkpoint.restore_auto`, the EMA preferred and a seg
run's best "Mean IoU" step taken; None gives
random weights from the seed. An Orbax directory of the JAX package is
refused by name: the port has no Orbax.

int8 attention: on the card the inference commands build the UNet with
`qk_int8=True` (K2, the int8 Q K^T flash forward, and its quantizer), as the
JAX CLI defaults to its int8 kernel on the TPU; `--no-int8-attn` keeps K1.
The quality check (`probes/int8_quality.py`) passed K2 at 20, 50 and 1000
steps on the H100 (PERF.md section 6). The CPU has no int8 path, and
training never takes K2 (it has no backward).
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


def load_unet(model_cfg, checkpoint: str | None, seed: int, qk_int8: bool = False):
    """The DDPM UNet (counterpart of `_load_unet_params`)."""
    from weatherconverter_tpu_torch.compat.from_jax import unet_state_dict
    from weatherconverter_tpu_torch.models.unet import Unet

    with seeded(seed):
        model = Unet(model_cfg, qk_int8=qk_int8)
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
    """Unconditional sampling (ddpm, ddim, dpm) into a PNG grid."""
    from weatherconverter_tpu_torch.core.config import load_diffusion_config
    from weatherconverter_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample, dpm_solver_pp_2m_sample
    from weatherconverter_tpu_torch.utils.images import save_images

    if args.sampler == "legacy":
        raise SystemExit("--sampler legacy needs the legacy UNet, which is not ported yet (ROADMAP Queue 1 item 15)")
    device = resolve_device(args.device)
    cfg = load_diffusion_config(args.config)
    unet = load_unet(cfg.model, args.checkpoint, args.seed, use_qk_int8(args, device)).to(device).eval()
    sched = make_schedule_from(cfg.diffusion, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (args.batch, cfg.model.im_size, cfg.model.im_size, cfg.model.im_channels)
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


def build_translation(cfg, device, unet_ckpt, seg_ckpt, srgan_ckpt, qk_int8: bool, seed: int):
    """The three models of a translation on `device` (the seg model frozen)
    and the schedule."""
    unet = load_unet(cfg.diffusion.model, unet_ckpt, seed, qk_int8).to(device).eval()
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

    if getattr(args, "debug_dir", None):
        raise SystemExit("--debug-dir is not ported yet (it needs utils/debug.py, ROADMAP Queue 1 item 19)")
    device = resolve_device(args.device)
    cfg = load_translation_config(args.config)
    sampler = args.sampler
    if args.steps is None:
        # the fast samplers exist for few-step translation: 500 would defeat them
        args.steps = {"ddim": 50, "dpm": 20}.get(sampler, 500)
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
    out = translate(x, g, torch.Generator(device=device).manual_seed(args.seed))
    save_images(out, args.out, nrow=1, from_range="unit")
    print(f"saved {args.out}")
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
