"""Guided weather translation (port of `sample_with_sgg` and
`make_translate_fn` from weatherconverter_tpu/guidance/translate.py): the
alternating LCG/GSG schedule, either operator alone, and the unguided chain.

The JAX scan becomes a Python loop over i = num_steps-1 .. 0; per step the
UNet's eps-prediction, the DDPM posterior and, when i != 0 and
i % guidance_every == 0, the guidance update (LCG on even i and GSG on odd i
under 'alternate'). Noise comes from a torch.Generator;
`noise=(noise0, z_steps)` replays given draws instead (the JAX key stream,
split as translate.py:171-177, 185, 189), so a test can hold the port
against the JAX chain step for step. The public layout is the JAX one:
NHWC images, (B, HR, HR) labels; the models run NCHW inside.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    posterior_mean,
    posterior_sigma,
    q_sample,
)
from weatherconverter_tpu_torch.guidance.sgg import apply_gsg, apply_lcg, present_class_ids
from weatherconverter_tpu_torch.ops.attention import check_flash_precision
from weatherconverter_tpu_torch.ops.image import normalize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (x_t NCHW, t (B,)) -> eps; NCHW image -> NCHW logits; NCHW latent -> NCHW upscale
ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
SegFn = Callable[[torch.Tensor], torch.Tensor]
SRFn = Callable[[torch.Tensor], torch.Tensor]

_STYLES = ("alternate", "gsg", "lcg", "none")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def sample_with_sgg(
    diff_fn: ApplyFn,
    sched: NoiseSchedule,
    seg_fn: SegFn,
    sr_fn: SRFn,
    input_128: torch.Tensor,
    gt: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    lam: float = 60.0,
    num_steps: int = 500,
    num_classes: int = 19,
    mode: str = "fixed",
    lcg_class_chunk: int = 4,
    lcg_present_k: Optional[int] = None,
    start_t: Optional[int] = None,
    normalize_seg_input: bool = False,
    guidance_every: int = 1,
    guidance_style: str = "alternate",
    guidance_space: str = "sr",
    spatial_mesh=None,
    final_sr: bool = True,
    noise: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """input_128 (B, h, w, 3) in [-1, 1], gt (B, HR, HR) train-ids (255 ignored)
    -> the translated image upscaled, (B, HR, HR, 3) in [0, 1], or with
    `final_sr=False` the final latent (B, h, w, 3).

    `guidance_style` 'alternate' guides a fired step with LCG when i is even
    and with GSG when i is odd; 'gsg' and 'lcg' use that operator on every
    fired step; 'none' runs the plain ancestral chain. LCG sweeps
    `num_classes` classes, `lcg_class_chunk` masked copies of the batch a seg
    call; `lcg_present_k` packs the sweep into that many per-image slots
    holding the classes present in each image's gt (found once, before the
    loop), the same result bit for bit when K covers them. `spatial_mesh` is
    not ported yet and raises. `guidance_space` 'sr'
    differentiates the seg CE on the SRGAN upscale and pools the field back;
    'latent' differentiates it on (x_t + 1) / 2 against gt[:, ::pool, ::pool]
    with lam / pool^2. `mode` 'fixed' keeps the guided x_t; 'reference'
    overwrites it with mu + sigma every step, as the original code does.
    `noise` = (noise0 (B, h, w, 3), z_steps (num_steps, B, h, w, 3)) replaces
    the generator's draws: noise0 for the forward q-sample, z_steps[s] for
    step s (i = num_steps - 1 - s).
    """
    if guidance_style not in _STYLES:
        raise ValueError(f"unknown guidance_style {guidance_style!r}")
    if spatial_mesh is not None:
        raise NotImplementedError("spatial_mesh: spatial sharding is ROADMAP Queue 1 item 17")
    if guidance_space not in ("sr", "latent"):
        raise ValueError(f"unknown guidance_space {guidance_space!r}")
    if normalize_seg_input:
        raw_seg_fn = seg_fn
        seg_fn = lambda x: raw_seg_fn(normalize(x, IMAGENET_MEAN, IMAGENET_STD))  # noqa: E731

    x_in = _nchw(input_128).float()
    b, device = x_in.shape[0], x_in.device
    guide_latent = guidance_space == "latent"
    if guide_latent:
        pool = gt.shape[1] // x_in.shape[2]
        gt_guide = gt[:, ::pool, ::pool] if pool > 1 else gt
        lam = lam / float(pool * pool)
    else:
        gt_guide = gt
    lcg_class_ids = None if lcg_present_k is None else present_class_ids(gt_guide, lcg_present_k, num_classes)

    def draw(like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=generator, device=device, dtype=like.dtype)

    if start_t is None:
        t0 = torch.randint(0, num_steps, (b,), generator=generator, device=device)
    else:
        t0 = torch.full((b,), start_t, dtype=torch.long, device=device)
    noise0 = draw(x_in) if noise is None else _nchw(noise[0]).to(device, torch.float32)
    xt = q_sample(sched, x_in, noise0, t0)

    with torch.no_grad():
        for s, i in enumerate(range(num_steps - 1, -1, -1)):
            eps = diff_fn(xt, torch.full((b,), i, dtype=torch.long, device=device))
            mu = posterior_mean(sched, xt, eps, i)
            sigma = posterior_sigma(sched, i)
            if mode == "reference":
                # the guided x_t is discarded: the original code overwrites it
                xt = mu + sigma
                continue
            z = draw(xt) if noise is None else _nchw(noise[1][s]).to(device, torch.float32)
            if guidance_style != "none" and i != 0 and i % guidance_every == 0:
                guide_in = (xt + 1.0) * 0.5 if guide_latent else sr_fn(xt)
                if guidance_style == "lcg" or (guidance_style == "alternate" and i % 2 == 0):
                    xt = apply_lcg(seg_fn, mu, sigma, guide_in, gt_guide, lam, num_classes=num_classes, noise=z,
                                   mode=mode, class_chunk=lcg_class_chunk, class_ids=lcg_class_ids)
                else:
                    xt = apply_gsg(seg_fn, mu, sigma, guide_in, gt_guide, lam, noise=z, mode=mode)
            else:
                xt = mu + sigma * z if i > 0 else mu
        out = sr_fn(xt) if final_sr else xt
    return _nhwc(out)


def make_translate_fn(
    diff_model: nn.Module,
    sched: NoiseSchedule,
    seg_model: nn.Module,
    sr_model: nn.Module,
    *,
    dtype: Optional[torch.dtype] = None,
    **kwargs,
):
    """Bind the three models into translate(input_128, gt, generator=None,
    noise=None) -> sample_with_sgg(..., **kwargs).

    The models go to eval mode and the seg model's parameters are frozen
    (requires_grad False), so the guidance gradient is taken with respect to
    the image alone. `dtype` (e.g. torch.bfloat16) runs the models under
    autocast: parameters stay f32 and are cast at use; None runs them in
    their own dtype. A CUDA UNet with a flash-length attention layer that
    would so run in f32 is refused here, by name (the kernels take bf16/f16).
    """
    for m in (diff_model, seg_model, sr_model):
        m.eval()
    seg_model.requires_grad_(False)
    if hasattr(diff_model, "attention_shapes"):
        param = next(diff_model.parameters())
        check_flash_precision(param.device.type, param.dtype if dtype is None else dtype,
                              diff_model.attention_shapes(diff_model.config.im_size), "make_translate_fn")

    def translate(input_128, gt, generator=None, noise=None):
        ctx = (torch.autocast(input_128.device.type, dtype=dtype) if dtype is not None
               else contextlib.nullcontext())
        with ctx:
            return sample_with_sgg(
                diff_model, sched, seg_model, sr_model, input_128, gt, generator, noise=noise, **kwargs
            )

    return translate
