"""Guided weather translation (port of weatherconverter_tpu/guidance/translate.py):
`sample_with_sgg` and `make_translate_fn` on the DDPM chain, with the
alternating LCG/GSG schedule, either operator alone, and the unguided chain;
the fast translations `sample_with_sgg_ddim` and `sample_with_sgg_dpm` on a
strided DDIM or DPM-Solver++(2M) subsequence.

The JAX scan becomes a Python loop over i = num_steps-1 .. 0; per step the
UNet's eps-prediction, the DDPM posterior and, when i != 0 and
i % guidance_every == 0, the guidance update (LCG on even i and GSG on odd i
under 'alternate'). Noise comes from a torch.Generator, or one a batch
row (`sampling.Generators`: row i draws what a batch-1 run under generator
i draws);
`noise=(noise0, z_steps)` replays given draws instead (the JAX key stream,
split as translate.py:171-177, 185, 189), so a test can hold the port
against the JAX chain step for step. The public layout is the JAX one:
NHWC images, (B, HR, HR) labels; the models run NCHW inside.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from weatherconverter_tpu_torch.core.precision import f32_arithmetic
from weatherconverter_tpu_torch.diffusion.sampling import (
    Generators,
    acp_prev,
    dpm_2m_update,
    draw_or_replay,
    nchw,
    nhwc,
    randint,
    step_noise,
    strided_taus,
)
from weatherconverter_tpu_torch.diffusion.schedule import (
    NoiseSchedule,
    posterior_mean,
    posterior_sigma,
    predict_x0,
    q_sample,
)
from weatherconverter_tpu_torch.guidance.sgg import apply_gsg, apply_lcg, present_class_ids
from weatherconverter_tpu_torch.ops import at_least_f32
from weatherconverter_tpu_torch.ops.attention import check_flash_precision
from weatherconverter_tpu_torch.ops.image import normalize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# The diffusion span the fast translations noise within by default, min(500, T):
# the original code's N = 500. Noising to T - 1 would leave almost nothing of the
# input, and the chain would generate from the labels rather than translate.
DEFAULT_TRANSLATE_SPAN = 500

# (x_t NCHW, t (B,)) -> eps; NCHW image -> NCHW logits; NCHW latent -> NCHW upscale
ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
SegFn = Callable[[torch.Tensor], torch.Tensor]
SRFn = Callable[[torch.Tensor], torch.Tensor]

_STYLES = ("alternate", "gsg", "lcg", "none")


def _guidance(seg_fn: SegFn, gt: torch.Tensor, lam: float, *, guidance_style: str, mode: str, num_classes: int,
              lcg_class_chunk: int, lcg_present_k: Optional[int], normalize_seg_input: bool, spatial=None):
    """The guided update of a chain step, shared by the three chains:
    guide(i, mean, scale, guide_in, z, noise_scale=None) applies LCG where
    the style is 'lcg', or 'alternate' and i is even, and GSG otherwise.
    Checks the style and finds the present classes (once: gt is fixed for
    the chain, and they are found on the whole of it). Under `spatial` (a
    parallel.spatial.SpatialContext) the update takes this rank's H rows of
    `guide_in` and of gt and runs inside the context."""
    if guidance_style not in _STYLES:
        raise ValueError(f"unknown guidance_style {guidance_style!r}")
    if normalize_seg_input:
        raw_seg_fn = seg_fn
        seg_fn = lambda x: raw_seg_fn(normalize(x, IMAGENET_MEAN, IMAGENET_STD))  # noqa: E731
    class_ids = None if lcg_present_k is None else present_class_ids(gt, lcg_present_k, num_classes)
    gt_guide = gt if spatial is None else spatial.own_rows(gt, 1)

    def update(i, mean, scale, guide_in, z, noise_scale):
        if guidance_style == "lcg" or (guidance_style == "alternate" and i % 2 == 0):
            return apply_lcg(seg_fn, mean, scale, guide_in, gt_guide, lam, num_classes=num_classes, noise=z,
                             mode=mode, class_chunk=lcg_class_chunk, noise_scale=noise_scale, class_ids=class_ids)
        return apply_gsg(seg_fn, mean, scale, guide_in, gt_guide, lam, noise=z, mode=mode, noise_scale=noise_scale)

    def guide(i, mean, scale, guide_in, z, noise_scale=None):
        if spatial is None:
            return update(i, mean, scale, guide_in, z, noise_scale)
        with spatial:
            return update(i, mean, scale, spatial.own_rows(guide_in, 2), z, noise_scale)

    return guide


def translate_entry(sched: NoiseSchedule, input_128: torch.Tensor, num_steps: int, generator: Generators = None,
                    start_t: Optional[int] = None, noise0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The guided chain's entry: t0 ~ U[0, num_steps) a row (or `start_t`),
    then input_128 (B, h, w, 3) q-sampled to t0 with a draw from the
    generator (or `noise0` replayed). Returns the noised latent, NHWC: what
    `sample_with_sgg` starts from, and a first segment's `xt_init`."""
    x_in = at_least_f32(nchw(input_128))
    b, device = x_in.shape[0], x_in.device
    if start_t is None:
        t0 = randint(num_steps, b, generator, device)
    else:
        t0 = torch.full((b,), start_t, dtype=torch.long, device=device)
    return nhwc(q_sample(sched, x_in, draw_or_replay(generator, x_in, noise0), t0))


def sample_with_sgg(
    diff_fn: ApplyFn,
    sched: NoiseSchedule,
    seg_fn: SegFn,
    sr_fn: SRFn,
    input_128: torch.Tensor,
    gt: torch.Tensor,
    generator: Generators = None,
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
    xt_init: Optional[torch.Tensor] = None,
    t_offset: Optional[int] = None,
    final_sr: bool = True,
    noise: Optional[tuple[Optional[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """input_128 (B, h, w, 3) in [-1, 1], gt (B, HR, HR) train-ids (255 ignored)
    -> the translated image upscaled, (B, HR, HR, 3) in [0, 1], or with
    `final_sr=False` the final latent (B, h, w, 3).

    `xt_init`, `t_offset` and `final_sr` cut the chain into segments that
    together are the single call bit for bit: a segment given `xt_init` (the
    latent, (B, h, w, 3), that the previous segment returned with
    `final_sr=False`, or `translate_entry`'s) skips the forward q-sample and
    runs timesteps t_offset + num_steps - 1 .. t_offset. The generator's
    state carries from one segment to the next; under `noise=` replay a
    segment takes its own slice of z_steps (noise0 is not read).

    `guidance_style` 'alternate' guides a fired step with LCG when i is even
    and with GSG when i is odd; 'gsg' and 'lcg' use that operator on every
    fired step; 'none' runs the plain ancestral chain. LCG sweeps
    `num_classes` classes, `lcg_class_chunk` masked copies of the batch a seg
    call; `lcg_present_k` packs the sweep into that many per-image slots
    holding the classes present in each image's gt (found once, before the
    loop), the same result bit for bit when K covers them. `guidance_space`
    'sr' differentiates the seg CE on the SRGAN upscale and pools the field
    back; 'latent' differentiates it on (x_t + 1) / 2 against
    gt[:, ::pool, ::pool] with lam / pool^2.

    `spatial_mesh` (parallel.spatial.make_spatial_mesh, every rank calling
    with the same arguments) shards the high-resolution half of each guided
    step in 'sr' space along image height: each rank runs the UNet, the
    posterior and the SRGAN on its 'data' rows of the batch, alike on every
    'space' rank, then the seg forward and input gradient on its H rows
    under parallel.spatial.SpatialContext, pools its rows of the field and
    gathers them. The result is the unsharded one, on every rank (the
    whole batch: the 'data' rows are gathered at the end). Over 'data' > 1
    each rank draws its rows: `generator` is then one generator a row, or
    `noise=` replays the global draws. In 'latent' space the mesh is
    accepted and the chain runs unsharded, as in JAX.

    `mode` 'fixed' keeps the guided x_t; 'reference' overwrites it with
    mu + sigma every step, as the original code does.
    `noise` = (noise0 (B, h, w, 3), z_steps (num_steps, B, h, w, 3)) replaces
    the generator's draws: noise0 for the forward q-sample, z_steps[s] for
    step s (i = num_steps - 1 - s).
    """
    if guidance_space not in ("sr", "latent"):
        raise ValueError(f"unknown guidance_space {guidance_space!r}")
    guide_latent = guidance_space == "latent"
    spatial = None
    if spatial_mesh is not None and not guide_latent:
        from weatherconverter_tpu_torch.parallel.spatial import SpatialContext, data_rows

        spatial = SpatialContext(spatial_mesh)
        spatial.check_guidance(gt.shape[1], gt.shape[1] // input_128.shape[1])
        rows = data_rows(spatial_mesh, input_128.shape[0])
        input_128, gt, xt_init = (None if a is None else a[rows] for a in (input_128, gt, xt_init))
        generator = _rows_of_generator(generator, rows)
        if noise is not None:
            noise = (None if noise[0] is None else noise[0][rows], noise[1][:, rows])

    x_in = at_least_f32(nchw(input_128))
    b, device = x_in.shape[0], x_in.device
    if guide_latent:
        pool = gt.shape[1] // x_in.shape[2]
        gt = gt[:, ::pool, ::pool] if pool > 1 else gt
        lam = lam / float(pool * pool)
    guide = _guidance(seg_fn, gt, lam, guidance_style=guidance_style, mode=mode, num_classes=num_classes,
                      lcg_class_chunk=lcg_class_chunk, lcg_present_k=lcg_present_k,
                      normalize_seg_input=normalize_seg_input, spatial=spatial)

    if xt_init is not None:
        xt = nchw(xt_init)
    else:
        xt = nchw(translate_entry(sched, input_128, num_steps, generator, start_t, None if noise is None else noise[0]))
    offset = 0 if t_offset is None else int(t_offset)

    with torch.no_grad():
        for s, i in enumerate(range(offset + num_steps - 1, offset - 1, -1)):
            eps = diff_fn(xt, torch.full((b,), i, dtype=torch.long, device=device))
            mu = posterior_mean(sched, xt, eps, i)
            sigma = posterior_sigma(sched, i)
            if mode == "reference":
                # the guided x_t is discarded: the original code overwrites it
                xt = mu + sigma
                continue
            z = step_noise(generator, xt, noise, s)
            if guidance_style != "none" and i != 0 and i % guidance_every == 0:
                xt = guide(i, mu, sigma, (xt + 1.0) * 0.5 if guide_latent else sr_fn(xt), z)
            else:
                xt = mu + sigma * z if i > 0 else mu
        out = sr_fn(xt) if final_sr else xt
    out = nhwc(out)
    return out if spatial is None else spatial.gather_data_rows(out)


def _rows_of_generator(generator: Generators, rows: slice):
    """A batch's generators cut to `rows`: one generator a row is cut; a
    single generator serves only a batch that is not cut."""
    if generator is None or isinstance(generator, torch.Generator):
        if generator is not None and rows != slice(None):
            raise ValueError("spatial_mesh with data > 1: a rank draws its rows, so pass one generator a row "
                             "(or noise=) in place of one generator for the batch")
        return generator
    return list(generator)[rows]


def _fast_start(sched: NoiseSchedule, input_128: torch.Tensor, span_t: Optional[int], num_steps: int,
                generator: Generators, noise0: Optional[torch.Tensor]):
    """The fast translations' start: the span (min(DEFAULT_TRANSLATE_SPAN, T)
    unless given), its strided taus, and the input q-sampled to span - 1."""
    span = min(DEFAULT_TRANSLATE_SPAN, sched.T) if span_t is None else span_t
    taus, tau_prev = strided_taus(span, num_steps)
    x_in = at_least_f32(nchw(input_128))
    return taus, tau_prev, q_sample(sched, x_in, draw_or_replay(generator, x_in, noise0), int(span) - 1)


def sample_with_sgg_ddim(
    diff_fn: ApplyFn,
    sched: NoiseSchedule,
    seg_fn: SegFn,
    sr_fn: SRFn,
    input_128: torch.Tensor,
    gt: torch.Tensor,
    generator: Generators = None,
    lam: float = 60.0,
    num_steps: int = 50,
    span_t: Optional[int] = None,
    eta: float = 0.0,
    num_classes: int = 19,
    mode: str = "fixed",
    lcg_class_chunk: int = 4,
    lcg_present_k: Optional[int] = None,
    normalize_seg_input: bool = False,
    guidance_style: str = "alternate",
    noise: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Fast guided translation on a strided DDIM subsequence: `num_steps`
    guided steps (10-50) in place of 500-1000, at the same cost a step.
    Inputs and output as `sample_with_sgg`'s.

    The input is q-sampled to span - 1 (`span_t`, default min(500, T): the
    DDPM translation's span; the full T is generation from the labels, not
    translation) and the taus stride the span. Per step the DDIM update
        mean = sqrt(acp_prev) x0_pred + sqrt(1 - acp_prev - sigma_ddim^2) eps
    takes the place of the posterior mean; the guidance term keeps the DDPM
    posterior std at t as its scale (lam * sigma_t * |grad|, the scale lam =
    60 was tuned for), and the added noise is sigma_ddim * z (eta scales
    sigma_ddim; at eta = 0 no step draws noise). Every step but the last is
    guided, in `guidance_style`'s schedule; 'none' and mode 'reference' (which
    has no fast analog in the original code) give the unguided chain.
    `noise` = (the q-sample's draw, z_steps (num_steps, B, h, w, 3)) replays
    the draws, in the JAX function's order."""
    guide = _guidance(seg_fn, gt, lam, guidance_style=guidance_style, mode=mode, num_classes=num_classes,
                      lcg_class_chunk=lcg_class_chunk, lcg_present_k=lcg_present_k,
                      normalize_seg_input=normalize_seg_input)
    guided = guidance_style != "none" and mode != "reference"
    taus, tau_prev, xt = _fast_start(sched, input_128, span_t, num_steps, generator,
                                     None if noise is None else noise[0])
    with torch.no_grad():
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            i = num_steps - 1 - s
            eps = diff_fn(xt, torch.full((xt.shape[0],), t, dtype=torch.long, device=xt.device))
            acp_t, acp_p = sched.alpha_cum_prod[t], acp_prev(sched, tp)
            x0 = predict_x0(sched, xt, eps, t).clamp(-1.0, 1.0)
            sigma_ddim = eta * torch.sqrt((1 - acp_p) / (1 - acp_t)) * torch.sqrt(torch.clamp_min(1 - acp_t / acp_p, 0.0))
            mean = torch.sqrt(acp_p) * x0 + torch.sqrt(torch.clamp_min(1.0 - acp_p - sigma_ddim**2, 0.0)) * eps
            z = step_noise(generator, xt, noise, s) if eta != 0 else None
            if guided and i != 0:
                xt = guide(i, mean, posterior_sigma(sched, t), sr_fn(xt), z, noise_scale=sigma_ddim)
            else:
                xt = mean + sigma_ddim * z if i > 0 and z is not None else mean
        out = sr_fn(xt)
    return nhwc(out)


def sample_with_sgg_dpm(
    diff_fn: ApplyFn,
    sched: NoiseSchedule,
    seg_fn: SegFn,
    sr_fn: SRFn,
    input_128: torch.Tensor,
    gt: torch.Tensor,
    generator: Generators = None,
    lam: float = 60.0,
    num_steps: int = 20,
    span_t: Optional[int] = None,
    num_classes: int = 19,
    mode: str = "fixed",
    lcg_class_chunk: int = 4,
    lcg_present_k: Optional[int] = None,
    normalize_seg_input: bool = False,
    guidance_style: str = "alternate",
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Guided fast translation on a DPM-Solver++(2M) subsequence
    (`diffusion/sampling.dpm_2m_update`): `sample_with_sgg_ddim`'s structure
    with the solver's update as the mean, second order where DDIM is first
    (10-25 steps where DDIM wants 25-50). The solver adds no noise: the
    guidance operators get a noise scale of exactly 0 and no noise tensor.
    The first step is first order, as is the terminal one. `noise` (B, h, w,
    3) replays the q-sample's draw, the only one the chain makes."""
    guide = _guidance(seg_fn, gt, lam, guidance_style=guidance_style, mode=mode, num_classes=num_classes,
                      lcg_class_chunk=lcg_class_chunk, lcg_present_k=lcg_present_k,
                      normalize_seg_input=normalize_seg_input)
    guided = guidance_style != "none" and mode != "reference"
    taus, tau_prev, xt = _fast_start(sched, input_128, span_t, num_steps, generator, noise)
    with torch.no_grad():
        x0_prev, h_prev, zero = torch.zeros_like(xt), xt.new_ones(()), xt.new_zeros(())
        for s, (t, tp) in enumerate(zip(taus, tau_prev)):
            i = num_steps - 1 - s
            eps = diff_fn(xt, torch.full((xt.shape[0],), t, dtype=torch.long, device=xt.device))
            x0 = predict_x0(sched, xt, eps, t).clamp(-1.0, 1.0)
            mean, h_prev = dpm_2m_update(sched, xt, x0, x0_prev, h_prev, t, tp, i != num_steps - 1 and tp >= 0)
            x0_prev = x0
            xt = guide(i, mean, posterior_sigma(sched, t), sr_fn(xt), None, noise_scale=zero) if guided and i != 0 \
                else mean
        out = sr_fn(xt)
    return nhwc(out)


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
    noise=None, **segment) -> sample_with_sgg(..., **kwargs, **segment);
    `segment` overrides kwargs for one call (a chain cut into segments
    passes xt_init, t_offset, num_steps and final_sr).

    The models go to eval mode and the seg model's parameters are frozen
    (requires_grad False), so the guidance gradient is taken with respect to
    the image alone. `dtype` (e.g. torch.bfloat16) runs the models under
    autocast: parameters stay f32 and are cast at use; None runs them in
    their own dtype, f32 as JAX's inference commands do, and on CUDA in f32
    arithmetic (`core/precision.f32_arithmetic`: no TF32), where a `qk_int8`
    UNet takes K2-f32 and another K1-f32. A CUDA UNet with a flash-length
    attention layer that would so run in a dtype or at a head dim the
    kernels do not take is refused here, by name.
    """
    for m in (diff_model, seg_model, sr_model):
        m.eval()
    seg_model.requires_grad_(False)
    if hasattr(diff_model, "attention_kernels"):
        param = next(diff_model.parameters())
        check_flash_precision(param.device.type, param.dtype if dtype is None else dtype,
                              diff_model.attention_kernels(diff_model.config.im_size), "make_translate_fn")

    def translate(input_128, gt, generator=None, noise=None, **segment):
        ctx = (torch.autocast(input_128.device.type, dtype=dtype) if dtype is not None
               else f32_arithmetic(input_128.device))
        with ctx:
            return sample_with_sgg(
                diff_model, sched, seg_model, sr_model, input_128, gt, generator, noise=noise,
                **{**kwargs, **segment}
            )

    return translate


def translate_across_ranks(translate, mesh, input_128: torch.Tensor, gt: torch.Tensor,
                           noise: tuple[Optional[torch.Tensor], torch.Tensor], start_t: int, **segment) -> torch.Tensor:
    """The guided translation of a global batch over the data ranks of `mesh`
    (the counterpart of JAX's sample_with_sgg over a ('data',) mesh): each rank
    runs `translate` (make_translate_fn's) on its rows [r * b, (r + 1) * b)
    of `input_128` and `gt`, with its rows of the replayed GLOBAL draws
    `noise` = (noise0, z_steps) and the entry step `start_t` (a draw of t0
    would be each rank's own), and the gathered images, the single-process
    translation of the batch, are returned on every rank. Rows do not mix:
    the guidance is a per-image mean, the models run in eval mode."""
    from weatherconverter_tpu_torch.parallel.distributed import global_batch_from_local
    from weatherconverter_tpu_torch.parallel.sharding import local_batch_slice, mesh_rank

    b = local_batch_slice(input_128.shape[0], mesh)
    rows = slice(mesh_rank(mesh) * b, (mesh_rank(mesh) + 1) * b)
    noise0, z_steps = noise
    out = translate(input_128[rows], gt[rows], noise=(None if noise0 is None else noise0[rows], z_steps[:, rows]),
                    start_t=start_t, **segment)
    return global_batch_from_local(mesh, out)
