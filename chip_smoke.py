#!/usr/bin/env python3
"""Smoke run of the PyTorch port (weatherconverter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (exit code != 0, no result line):
  1. build the hand-written CUDA kernels from csrc/ with nvcc;
  2. hold each kernel (the flash forwards K1 and K2, the flash backward K3)
     against its plain PyTorch version at the four attention shapes of the
     production UNet at batch 8, in bf16, and time both; beside them, the
     least time the card could take (the roofline bound, and what binds it)
     and the time of torch's scaled_dot_product_attention, forward and
     backward alone, on the same inputs: a yardstick the port never calls;
     K2's quantizer must equal its plain version exactly (int8 tensors and
     scale), K2's time is split into quantizer and forward, and two K2 calls
     must agree bit for bit; K1 and K3 also at the 256 px UNet's (N, D) =
     (1024, 192), and one forward and backward of that UNet under bf16;
  3. run guided translation at full width -- the production 128px UNet,
     DeepLabV3+/ResNet-101 at output stride 16 with 19 classes, a 2x
     Swift-SRGAN, batch 8, bf16 autocast over f32 parameters, random weights
     from a seed -- in five variants: the headline (GSG every 2nd step at
     latent resolution, lam 120), the reference-exact schedule (GSG every step
     on the SRGAN upscale, lam 60), the headline with the int8-QK^T kernel
     (K2 and its quantizer 8 times a step), the alternate schedule (LCG on
     even steps, GSG on odd ones, every step on the SRGAN upscale, lam 60,
     four masked copies of the batch a seg call) and the same with
     lcg_present_k=8 on labels of at most 8 classes an image; each run must
     launch the kernels the expected number of times and give finite
     (8, 256, 256, 3) images in [0, 1];
  4. hold a short chain at batch 1 on the card (bf16, kernels) against the
     same chain on the CPU (f32, plain versions) with the same weights and
     the same noise, under GSG and under the alternate schedule;
  5. profile a few steps of each variant and print where the device time goes;
  6. train DDPM at full width -- the production 128px UNet, batch 8, bf16
     autocast over f32 parameters, Adam(1e-4), EMA 0.999, random weights from
     a seed, synthetic uint8 (128, 228, 3) images from a seed -- through
     training/loop_diffusion.train for TRAIN_STEPS steps (K1 and K3 must
     launch 8 times a step; the run writes a checkpoint, which must restore
     to the saved state), then time windows of the augmented train step on a
     fixed batch (finite losses that fall, parameters that move, an EMA that
     differs from them);
  7. hold one train step at batch 2 on the card (bf16, kernels) against the
     same step on the CPU (f32, plain versions): the same freshly seeded
     weights, the same t, noise, crop and flip;
  8. profile a few train steps;
  9. run the four H100 micro-probes (weatherconverter_tpu_torch/probes):
     hold each probe kernel (K4 the exp2 flash forward, K7 the raw int8 and
     bf16 QK^T, K6 the 3x3 depthwise conv, K5 the 81-FMA depthwise floor)
     against its plain version at the probe's full shapes, then run the
     probe (its comparison lines, CUDA-event times), whose launches of the
     kernel are counted;
 10. run the samplers at full width with phase 3's models, each with K1 and
     again with qk_int8 (K2 and its quantizer): ddpm_sample strided to 20 of
     1000 steps (throughput extrapolated to 1000), and the fast guided
     translations as the JAX bench runs them (GSG, lam 60, span 500),
     sample_with_sgg_ddim at 50 steps and sample_with_sgg_dpm at 20 (measured
     whole); each timed, profiled, its peak memory read, its kernels counted
     (8 launches a UNet forward) and its output checked (finite, (8, 128,
     128, 3) samples; (8, 256, 256, 3) translations in [0, 1]);
 11. hold 3-step DDIM and DPM guided chains at batch 1 on the card (bf16,
     kernels) against the CPU (f32, plain versions), same weights and draws;
 12. the int8 quality check (probes/int8_quality.py) at the fast samplers:
     K2 against K1 through the DPM chain at 20 steps and the DDIM chain at 50,
     batch 8, against a chaos floor of 5 perturbed runs, and two identical
     K1 runs; its verdict is printed, not gated.
The last line of standard output is {"ok": true, "device": {...}}; the line
before it lists the kernels with their launch counts, errors, times, bounds
and library times.
It has no CPU mode: without a CUDA card it exits with code 1.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, STEPS, REF_STEPS = 8, 20, 3
# the alternate variants' chains: i = 8, 6, 4, 2 take LCG, i = 9, 7, 5, 3, 1 GSG, i = 0 nothing
ALT_STEPS = 10
# every flash-length attention layer of the production UNet: two layers each
# at down 64x64 (N=4096, D=64), down 32x32 (N=1024, D=128), up 32x32
# (N=1024, D=32) and up 64x64 (N=4096, D=16)
FLASH_CALLS_PER_UNET = 8
PATH_SHAPES = [(BATCH, 4, 4096, 64), (BATCH, 4, 1024, 128), (BATCH, 4, 1024, 32), (BATCH, 4, 4096, 16)]
# the default ladder at im_size 256: its last down block and first mid block
# attend at N = 1024 on 768 channels. Checked and timed beside the path
# shapes, not summed with them (no run of this script's main paths goes there)
D192_SHAPE = (BATCH, 4, 1024, 192)
# bf16 outputs of attention over N(0,1) inputs are O(0.1-1): one bf16 ulp is
# <= 2^-8 there; kernel and plain version differ in f32 summation order and
# exp rounding, so some entries round to the neighbouring bf16 value
KERNEL_TOL = 1e-2
# and max |err| / max |ref| of the forwards K1 and K2 (K4: probes/micro_attn):
# at N = 4096 the outputs are about 0.03 and the absolute bound alone would
# pass an output that lacks a whole key tile (0.1 of max |O|); one bf16 ulp is
# at most 2^-7 of the value
KERNEL_REL_TOL = 1e-2
# K3 against its plain version: max |err| / max |ref| of dQ, dK and dV each,
# the bound JAX's own bf16 backward tests use (tests/test_ops.py:466-470)
BWD_REL_TOL = 2e-2
# bf16 on the card against f32 on the CPU through a 3-step chain with the
# full-width models: relative L2 error of the images
CHAIN_REL_TOL = 5e-2
# one train step, bf16 on the card against f32 on the CPU: relative error of
# the loss, and relative L2 error of the flattened UNet gradient
TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_TOL = 2e-2, 5e-2
REPEATS = 3
# training: steps through loop_diffusion.train (one epoch, one checkpoint),
# then WINDOWS timed windows of WINDOW_STEPS steps on one fixed batch
TRAIN_STEPS, WINDOWS, WINDOW_STEPS = 24, 3, 20
# phase 10: ddpm_sample's strided run, and the fast guided translations as the JAX bench runs them
# (bench.py:403-412: GSG, lam 60, the default span; DDIM at eta 0); profiled runs take PROFILE_STEPS steps
SAMPLE_STEPS, DDIM_STEPS, DPM_STEPS, PROFILE_STEPS = 20, 50, 20, 10
FAST_GUIDED = dict(lam=60.0, num_classes=19, guidance_style="gsg")
INT8_FLOOR_SEEDS = 5
HEADLINE = dict(guidance_every=2, guidance_space="latent", lam=120.0)
REFERENCE_EXACT = dict(guidance_every=1, guidance_space="sr", lam=60.0)
# the alternate schedule in its exact-semantics setting, and with the class sweep packed into 8 slots an image
ALTERNATE = dict(REFERENCE_EXACT, guidance_style="alternate", lcg_class_chunk=4)
ALTERNATE_PRESENT_K = dict(ALTERNATE, lcg_present_k=8)


_T0 = time.perf_counter()


def log(*args):
    if args and isinstance(args[0], str) and args[0].startswith("phase "):
        args = (f"{args[0]} (at {time.perf_counter() - _T0:.0f} s)",) + args[1:]
    print(*args, flush=True)


def _bound_text(bound) -> str:
    if bound["bound_ms"] is None:
        return "bound not known for this card"
    return f"bound {bound['bound_ms']:.4f} ms ({bound['binds']} binds)"


def _sdpa_ms(torch, q, k, v, do=None):
    """torch's scaled_dot_product_attention on the kernels' inputs: the
    forward, or with `do` the backward alone (autograd on a retained graph,
    the forward's time left out). It equals the clamped softmax where no
    |score| passes 60, which holds for these N(0,1) inputs. A yardstick:
    the port never calls it."""
    import torch.nn.functional as F

    from weatherconverter_tpu_torch.probes.common import time_ms

    if do is None:
        return time_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=20)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps=20)


def _forward_gate(torch, name, shape, out, ref):
    """max abs error of a forward kernel against its plain version; raises
    above KERNEL_TOL, above KERNEL_REL_TOL of max |ref|, or if not finite."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not (err <= KERNEL_TOL and rel <= KERNEL_REL_TOL and torch.isfinite(out.float()).all().item()):
        raise AssertionError(f"{name} {shape}: max abs err {err} > {KERNEL_TOL}, max|err|/max|ref| {rel} > "
                             f"{KERNEL_REL_TOL}, or not finite")
    return err, rel


def phase_kernels(torch, A, device, card):
    """Each forward kernel against its plain version at the path shapes, with
    its roofline bound and the library call's time; returns {name:
    dict(err, ms, plain_ms, library_ms, bound)} with sums over the shapes."""
    from weatherconverter_tpu_torch.probes.common import add_rooflines, attention_roofline, peaks, time_ms

    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, kernel, plain in (
        ("flash_attention", A.flash_attention, A.flash_attention_plain),
        ("flash_attention_qk_i8", A.flash_attention_qk_i8, A.flash_attention_qk_i8_plain),
    ):
        total, bounds = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0), []
        for shape in PATH_SHAPES + ([D192_SHAPE] if kernel is A.flash_attention else []):
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
            out = kernel(q, k, v)
            torch.cuda.synchronize()
            ref = plain(q, k, v)
            err, rel = _forward_gate(torch, name, shape, out, ref)
            k_ms = time_ms(lambda: kernel(q, k, v), reps=20)
            p_ms = time_ms(lambda: plain(q, k, v), reps=5)
            lib_ms = _sdpa_ms(torch, q, k, v)
            bound = attention_roofline(peaks(card), shape, qk_int8=kernel is A.flash_attention_qk_i8)
            b, h, n, d = shape
            tflops = 4 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
            log(f"  {name} B*H={b * h} N={n} D={d}: max_abs_err {err:.3e} (tol {KERNEL_TOL}), max|err|/max|ref| "
                f"{rel:.3e} (tol {KERNEL_REL_TOL}); "
                f"kernel {k_ms:.4f} ms ({tflops:.1f} TFLOP/s of QK^T+PV), plain {p_ms:.3f} ms, "
                f"{_bound_text(bound)}, sdpa forward {lib_ms:.4f} ms (yardstick, never called by the port)"
                + (" [the 256 px UNet's shape: not in the sums]" if shape == D192_SHAPE else ""))
            if shape == D192_SHAPE:
                continue
            bounds.append(bound)
            total = dict(err=max(total["err"], err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms,
                         library_ms=total["library_ms"] + lib_ms)
            del q, k, v, out, ref
        results[name] = dict(total, bound=add_rooflines(*bounds))
    return results


def phase_backward_kernel(torch, A, device, card):
    """K3 against its plain version at the path shapes, bf16, with its
    roofline bound and the library's backward alone; two calls must agree
    bit for bit. Returns dict(err, ms, plain_ms, library_ms, bound), sums
    over the shapes (err: the largest max abs error)."""
    from weatherconverter_tpu_torch.probes.common import add_rooflines, attention_roofline, peaks, time_ms

    gen = torch.Generator(device=device).manual_seed(10)
    total, bounds = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0), []
    for shape in PATH_SHAPES + [D192_SHAPE]:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        args = (q, k, v, o, do, l)
        got = A.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        again = A.flash_attention_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {shape}: two calls on the same inputs differ")
        ref = A.flash_attention_bwd_plain(*args)
        rel, abs_err = [], 0.0
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            diff = (g.float() - r.float()).abs().max().item()
            rel.append(diff / max(r.float().abs().max().item(), 1e-30))
            abs_err = max(abs_err, diff)
            if not (rel[-1] <= BWD_REL_TOL and torch.isfinite(g.float()).all().item()):
                raise AssertionError(f"flash_attention_bwd {shape} {name}: max|err|/max|ref| {rel[-1]} > "
                                     f"{BWD_REL_TOL} or not finite")
        del got, again, ref
        k_ms = time_ms(lambda: A.flash_attention_bwd(*args), reps=20)
        p_ms = time_ms(lambda: A.flash_attention_bwd_plain(*args), reps=3, warmup=1)
        lib_ms = _sdpa_ms(torch, q, k, v, do)
        bound = attention_roofline(peaks(card), shape, backward=True)
        b, h, n, d = shape
        tflops = 10 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
        log(f"  flash_attention_bwd B*H={b * h} N={n} D={d}: max|err|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {BWD_REL_TOL}), max abs err {abs_err:.3e}, two calls bit-equal; kernel "
            f"{k_ms:.4f} ms ({tflops:.1f} TFLOP/s of the five products a backward needs), plain {p_ms:.3f} ms, "
            f"{_bound_text(bound)}, sdpa backward alone {lib_ms:.4f} ms (yardstick, never called by the port)"
            + (" [the 256 px UNet's shape: not in the sums]" if shape == D192_SHAPE else ""))
        if shape != D192_SHAPE:
            bounds.append(bound)
            total = dict(err=max(total["err"], abs_err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms,
                         library_ms=total["library_ms"] + lib_ms)
        del q, k, v, do, o, l, args
        torch.cuda.empty_cache()
    return dict(total, bound=add_rooflines(*bounds))


def phase_quantizer(torch, A, device, card):
    """K2's quantizer against its plain version at the path shapes, bf16, in
    the layout the UNet hands it (q, k, v head-split views of one (B, N, 3C)
    projection, read in place) and on contiguous tensors: q8, k8 and the scale
    must be equal; K2 whole on the views within KERNEL_TOL of its plain
    version; its time in both layouts beside its bytes bound and the eager
    version's; K2's forward alone; two K2 calls bit-equal. Returns dict(err,
    ms, plain_ms, library_ms, bound), sums over the shapes in the UNet's
    layout (err: the largest difference of an int8 value or of the scale,
    which must be 0)."""
    from weatherconverter_tpu_torch.probes.common import add_rooflines, peaks, quantizer_roofline, time_ms

    gen = torch.Generator(device=device).manual_seed(20)
    total, bounds = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=None), []
    for shape in PATH_SHAPES:
        b, h, n, d = shape
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))  # as models/layers.py
        if q.is_contiguous() or A._row_strides(q) is None:
            raise AssertionError(f"quantize_qk_i8 {shape}: the head-split views are not read in place")
        ms = {}
        for layout, (ql, kl) in (("views", (q, k)), ("contiguous", (q.contiguous(), k.contiguous()))):
            got = A.quantize_qk_i8(ql, kl)
            torch.cuda.synchronize()
            ref = A.quantize_qk_i8_plain(ql, kl)
            err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
            if not all(g.is_contiguous() and torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"quantize_qk_i8 {shape} ({layout}): differs from its plain version (largest "
                                     f"difference {err})")
            ms[layout] = (time_ms(lambda: A.quantize_qk_i8(ql, kl), reps=20),
                          time_ms(lambda: A.quantize_qk_i8_plain(ql, kl), reps=20))
        out = A.flash_attention_qk_i8(q, k, v)
        if not torch.equal(out, A.flash_attention_qk_i8(q, k, v)):
            raise AssertionError(f"flash_attention_qk_i8 {shape}: two calls on the same inputs differ")
        k2_err, _ = _forward_gate(torch, "flash_attention_qk_i8 on head-split views", shape, out,
                                  A.flash_attention_qk_i8_plain(q, k, v))
        vc = v.contiguous()
        f_ms = time_ms(lambda: A.flash_qk_i8_forward(*got, vc), reps=20)
        bound = quantizer_roofline(peaks(card), shape)
        bounds.append(bound)
        (k_ms, p_ms), (kc_ms, pc_ms) = ms["views"], ms["contiguous"]
        log(f"  quantize_qk_i8 B*H={b * h} N={n} D={d}: q8, k8 and the scale equal the plain version's on head-split "
            f"views of one projection (the UNet's layout, read in place) and on contiguous tensors; K2 on the views "
            f"max_abs_err {k2_err:.3e} (tol {KERNEL_TOL}), two calls bit-equal; kernel {k_ms:.4f} ms on the views, "
            f"{kc_ms:.4f} ms contiguous (two launches and a two-float fill), its eager version {p_ms:.4f} / "
            f"{pc_ms:.4f} ms, {_bound_text(bound)}; K2's forward alone {f_ms:.4f} ms")
        total = dict(total, err=max(total["err"], err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms)
        del qkv, q, k, v, vc, got, ref, out
    return dict(total, bound=add_rooflines(*bounds))


def phase_unet_256(torch, A, device):
    """One forward and backward of the default ladder at im_size 256 (batch 1,
    random weights from a seed) under bf16 autocast: its twelve flash-length
    layers, four of them at D = 192, go through K1 and K3; in f32 the entry
    refuses it by name."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    model = Unet(UnetModelConfig(im_size=256)).to(device)
    shapes = [s for s in model.attention_shapes(256) if A.is_flash_length(s[0])]
    x = torch.randn((1, 3, 256, 256), generator=torch.Generator(device=device).manual_seed(7), device=device)
    try:
        model(x, 5)
    except ValueError as err:
        if "dtype=torch.bfloat16" not in str(err):
            raise
    else:
        raise AssertionError("an f32 flash-length UNet on CUDA was not refused at Unet.forward")
    A.flash_attention.launches = A.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    # no autotuning here: this model's conv shapes are run once (it would take half a minute)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False), \
            torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x, 5)
        out.square().mean().backward()
    torch.cuda.synchronize()
    counts = (A.flash_attention.launches, A.flash_attention_bwd.launches)
    grads_finite = all(p.grad is not None and torch.isfinite(p.grad).all().item() for p in model.parameters())
    if counts != (len(shapes),) * 2 or not (torch.isfinite(out).all().item() and grads_finite):
        raise AssertionError(f"256 px UNet: launches (K1, K3) {counts}, expected {len(shapes)} each; or a value "
                             "is not finite")
    log(f"  the default UNet at im_size 256, batch 1, bf16 autocast: forward and backward in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms (first call), K1 and K3 launched {counts[0]} times each at "
        f"(N, D) = {sorted(set(shapes))}; in f32 Unet.forward refuses it by name")


def build_models(torch):
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.models.factory import make_seg_model
    from weatherconverter_tpu_torch.models.srgan import Generator
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    unet = Unet(UnetModelConfig())
    seg = make_seg_model("deeplabv3plus_resnet101", num_classes=19, output_stride=16)
    gen = Generator(upscale_factor=2)
    return unet, seg, gen


def phase_slice(torch, A, device, models, card):
    """The five variants at full width. Warm-up runs first (cuDNN picks its
    algorithms), then REPEATS rounds that time each variant in turn, so drift
    on the shared host spreads over all alike. Peak memory is read per
    variant."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn
    from weatherconverter_tpu_torch.models.unet import Unet

    unet, seg, gen = (m.to(device) for m in models)
    unet_i8 = Unet(UnetModelConfig(), qk_int8=True).to(device)
    unet_i8.load_state_dict(unet.state_dict())
    sched = linear_schedule(1000, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    inp = torch.randn((BATCH, 128, 128, 3), generator=g, device=device) * 0.2
    gt = torch.randint(0, 19, (BATCH, 256, 256), generator=g, device=device)
    # labels of 8 classes an image, another eight for each image
    gt8 = (torch.randint(0, 8, (BATCH, 256, 256), generator=g, device=device)
           + 2 * torch.arange(BATCH, device=device)[:, None, None]) % 19
    calls, alt_calls = FLASH_CALLS_PER_UNET * STEPS, FLASH_CALLS_PER_UNET * ALT_STEPS
    variants = {}
    torch.cuda.reset_peak_memory_stats()
    for name, model, kw, labels, steps, expected in (  # launches of K1, K2 and K2's quantizer a run
        ("headline", unet, HEADLINE, gt, STEPS, (calls, 0, 0)),
        ("reference_exact", unet, REFERENCE_EXACT, gt, STEPS, (calls, 0, 0)),
        ("headline_qk_int8", unet_i8, HEADLINE, gt, STEPS, (0, calls, calls)),
        ("alternate", unet, ALTERNATE, gt, ALT_STEPS, (alt_calls, 0, 0)),
        ("alternate_present_k8", unet, ALTERNATE_PRESENT_K, gt8, ALT_STEPS, (alt_calls, 0, 0)),
    ):
        fn = make_translate_fn(model, sched, seg, gen, dtype=torch.bfloat16,
                               **{**dict(num_steps=steps, start_t=steps - 1, mode="fixed", guidance_style="gsg"), **kw})
        fn(inp, labels, torch.Generator(device=device).manual_seed(2))  # warm-up
        variants[name] = (fn, kw, labels, steps, expected, [])
    torch.cuda.synchronize()
    log(f"  peak device memory over the warm-up runs, in which cuDNN tries its algorithms: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches, peaks_gib = {}, {}
    for rep in range(REPEATS):
        for name, (fn, kw, labels, steps, expected, times) in variants.items():
            A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(inp, labels, torch.Generator(device=device).manual_seed(3 + rep))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
            peaks_gib[name] = max(peaks_gib.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            counts = launches[name] = (A.flash_attention.launches, A.flash_attention_qk_i8.launches,
                                       A.quantize_qk_i8.launches)
            if counts != expected:
                raise AssertionError(f"{name}: kernel launches (K1, K2, quantizer) = {counts}, expected {expected}")
            if out.shape != (BATCH, 256, 256, 3) or out.dtype != torch.float32:
                raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}")
            if not (torch.isfinite(out).all().item() and out.min().item() >= 0.0 and out.max().item() <= 1.0):
                raise AssertionError(f"{name}: output not finite or outside [0, 1]")
    for name, (fn, kw, labels, steps, expected, times) in variants.items():
        ms_step = statistics.median(times)
        style = kw.get("guidance_style", "gsg")
        if style == "alternate":
            style += (f" ({len(range(2, steps, 2))} of the {steps} steps take LCG, {len(range(1, steps, 2))} GSG; of "
                      f"1000, 499 and 500), lcg_class_chunk {kw['lcg_class_chunk']}, lcg_present_k "
                      f"{kw.get('lcg_present_k')}")
        log(f"  {name}: {ms_step:.2f} ms/step (median of {REPEATS} runs of {steps} steps: "
            f"{', '.join(f'{t:.2f}' for t in times)}) at batch {BATCH}, style {style}, guidance every "
            f"{kw['guidance_every']} in space {kw['guidance_space']}, lam {kw['lam']}; extrapolated to 1000 "
            f"steps {60.0 * BATCH / ms_step:.3f} translations/min [{card}]; launches per run "
            f"K1={launches[name][0]} K2={launches[name][1]} quantizer={launches[name][2]} (two kernels each), "
            f"that is {' / '.join(str(c // steps) for c in launches[name])} a step; peak device memory "
            f"{peaks_gib[name]:.2f} GiB")
    return launches, (unet, unet_i8, seg, gen, sched, inp, gt, gt8)


def phase_reference(torch, device, slice_state):
    """3-step 'sr' chains at batch 1, one under GSG and one under the
    alternate schedule (i = 2 fires LCG, i = 1 GSG): card (bf16 autocast,
    kernels) against CPU (f32, plain versions), same weights, same noise."""
    import copy

    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    unet, _, seg, gen, sched, inp, gt, _ = slice_state
    unet_c, seg_c, gen_c = (copy.deepcopy(m).to("cpu") for m in (unet, seg, gen))
    g = torch.Generator().manual_seed(4)
    noise = (torch.randn(1, 128, 128, 3, generator=g), torch.randn(REF_STEPS, 1, 128, 128, 3, generator=g))
    x1, gt1 = inp[:1], gt[:1]
    for style, extra in (("gsg", {}), ("alternate", dict(lcg_class_chunk=4))):
        kw = dict(num_steps=REF_STEPS, start_t=REF_STEPS - 1, mode="fixed", guidance_style=style,
                  guidance_every=1, guidance_space="sr", lam=60.0, **extra)
        card = make_translate_fn(unet, sched, seg, gen, dtype=torch.bfloat16, **kw)(
            x1, gt1, noise=tuple(n.to(device) for n in noise)).cpu()
        t0 = time.perf_counter()
        host = make_translate_fn(unet_c, linear_schedule(1000), seg_c, gen_c, **kw)(
            x1.cpu(), gt1.cpu(), noise=noise)
        rel = ((card - host).norm() / host.norm()).item()
        log(f"  card bf16 vs CPU f32, {REF_STEPS}-step '{style}' chain in space 'sr' at batch 1: relative L2 error "
            f"{rel:.3e} (tol {CHAIN_REL_TOL}); max abs {(card - host).abs().max().item():.3e}; "
            f"CPU run {time.perf_counter() - t0:.1f} s")
        if not rel <= CHAIN_REL_TOL:
            raise AssertionError(f"card and CPU '{style}' chains disagree: relative L2 error {rel}")


def phase_profile(torch, device, slice_state):
    """Device time by kernel over a 4-step chain of each GSG variant (two
    guided steps in the headline variants, three in the reference-exact one)
    and over an ALT_STEPS-step chain of the alternate ones (the timed runs'
    mix of LCG, GSG and unguided steps; device activity only, or reading the
    events of 60,000 launches and their host operators takes a minute).
    Phase 3 has warmed every shape up."""
    from torch.profiler import ProfilerActivity, profile

    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    unet, unet_i8, seg, gen, sched, inp, gt, gt8 = slice_state
    cuda = torch.autograd.DeviceType.CUDA
    per_step = {}
    for name, model, kw, labels in (("headline", unet, HEADLINE, gt), ("reference_exact", unet, REFERENCE_EXACT, gt),
                                    ("headline_qk_int8", unet_i8, HEADLINE, gt), ("alternate", unet, ALTERNATE, gt),
                                    ("alternate_present_k8", unet, ALTERNATE_PRESENT_K, gt8)):
        steps, activities = ((ALT_STEPS, [ProfilerActivity.CUDA]) if "lcg_class_chunk" in kw
                             else (4, [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        fn = make_translate_fn(model, sched, seg, gen, dtype=torch.bfloat16,
                               **{**dict(num_steps=steps, start_t=steps - 1, mode="fixed", guidance_style="gsg"), **kw})
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn(inp, labels, torch.Generator(device=device).manual_seed(6))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == cuda and getattr(e, "device_time_total", 0) > 0]
        total_us = sum(e.device_time_total for e in events)
        if total_us == 0:
            log(f"  {name}: the profiler saw no device time; device breakdown not measured")
            continue
        flash_us = sum(e.device_time_total for e in events if "wcflash" in e.key)
        quant_us = sum(e.device_time_total for e in events if "wcquant" in e.key)
        per_step[name] = sum(e.count for e in events) / steps
        log(f"  {name}, {steps} steps: wall {wall_ms:.1f} ms under the profiler, kernel time {total_us / 1e3:.1f} ms "
            f"({total_us / steps / 1e3:.1f} ms/step), device idle share ~{max(0.0, 1 - total_us / 1e3 / wall_ms):.2f}, "
            f"flash kernels {100 * flash_us / total_us:.1f}% of kernel time"
            + (f" and K2's quantizer {100 * quant_us / total_us:.1f}%" if quant_us else "")
            + f", {sum(e.count for e in events)} kernel launches ({per_step[name]:.0f} a step"
            + (f", the headline's {per_step['headline']:.0f}" if name != "headline" and "headline" in per_step else "")
            + ")")
        rows = sorted(events, key=lambda e: -e.device_time_total)
        # the headline's and the alternate schedule's largest kernels; of the int8 variant, K2's own (forward
        # and the quantizer's two passes)
        shown = {"headline": rows[:12], "headline_qk_int8": [e for e in rows if "qk" in e.key],
                 "alternate": rows[:8]}.get(name, [])
        for e in shown:
            log(f"    {e.device_time_total / 1e3:8.2f} ms {100 * e.device_time_total / total_us:5.1f}% "
                f"x{e.count:<5d} {e.key[:100]}")


class SyntheticImages:
    """uint8 (128, 228, 3) images from a seed: the shape DiffusionImageDataset
    yields at im_size 128 (data/datasets.py:101)."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        return np.random.default_rng((self.seed, i)).integers(0, 256, (128, 228, 3), dtype=np.uint8)


def _state_dicts_equal(torch, a, b, where=""):
    """Exact equality of two nested state dicts; raises on the first difference."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"restored checkpoint differs at {where}: keys")
        for key in a:
            _state_dicts_equal(torch, a[key], b[key], f"{where}/{key}")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"restored checkpoint differs at {where}")
    elif a != b:
        raise AssertionError(f"restored checkpoint differs at {where}: {a} != {b}")


def phase_train(torch, A, device, card, model_config):
    """loop_diffusion.train with `model_config` (main passes the production
    UnetModelConfig()), its checkpoint restored, then timed windows of the
    augmented train step on a fixed batch."""
    import tempfile

    from weatherconverter_tpu_torch.core.config import DiffusionConfig
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.training import loop_diffusion
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state

    with tempfile.TemporaryDirectory() as tmp:
        cfg = DiffusionConfig(
            model=model_config.model_dump(),
            training=dict(batch_size=BATCH, dtype="bfloat16", lr=1e-4, ema_decay=0.999, epochs=1, log_interval=1,
                          save_interval=1, num_workers=0, random_seed=0, device=device.type),
            folders=dict(output=tmp))
        A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        state = loop_diffusion.train(cfg, dataset=SyntheticImages(BATCH * TRAIN_STEPS))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.flash_attention_bwd.launches)
        expected = (FLASH_CALLS_PER_UNET * TRAIN_STEPS, 0, FLASH_CALLS_PER_UNET * TRAIN_STEPS)
        if launches != expected or state.step != TRAIN_STEPS:
            raise AssertionError(f"train loop: step {state.step}, launches (K1, K2, K3) {launches}, "
                                 f"expected step {TRAIN_STEPS} and {expected}")
        with open(os.path.join(tmp, "0", "metrics.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
        if len(losses) != TRAIN_STEPS or not all(l == l and abs(l) < float("inf") for l in losses):
            raise AssertionError(f"train loop: losses not finite or missing: {losses}")
        fresh = create_ddpm_state(Unet(cfg.model).to(device), lr=1e-4, ema_decay=0.999)
        loop_diffusion.ckpt_restore_into(os.path.join(tmp, "0", "checkpoints"), fresh)
        _state_dicts_equal(torch, state.state_dict(), fresh.state_dict())
        del fresh
    log(f"  loop_diffusion.train: {TRAIN_STEPS} steps at batch {BATCH} in {loop_s:.1f} s (first step "
        f"included), loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches K1={launches[0]} K3={launches[2]} "
        f"({FLASH_CALLS_PER_UNET} a step each); checkpoint restored equal to the saved state")

    sched = make_schedule("linear", 1000, device=device)
    step_fn = loop_diffusion.make_augmented_train_step(sched, 128, dtype=torch.bfloat16)
    batch = torch.stack([torch.from_numpy(SyntheticImages(BATCH, seed=1)[i]) for i in range(BATCH)]).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    start = [p.detach().clone() for p in state.model.parameters()]
    for _ in range(3):  # warm-up: cuDNN picks its algorithms
        step_fn(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, window_losses = [], []
    for w in range(WINDOWS):
        A.flash_attention.launches = A.flash_attention_bwd.launches = 0
        losses = []
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            _, loss = step_fn(state, batch, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / WINDOW_STEPS)
        window_losses += [l.item() for l in losses]
        counts = (A.flash_attention.launches, A.flash_attention_bwd.launches)
        if counts != (FLASH_CALLS_PER_UNET * WINDOW_STEPS,) * 2:
            raise AssertionError(f"train window {w}: launches (K1, K3) {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    first, last = statistics.mean(window_losses[:5]), statistics.mean(window_losses[-5:])
    moved = sum((p.detach() - s).abs().sum().item() for p, s in zip(state.model.parameters(), start))
    ema_gap = sum((e - p.detach()).abs().sum().item()
                  for e, p in zip(state.ema.params.values(), state.model.parameters()))
    if not all(l == l and abs(l) < float("inf") for l in window_losses):
        raise AssertionError("train windows: a loss is not finite")
    if not last < first:
        raise AssertionError(f"train windows: mean loss of the last 5 steps {last} is not below the first 5's {first}")
    if not (moved > 0 and ema_gap > 0):
        raise AssertionError(f"train windows: parameters moved {moved}, EMA - params {ema_gap}")
    ms = statistics.median(times)
    log(f"  train step (augment + fwd + bwd + Adam + EMA) at batch {BATCH}: {ms:.2f} ms/step (median of "
        f"{WINDOWS} windows of {WINDOW_STEPS} steps: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{1e3 * BATCH / ms:.1f} images/s per card [{card}]; peak device memory {peak:.2f} GiB; "
        f"fixed-batch loss first 5 steps {first:.4f} -> last 5 {last:.4f}; |params - start| {moved:.3e}, "
        f"|EMA - params| {ema_gap:.3e}; launches per window K1={counts[0]} K3={counts[1]}")
    return launches, state, sched, step_fn, batch


def phase_train_reference(torch, device, model_config):
    """One train step at batch 2, card (bf16 autocast, K1/K3) against CPU
    (f32, plain versions): the same weights, random from a seed, and the
    same t, noise, crop and flip. Freshly initialised weights keep the
    comparison the same from run to run: after the training phase the
    weights depend on cuDNN's algorithm choices, and as the loss falls the
    bf16 error of the gradient grows relative to the gradient itself."""
    import copy

    from weatherconverter_tpu_torch.data.transforms import diffusion_train_augment
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state, train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        reference_model = Unet(model_config)

    g = torch.Generator().manual_seed(11)
    images = torch.stack([torch.from_numpy(SyntheticImages(2, seed=3)[i]) for i in range(2)])
    offsets, flip = (torch.tensor([0, 0]), torch.tensor([37, 100])), torch.tensor([True, False])
    t, noise = torch.tensor([17, 640]), torch.randn((2, 128, 128, 3), generator=g)
    results = []
    for dev, dtype in ((device, torch.bfloat16), (torch.device("cpu"), None)):
        model = copy.deepcopy(reference_model).to(dev)
        st = create_ddpm_state(model, lr=1e-4)
        x = diffusion_train_augment(images.to(dev), crop=128, offsets=offsets, flip=flip.to(dev))
        t0 = time.perf_counter()
        _, loss = train_step(st, x, make_schedule("linear", 1000, device=dev), t=t.to(dev), noise=noise.to(dev),
                             dtype=dtype)
        grad = torch.cat([p.grad.float().flatten() for p in model.parameters()]).cpu()
        results.append((loss.item(), grad, time.perf_counter() - t0))
    (l_card, g_card, _), (l_cpu, g_cpu, cpu_s) = results
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
    log(f"  card bf16 vs CPU f32, one train step at batch 2: loss {l_card:.6f} vs {l_cpu:.6f}, relative error "
        f"{loss_rel:.3e} (tol {TRAIN_LOSS_REL_TOL}); UNet gradient relative L2 error {grad_rel:.3e} "
        f"(tol {TRAIN_GRAD_REL_TOL}); CPU step {cpu_s:.1f} s")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"card and CPU train steps disagree: loss {loss_rel}, gradient {grad_rel}")


def phase_train_profile(torch, train_state):
    """Device time by kernel over 3 train steps on the fixed batch."""
    from torch.profiler import ProfilerActivity, profile

    _, state, _, step_fn, batch = train_state
    steps = 3
    gen = torch.Generator(device=batch.device).manual_seed(4)
    step_fn(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and getattr(e, "device_time_total", 0) > 0]
    # the optimizer's record_function range shows up on the device as well,
    # spanning its own kernels: report it apart, never add it to the sum
    adam_us = sum(e.device_time_total for e in events if e.key.startswith("Optimizer."))
    events = [e for e in events if not e.key.startswith("Optimizer.")]
    total_us = sum(e.device_time_total for e in events)
    if total_us == 0:
        log("  the profiler saw no device time; device breakdown not measured")
        return
    bwd_us = sum(e.device_time_total for e in events if "flash_bwd" in e.key)
    fwd_us = sum(e.device_time_total for e in events if "flash_fwd" in e.key)
    log(f"  {steps} train steps: wall {wall_ms:.1f} ms under the profiler, kernel time {total_us / 1e3:.1f} ms "
        f"({total_us / steps / 1e3:.1f} ms/step), device idle share ~{max(0.0, 1 - total_us / 1e3 / wall_ms):.2f}, "
        f"K3 {100 * bwd_us / total_us:.1f}% and K1 {100 * fwd_us / total_us:.1f}% of kernel time, "
        f"{sum(e.count for e in events) / steps:.0f} kernel launches per step; the optimizer step's range "
        f"{adam_us / steps / 1e3:.2f} ms/step")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        log(f"    {e.device_time_total / 1e3:8.2f} ms {100 * e.device_time_total / total_us:5.1f}% "
            f"x{e.count:<5d} {e.key[:100]}")


def phase_probes(torch, device, card):
    """K4-K7 through their probes. Each kernel is first held against its
    plain version at the probe's full shapes (`check`; those launches are not
    counted); then the probe runs (`run`) with the kernel's launch counts set
    to 0 just before it and read just after. Returns {name: (max_abs_err,
    launches, the probe's timings)}."""
    from weatherconverter_tpu_torch.probes import micro_attn, probe_dw3x3, probe_dw9x9_floor, probe_int8_dot

    results = {}
    for name, probe, wrappers in (
        ("exp2_attention", micro_attn, (micro_attn.exp2_attention,)),
        ("qk_dot", probe_int8_dot, (probe_int8_dot.qk_dot_i8, probe_int8_dot.qk_dot_bf16)),
        ("dw3x3", probe_dw3x3, (probe_dw3x3.dw3x3,)),
        ("dw_fma81", probe_dw9x9_floor, (probe_dw9x9_floor.dw_fma81,)),
    ):
        log(f"  probes.{probe.__name__.rsplit('.', 1)[1]}:")
        err = probe.check(device)
        log(f"  {name}: kernel against its plain version at the probe's shapes, max abs err {err:.3e}")
        for w in wrappers:
            w.launches = 0
        timing = probe.run(device, card)
        launches = [w.launches for w in wrappers]
        if not all(launches):
            raise AssertionError(f"probe {name}: launches {launches}: a kernel was not launched")
        results[name] = (err, sum(launches), timing)
        torch.cuda.empty_cache()
    return results


def _device_profile(torch, fn, steps: int):
    """(wall ms, kernel ms, kernel launches) of one run of `fn` under the
    profiler, device activity only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and getattr(e, "device_time_total", 0) > 0]
    return wall_ms, sum(e.device_time_total for e in events) / 1e3, sum(e.count for e in events)


def phase_samplers(torch, A, device, models, card):
    """ddpm_sample, sample_with_sgg_ddim and sample_with_sgg_dpm at batch 8,
    each through K1 and through K2 with its quantizer: warm-up, then REPEATS
    rounds timing each in turn (host clock, ending in a synchronize), the
    kernels counted in every run, peak memory per run; then one profiled run
    of PROFILE_STEPS steps each for device time, idle share and launches."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg_ddim, sample_with_sgg_dpm
    from weatherconverter_tpu_torch.models.unet import Unet

    unet, seg, gen = (m.to(device).eval() for m in models)
    seg.requires_grad_(False)
    unet_i8 = Unet(UnetModelConfig(), qk_int8=True).to(device).eval()
    unet_i8.load_state_dict(unet.state_dict())
    sched = linear_schedule(1000, device=device)
    g = torch.Generator(device=device).manual_seed(21)
    inp = torch.randn((BATCH, 128, 128, 3), generator=g, device=device) * 0.2
    gt = torch.randint(0, 19, (BATCH, 256, 256), generator=g, device=device)

    def runner(kind, model, steps):
        if kind == "sample":
            return lambda gen_: ddpm_sample(model, sched, (BATCH, 128, 128, 3), gen_, num_steps=steps)
        chain = sample_with_sgg_ddim if kind == "ddim" else sample_with_sgg_dpm
        return lambda gen_: chain(model, sched, seg, gen, inp, gt, gen_, num_steps=steps, **FAST_GUIDED)

    paths = {}
    for kind, steps in (("sample", SAMPLE_STEPS), ("ddim", DDIM_STEPS), ("dpm", DPM_STEPS)):
        for int8, model in ((False, unet), (True, unet_i8)):
            calls = FLASH_CALLS_PER_UNET * steps
            paths[f"{kind}{'' if kind == 'sample' else steps}{'_qk_int8' if int8 else ''}"] = dict(
                kind=kind, model=model, steps=steps, run=runner(kind, model, steps), times=[], peak=0.0,
                expected=(0, calls, calls) if int8 else (calls, 0, 0))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        for p in paths.values():  # warm-up: cuDNN picks its algorithms
            p["run"](torch.Generator(device=device).manual_seed(29))
        torch.cuda.synchronize()
        for rep in range(REPEATS):
            for name, p in paths.items():
                A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = p["run"](torch.Generator(device=device).manual_seed(30 + rep))
                torch.cuda.synchronize()
                p["times"].append((time.perf_counter() - t0) * 1e3)
                p["peak"] = max(p["peak"], torch.cuda.max_memory_allocated() / 2**30)
                p["launches"] = (A.flash_attention.launches, A.flash_attention_qk_i8.launches,
                                 A.quantize_qk_i8.launches)
                if p["launches"] != p["expected"]:
                    raise AssertionError(f"{name}: kernel launches (K1, K2, quantizer) = {p['launches']}, expected "
                                         f"{p['expected']} ({FLASH_CALLS_PER_UNET} a UNet forward)")
                shape = (BATCH, 128, 128, 3) if p["kind"] == "sample" else (BATCH, 256, 256, 3)
                if tuple(out.shape) != shape or not torch.isfinite(out).all().item():
                    raise AssertionError(f"{name}: output {tuple(out.shape)}, expected {shape}, or not finite")
                if p["kind"] != "sample" and not (out.min().item() >= 0.0 and out.max().item() <= 1.0):
                    raise AssertionError(f"{name}: translation outside [0, 1]")
        for name, p in paths.items():
            short = runner(p["kind"], p["model"], PROFILE_STEPS)
            p["profile"] = _device_profile(torch, lambda: short(torch.Generator(device=device).manual_seed(40)),
                                           PROFILE_STEPS)
    for name, p in paths.items():
        run_ms = statistics.median(p["times"])
        ms_step = run_ms / p["steps"]
        if p["kind"] == "sample":
            metric = (f"unconditional_128px_1000step_samples_per_min_per_chip {60.0 * BATCH / ms_step:.3f} "
                      f"(extrapolated from ms/step: a step costs the same at any stride)")
        else:
            tag = "ddim" if p["kind"] == "ddim" else "dpm2m"
            metric = (f"guided_256px_{p['steps']}step_{tag}_translations_per_min_per_chip "
                      f"{60e3 * BATCH / run_ms:.3f} (measured, whole runs)")
        wall, kernel, count = p["profile"]
        log(f"  {name}: {ms_step:.2f} ms/step wall (median of {REPEATS} runs of {p['steps']} steps: "
            f"{', '.join(f'{t / p['steps']:.2f}' for t in p['times'])}); {metric} [{card}]; profiled "
            f"{PROFILE_STEPS}-step run: device {kernel / PROFILE_STEPS:.2f} ms/step, wall {wall / PROFILE_STEPS:.2f} "
            f"ms/step under the profiler, idle share ~{max(0.0, 1 - kernel / wall):.2f}, {count / PROFILE_STEPS:.0f} "
            f"launches a step; K1/K2/quantizer launches a run {'/'.join(map(str, p['launches']))} "
            f"({FLASH_CALLS_PER_UNET} a UNet forward); peak device memory {p['peak']:.2f} GiB")
    return (unet, unet_i8, seg, gen, sched, inp, gt)


def phase_fast_reference(torch, device, state):
    """3-step DDIM and DPM guided chains at batch 1 ('sr' guidance, GSG, lam
    60): card (bf16 autocast, kernels) against CPU (f32, plain versions),
    the same weights and draws."""
    import copy

    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg_ddim, sample_with_sgg_dpm

    unet, _, seg, gen, sched, inp, gt = state
    unet_c, seg_c, gen_c = (copy.deepcopy(m).to("cpu") for m in (unet, seg, gen))
    g = torch.Generator().manual_seed(24)
    n0, zs = torch.randn(1, 128, 128, 3, generator=g), torch.randn(REF_STEPS, 1, 128, 128, 3, generator=g)
    for name, chain, noise in (("ddim", sample_with_sgg_ddim, (n0, zs)), ("dpm", sample_with_sgg_dpm, n0)):
        kw = dict(num_steps=REF_STEPS, **FAST_GUIDED)
        on_card = noise.to(device) if name == "dpm" else tuple(n.to(device) for n in noise)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            card = chain(unet, sched, seg, gen, inp[:1], gt[:1], noise=on_card, **kw).cpu()
        t0 = time.perf_counter()
        host = chain(unet_c, linear_schedule(1000), seg_c, gen_c, inp[:1].cpu(), gt[:1].cpu(), noise=noise, **kw)
        rel = ((card - host).norm() / host.norm()).item()
        log(f"  card bf16 vs CPU f32, {REF_STEPS}-step guided {name} chain at batch 1: relative L2 error {rel:.3e} "
            f"(tol {CHAIN_REL_TOL}); max abs {(card - host).abs().max().item():.3e}; CPU run "
            f"{time.perf_counter() - t0:.1f} s")
        if not rel <= CHAIN_REL_TOL:
            raise AssertionError(f"card and CPU {name} chains disagree: relative L2 error {rel}")


def phase_int8_quality(torch, state, card):
    """probes/int8_quality at the fast samplers, on phase 10's models and
    inputs: DPM at 20 steps, DDIM at 50. Fails on a non-finite or misshapen
    output or a launch-count mismatch, never on the verdict."""
    from weatherconverter_tpu_torch.probes import int8_quality

    unet, unet_i8, seg, gen, sched, inp, gt = state
    for sampler, steps in (("dpm", DPM_STEPS), ("ddim", DDIM_STEPS)):
        t0 = time.perf_counter()
        artifact, outs = int8_quality.run((unet, unet_i8, seg, gen), sched, inp, gt, sampler, steps, INT8_FLOOR_SEEDS,
                                          torch.bfloat16, card)
        int8_quality.check_launches(outs, steps)
        int8_quality.report(artifact, log)
        log(f"  {len(outs)} chains in {time.perf_counter() - t0:.1f} s; wrote {int8_quality.save(artifact)}")


def _round(x):
    return None if x is None else round(x, 4)


PTXAS_KERNELS = ("flash_fwd_qk_i8_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                 "flash_fwd_wgmma_kernel", "absmax_qk_kernel", "quantize_qk_kernel",
                 "probe_exp2_attn_wgmma_kernel", "probe_qk_i8_kernel", "probe_qk_bf16_kernel", "probe_dw3x3_kernel",
                 "probe_dw_fma81_kernel")


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: its name, registers and spill bytes."""
    lines, name, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next((k for k in PTXAS_KERNELS if k in mangled), mangled)
            args = ["f16"] if "6__half" in mangled else ["bf16"] if "13__nv_bfloat16" in mangled else []
            dim = re.search(r"Li(\d+)E", mangled)
            if dim:
                args.append(f"D={dim.group(1)}")
            name += f"<{', '.join(args)}>" if args else ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split('Used ')[1].split(',')[0]}; {spill}")
            name = None
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a card and has no CPU mode",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from weatherconverter_tpu_torch.ops import attention as A
    from weatherconverter_tpu_torch.ops import cuda_build
    from weatherconverter_tpu_torch.probes.common import card_line

    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    log("settings: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False cudnn.benchmark=True; "
        "translation and training run under bf16 autocast")

    log("phase 1: build")
    t0 = time.perf_counter()
    cuda_build.library()
    ptxas = ptxas_summary(cuda_build.build_log())
    log(f"  built {', '.join(cuda_build.SOURCES)} in {time.perf_counter() - t0:.1f} s; ptxas, per kernel:")
    for ln in ptxas:
        log(f"    {ln}")
    # K1-K4, the wgmma kernels, must not spill; the log is that of the loaded library, also when an
    # earlier run built it
    wgmma = [ln for ln in ptxas if "wgmma_kernel" in ln]
    missing = [k for k in PTXAS_KERNELS if "wgmma_kernel" in k and not any(k in ln for ln in wgmma)]
    if missing:
        raise AssertionError(f"the build log does not name {missing}: the spill and wgmma gates have nothing to read")
    spilled = [ln for ln in wgmma if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    if spilled:
        raise AssertionError(f"ptxas reports register spills in K1-K4: {spilled}")
    if "Potential Performance Loss" in cuda_build.build_log():
        raise AssertionError("ptxas serialized the wgmma instructions of a kernel (see the build log): "
                             + next(ln for ln in cuda_build.build_log().splitlines() if "Potential" in ln))

    log(f"phase 2: kernels against their plain versions, bf16 [{card}]")
    kernel_results = phase_kernels(torch, A, device, card)
    kernel_results["quantize_qk_i8"] = phase_quantizer(torch, A, device, card)
    kernel_results["flash_attention_bwd"] = phase_backward_kernel(torch, A, device, card)
    phase_unet_256(torch, A, device)
    torch.cuda.empty_cache()

    log(f"phase 3: guided translation at full width [{card}]")
    models = build_models(torch)
    launches, slice_state = phase_slice(torch, A, device, models, card)

    log("phase 4: short chain, card against CPU")
    phase_reference(torch, device, slice_state)

    log(f"phase 5: profile [{card}]")
    phase_profile(torch, device, slice_state)
    del slice_state, models
    torch.cuda.empty_cache()

    log(f"phase 6: DDPM training at full width [{card}]")
    from weatherconverter_tpu_torch.core.config import UnetModelConfig

    train_state = phase_train(torch, A, device, card, UnetModelConfig())

    log("phase 7: one train step, card against CPU")
    phase_train_reference(torch, device, UnetModelConfig())

    log(f"phase 8: training profile [{card}]")
    phase_train_profile(torch, train_state)

    log(f"phase 9: the H100 micro-probes K4-K7 [{card}]")
    probes = phase_probes(torch, device, card)
    train_launches = train_state[0]
    del train_state
    torch.cuda.empty_cache()

    log(f"phase 10: the samplers at full width [{card}]")
    sampler_state = phase_samplers(torch, A, device, build_models(torch), card)

    log("phase 11: fast guided chains, card against CPU")
    phase_fast_reference(torch, device, sampler_state)

    log(f"phase 12: int8 quality at the fast samplers [{card}]")
    phase_int8_quality(torch, sampler_state, card)
    del sampler_state

    csrc = "weatherconverter_tpu_torch/csrc/"
    kernels = []
    for name, source, replaces, count in (
        ("flash_attention", csrc + "flash_fwd.cu", "weatherconverter_tpu/ops/attention.py:78",
         launches["headline"][0]),
        ("flash_attention_qk_i8", csrc + "flash_fwd_qk_i8.cu", "weatherconverter_tpu/ops/attention.py:125",
         launches["headline_qk_int8"][1]),
        ("quantize_qk_i8", csrc + "quantize_i8.cu",
         "weatherconverter_tpu/ops/attention.py:173-189 (plain jnp that XLA fused there, no Pallas kernel)",
         launches["headline_qk_int8"][2]),
        ("flash_attention_bwd", csrc + "flash_bwd.cu", "weatherconverter_tpu/ops/attention.py:305",
         train_launches[2]),
    ):
        r = kernel_results[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count, "max_abs_err": r["err"], "ms": round(r["ms"], 4),
                        "plain_ms": round(r["plain_ms"], 4), "bound_ms": _round(r["bound"]["bound_ms"]),
                        "bound_by": r["bound"]["bound_by"], "library_ms": _round(r["library_ms"])})
    for name, source, replaces in (
        ("exp2_attention", "probe_exp2_attn.cu", "scripts/micro_attn.py:43"),
        ("qk_dot", "probe_qk_dot.cu", "scripts/probe_int8_dot.py:24"),
        ("dw3x3", "probe_dw3x3.cu", "scripts/probe_dw3x3.py:36"),
        ("dw_fma81", "probe_dw9x9.cu", "scripts/probe_dw9x9_floor.py:40"),
    ):
        err, count, timing = probes[name]
        kernels.append({"name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
                        "launches": count, "max_abs_err": err, "ms": round(timing["ms"], 4),
                        "plain_ms": round(timing["plain_ms"], 4), "bound_ms": _round(timing["bound_ms"]),
                        "bound_by": timing["bound_by"], "library_ms": _round(timing["library_ms"])})
    log("kernels: for K1-K3 and K2's quantizer, ms, plain_ms, bound_ms and library_ms (scaled_dot_product_attention: "
        "its forward for K1 and K2, its backward alone for K3; none for the quantizer, whose plain_ms is the eager "
        "quantization it replaces and whose launches count calls of two kernels each) are sums over the four "
        "path shapes (K1's and K3's lines at (1024, 192) stand beside them in phase 2, not in the sums); K2's ms "
        "includes its quantizer's; launches are from "
        "the headline run (K1), the int8 run (K2, quantizer) and the loop_diffusion.train run (K3); for the probes K4-K7 "
        "they are from phase 9's probe runs (K4: sums over D=64 and D=16, library the same sdpa forward; "
        "qk_dot: int8 plus bf16, k_bf16 at scripts/probe_int8_dot.py:34, library torch._int_mm plus "
        "torch.mm(out_dtype=torch.float32), null if this torch lacks the latter; dw3x3: library cuDNN's channels-last "
        "depthwise conv; null where no single PyTorch call computes the function). bound_ms is the larger of "
        "bytes over 3.35 TB/s and operations over the peak of their type (989 TFLOP/s bf16, 1979 TOP/s int8, "
        "67 TFLOP/s f32, 3.86e12 exponentials/s)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
