#!/usr/bin/env python3
"""Smoke run of the PyTorch port (weatherconverter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (exit code != 0, no result line):
  1. build the hand-written CUDA kernels from csrc/ with nvcc;
  2. hold each kernel (the flash forwards K1 and K2, the flash backward K3)
     against its plain PyTorch version at the four attention shapes of the
     production UNet at batch 8, in bf16, and time both;
  3. run guided translation (GSG) at full width -- the production 128px UNet,
     DeepLabV3+/ResNet-101 at output stride 16 with 19 classes, a 2x
     Swift-SRGAN, batch 8, bf16 autocast over f32 parameters, random weights
     from a seed -- in three variants: the headline (guidance every 2nd step
     at latent resolution, lam 120), the reference-exact schedule (every step
     on the SRGAN upscale, lam 60) and the headline with the int8-QK^T
     kernel; each run must launch the kernels the expected number of times
     and give finite (8, 256, 256, 3) images in [0, 1];
  4. hold a short chain at batch 1 on the card (bf16, kernels) against the
     same chain on the CPU (f32, plain versions) with the same weights and
     the same noise;
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
  8. profile a few train steps.
The last line of standard output is {"ok": true, "device": {...}}; the line
before it lists the kernels with their launch counts, errors and times.
It has no CPU mode: without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, STEPS, REF_STEPS = 8, 20, 3
# every flash-length attention layer of the production UNet: two layers each
# at down 64x64 (N=4096, D=64), down 32x32 (N=1024, D=128), up 32x32
# (N=1024, D=32) and up 64x64 (N=4096, D=16)
FLASH_CALLS_PER_UNET = 8
PATH_SHAPES = [(BATCH, 4, 4096, 64), (BATCH, 4, 1024, 128), (BATCH, 4, 1024, 32), (BATCH, 4, 4096, 16)]
# bf16 outputs of attention over N(0,1) inputs are O(0.1-1): one bf16 ulp is
# <= 2^-8 there; kernel and plain version differ in f32 summation order and
# exp rounding, so some entries round to the neighbouring bf16 value
KERNEL_TOL = 1e-2
# K3 against its plain version: max |err| / max |ref| of dQ, dK and dV each,
# the bound JAX's own bf16 backward tests use (tests/test_ops.py:466-470)
BWD_REL_TOL = 2e-2
# bf16 on the card against f32 on the CPU through a 3-step chain with the
# full-width models: relative L2 error of the images
CHAIN_REL_TOL = 5e-2
# one train step, bf16 on the card against f32 on the CPU: relative error of
# the loss, and relative L2 error of the flattened UNet gradient
TRAIN_LOSS_REL_TOL, TRAIN_GRAD_REL_TOL = 2e-2, 5e-2
REPEATS = 5
# training: steps through loop_diffusion.train (one epoch, one checkpoint),
# then WINDOWS timed windows of WINDOW_STEPS steps on one fixed batch
TRAIN_STEPS, WINDOWS, WINDOW_STEPS = 24, 5, 20
HEADLINE = dict(guidance_every=2, guidance_space="latent", lam=120.0)
REFERENCE_EXACT = dict(guidance_every=1, guidance_space="sr", lam=60.0)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, A, device):
    """Each forward kernel against its plain version at the path shapes;
    returns {name: (max_abs_err, kernel_ms_sum, plain_ms_sum)}."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, kernel, plain in (
        ("flash_attention", A.flash_attention, A.flash_attention_plain),
        ("flash_attention_qk_i8", A.flash_attention_qk_i8, A.flash_attention_qk_i8_plain),
    ):
        worst, k_total, p_total = 0.0, 0.0, 0.0
        for shape in PATH_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
            out = kernel(q, k, v)
            torch.cuda.synchronize()
            ref = plain(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= KERNEL_TOL and torch.isfinite(out.float()).all().item()):
                raise AssertionError(f"{name} {shape}: max abs err {err} > {KERNEL_TOL} or not finite")
            k_ms = time_ms(torch, lambda: kernel(q, k, v), reps=20)
            p_ms = time_ms(torch, lambda: plain(q, k, v), reps=5)
            b, h, n, d = shape
            tflops = 4 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
            log(f"  {name} B*H={b * h} N={n} D={d}: max_abs_err {err:.3e} (tol {KERNEL_TOL}); "
                f"kernel {k_ms:.3f} ms ({tflops:.1f} TFLOP/s of QK^T+PV), plain {p_ms:.3f} ms")
            worst, k_total, p_total = max(worst, err), k_total + k_ms, p_total + p_ms
            del q, k, v, out, ref
        results[name] = (worst, k_total, p_total)
    return results


def phase_backward_kernel(torch, A, device):
    """K3 against its plain version at the path shapes, bf16; returns
    (max_abs_err, kernel_ms_sum, plain_ms_sum)."""
    gen = torch.Generator(device=device).manual_seed(10)
    worst, k_total, p_total = 0.0, 0.0, 0.0
    for shape in PATH_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        args = (q, k, v, o, do, l)
        got = A.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        ref = A.flash_attention_bwd_plain(*args)
        rel, abs_err = [], 0.0
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            diff = (g.float() - r.float()).abs().max().item()
            rel.append(diff / max(r.float().abs().max().item(), 1e-30))
            abs_err = max(abs_err, diff)
            if not (rel[-1] <= BWD_REL_TOL and torch.isfinite(g.float()).all().item()):
                raise AssertionError(f"flash_attention_bwd {shape} {name}: max|err|/max|ref| {rel[-1]} > "
                                     f"{BWD_REL_TOL} or not finite")
        del got, ref
        k_ms = time_ms(torch, lambda: A.flash_attention_bwd(*args), reps=20)
        p_ms = time_ms(torch, lambda: A.flash_attention_bwd_plain(*args), reps=3, warmup=1)
        b, h, n, d = shape
        tflops = 10 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
        log(f"  flash_attention_bwd B*H={b * h} N={n} D={d}: max|err|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {BWD_REL_TOL}), max abs err {abs_err:.3e}; kernel {k_ms:.3f} ms "
            f"({tflops:.1f} TFLOP/s of its five products), plain {p_ms:.3f} ms")
        worst, k_total, p_total = max(worst, abs_err), k_total + k_ms, p_total + p_ms
        del q, k, v, do, o, l, args
        torch.cuda.empty_cache()
    return worst, k_total, p_total


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
    """The three variants at full width. Warm-up runs first (cuDNN picks its
    algorithms), then REPEATS rounds that time each variant in turn, so drift
    on the shared host spreads over all three alike."""
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
    calls = FLASH_CALLS_PER_UNET * STEPS
    variants = {}
    for name, model, kw, expected in (
        ("headline", unet, HEADLINE, (calls, 0)),
        ("reference_exact", unet, REFERENCE_EXACT, (calls, 0)),
        ("headline_qk_int8", unet_i8, HEADLINE, (0, calls)),
    ):
        fn = make_translate_fn(model, sched, seg, gen, dtype=torch.bfloat16, num_steps=STEPS,
                               start_t=STEPS - 1, mode="fixed", guidance_style="gsg", **kw)
        fn(inp, gt, torch.Generator(device=device).manual_seed(2))  # warm-up
        variants[name] = (fn, kw, expected, [])
    torch.cuda.synchronize()
    launches = {}
    for rep in range(REPEATS):
        for name, (fn, kw, expected, times) in variants.items():
            A.flash_attention.launches = A.flash_attention_qk_i8.launches = 0
            t0 = time.perf_counter()
            out = fn(inp, gt, torch.Generator(device=device).manual_seed(3 + rep))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / STEPS)
            counts = launches[name] = (A.flash_attention.launches, A.flash_attention_qk_i8.launches)
            if counts != expected:
                raise AssertionError(f"{name}: kernel launches (K1, K2) = {counts}, expected {expected}")
            if out.shape != (BATCH, 256, 256, 3) or out.dtype != torch.float32:
                raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}")
            if not (torch.isfinite(out).all().item() and out.min().item() >= 0.0 and out.max().item() <= 1.0):
                raise AssertionError(f"{name}: output not finite or outside [0, 1]")
    for name, (fn, kw, expected, times) in variants.items():
        ms_step = statistics.median(times)
        log(f"  {name}: {ms_step:.2f} ms/step (median of {REPEATS} runs of {STEPS} steps: "
            f"{', '.join(f'{t:.2f}' for t in times)}) at batch {BATCH}, guidance every "
            f"{kw['guidance_every']} in space {kw['guidance_space']}, lam {kw['lam']}; extrapolated to 1000 "
            f"steps {60.0 * BATCH / ms_step:.3f} translations/min [{card}]; launches per run "
            f"K1={launches[name][0]} K2={launches[name][1]}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, (unet, unet_i8, seg, gen, sched, inp, gt)


def phase_reference(torch, device, slice_state):
    """3-step 'sr' chain at batch 1: card (bf16 autocast, kernels) against
    CPU (f32, plain versions), same weights, same noise."""
    import copy

    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    unet, _, seg, gen, sched, inp, gt = slice_state
    unet_c, seg_c, gen_c = (copy.deepcopy(m).to("cpu") for m in (unet, seg, gen))
    kw = dict(num_steps=REF_STEPS, start_t=REF_STEPS - 1, mode="fixed", guidance_style="gsg",
              guidance_every=1, guidance_space="sr", lam=60.0)
    g = torch.Generator().manual_seed(4)
    noise = (torch.randn(1, 128, 128, 3, generator=g), torch.randn(REF_STEPS, 1, 128, 128, 3, generator=g))
    x1, gt1 = inp[:1], gt[:1]
    card = make_translate_fn(unet, sched, seg, gen, dtype=torch.bfloat16, **kw)(
        x1, gt1, noise=tuple(n.to(device) for n in noise)).cpu()
    t0 = time.perf_counter()
    host = make_translate_fn(unet_c, linear_schedule(1000), seg_c, gen_c, **kw)(
        x1.cpu(), gt1.cpu(), noise=noise)
    rel = ((card - host).norm() / host.norm()).item()
    log(f"  card bf16 vs CPU f32, {REF_STEPS}-step 'sr' chain at batch 1: relative L2 error {rel:.3e} "
        f"(tol {CHAIN_REL_TOL}); max abs {(card - host).abs().max().item():.3e}; "
        f"CPU run {time.perf_counter() - t0:.1f} s")
    if not rel <= CHAIN_REL_TOL:
        raise AssertionError(f"card and CPU chains disagree: relative L2 error {rel}")


def phase_profile(torch, device, slice_state):
    """Device time by kernel over a 4-step chain of each variant (two guided
    steps in the headline variants, three in the reference-exact one)."""
    from torch.profiler import ProfilerActivity, profile

    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    unet, unet_i8, seg, gen, sched, inp, gt = slice_state
    cuda = torch.autograd.DeviceType.CUDA
    for name, model, kw in (("headline", unet, HEADLINE), ("reference_exact", unet, REFERENCE_EXACT),
                            ("headline_qk_int8", unet_i8, HEADLINE)):
        fn = make_translate_fn(model, sched, seg, gen, dtype=torch.bfloat16, num_steps=4, start_t=3,
                               mode="fixed", guidance_style="gsg", **kw)
        fn(inp, gt, torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(inp, gt, torch.Generator(device=device).manual_seed(6))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == cuda and getattr(e, "device_time_total", 0) > 0]
        total_us = sum(e.device_time_total for e in events)
        if total_us == 0:
            log(f"  {name}: the profiler saw no device time; device breakdown not measured")
            continue
        flash_us = sum(e.device_time_total for e in events if "wcflash" in e.key)
        log(f"  {name}, 4 steps: wall {wall_ms:.1f} ms under the profiler, kernel time {total_us / 1e3:.1f} ms "
            f"({total_us / 4e3:.1f} ms/step), device idle share ~{max(0.0, 1 - total_us / 1e3 / wall_ms):.2f}, "
            f"flash kernels {100 * flash_us / total_us:.1f}% of kernel time, "
            f"{sum(e.count for e in events)} kernel launches")
        if name == "headline":
            for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
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
    fwd_us = sum(e.device_time_total for e in events if "flash_fwd_kernel" in e.key)
    log(f"  {steps} train steps: wall {wall_ms:.1f} ms under the profiler, kernel time {total_us / 1e3:.1f} ms "
        f"({total_us / steps / 1e3:.1f} ms/step), device idle share ~{max(0.0, 1 - total_us / 1e3 / wall_ms):.2f}, "
        f"K3 {100 * bwd_us / total_us:.1f}% and K1 {100 * fwd_us / total_us:.1f}% of kernel time, "
        f"{sum(e.count for e in events) / steps:.0f} kernel launches per step; the optimizer step's range "
        f"{adam_us / steps / 1e3:.2f} ms/step")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        log(f"    {e.device_time_total / 1e3:8.2f} ms {100 * e.device_time_total / total_us:5.1f}% "
            f"x{e.count:<5d} {e.key[:100]}")


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: its name, registers and spill bytes."""
    lines, name, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next((k for k in ("flash_fwd_qk_i8_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                                     "flash_fwd_kernel") if k in mangled), mangled)
            name += ("<f16" if "6__half" in mangled else "<bf16") + ", D=" + mangled.split("Li")[1].split("E")[0] + ">"
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
        return 2
    sys.path.insert(0, REPO)
    from weatherconverter_tpu_torch.ops import attention as A
    from weatherconverter_tpu_torch.ops import cuda_build

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

    log(f"phase 2: kernels against their plain versions, bf16 [{card}]")
    kernel_results = phase_kernels(torch, A, device)
    kernel_results["flash_attention_bwd"] = phase_backward_kernel(torch, A, device)

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

    csrc = "weatherconverter_tpu_torch/csrc/"
    kernels = []
    for name, source, replaces, count in (
        ("flash_attention", csrc + "flash_fwd.cu", "weatherconverter_tpu/ops/attention.py:78",
         launches["headline"][0]),
        ("flash_attention_qk_i8", csrc + "flash_fwd_qk_i8.cu", "weatherconverter_tpu/ops/attention.py:125",
         launches["headline_qk_int8"][1]),
        ("flash_attention_bwd", csrc + "flash_bwd.cu", "weatherconverter_tpu/ops/attention.py:305",
         train_state[0][2]),
    ):
        err, k_ms, p_ms = kernel_results[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count, "max_abs_err": err, "ms": round(k_ms, 4), "plain_ms": round(p_ms, 4)})
    log("kernels: ms and plain_ms are sums of the medians over the four path shapes; launches are "
        "from the headline run (K1), the int8 run (K2) and the loop_diffusion.train run (K3)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
