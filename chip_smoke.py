#!/usr/bin/env python3
"""Smoke run of the PyTorch port (weatherconverter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (exit code != 0, no result line):
  1. build the hand-written CUDA kernels from csrc/ with nvcc (no spill or
     serialized wgmma in the flash kernels, K2-f32 and the f32 quantizer
     included);
  2. hold each kernel (the flash forwards K1 and K2, the flash backward K3)
     against its plain PyTorch version at the four attention shapes of the
     production UNet at batch 8, in bf16, and time both; beside them, the
     least time the card could take (the roofline bound, and what binds it)
     and the time of torch's scaled_dot_product_attention, forward and
     backward alone, on the same inputs: a yardstick the port never calls;
     K2's quantizer must equal its plain version exactly (int8 tensors and
     scale), K2's time is split into quantizer and forward, and two K2 calls
     must agree bit for bit; the quantizer and K2 again with one int8 scale a
     batch row (the server's): the quantizer equal to its plain version, K2
     within the forward gate, row 0 of a batch whose row 1 is scaled 100x
     equal to row 0 alone, each timed beside its bound, the eager and sdpa
     times; K1 and K3 also at the 256 px UNet's (N, D) =
     (1024, 192), K1 at the legacy UNet's (1024, 24) (D = 32 tiles with
     zero-filled tails), K1-f32 (3xTF32 on the tensor cores) at the legacy
     UNet's (1024, 16) and (1024, 24), at the four path shapes and at
     (1024, 192) in f32, within 1e-5 of max |ref| (beside its f32 FMA bound
     and sdpa's f32 forward); K3-f32 at the four path shapes and (1024, 192)
     in f32, within F32_BWD_REL_TOL of max |ref| for dQ, dK and dV, two calls
     bit-equal, the plain backward with TF32 matmuls for that call (the
     planted fault) beyond the limit, beside its bound and sdpa's f32
     backward; one forward and backward of the
     256 px UNet in f32 (K1-f32 and K3-f32 at its twelve flash-length
     layers) and under bf16 (K1 and K3), and one forward of it with qk_int8
     in f32 (K2-f32 at all twelve) and under bf16 (K2 at all twelve, D = 192
     included); K2-f32 (int8 Q K^T, P V in 3xTF32) and its quantizer on f32
     q and k at the four path shapes, (1024, 16), (1024, 24) and (1024,
     192), per tensor and per batch row: the quantizer equal to its plain
     version, K2-f32 within 1e-5 of max |ref| of its f32 plain version, two
     calls bit-equal, row 0 beside a x100 row 1 equal to row 0 alone, two
     planted faults (V in bf16, P V in one TF32 pass) beyond the limit, each
     timed beside its bound, sdpa's f32 forward, the plain version and
     K1-f32;
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
     against its plain version at the probe's full shapes (K7 also at
     (2, 4160, 32) and (1, 1024, 128): int32 exactly, bf16 within 1e-5 of
     max |S|), then run the probe (its comparison lines, CUDA-event times,
     K7 beside torch._int_mm and torch.mm(out_dtype=torch.float32)), whose
     launches of the kernel are counted;
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
     K2 against K1 through the DPM chain at 20 steps and (when the run gets
     there within INT8_DDIM_BEFORE_S) the DDIM chain at 50, batch 8, against a
     chaos floor of 3 perturbed runs, and two identical K1 runs; then DPM-20
     in f32 (K2-f32 against K1-f32, the CLI's path) against its floor;
     the verdicts are printed, not gated;
 13. the CLI (cli/main.py) in-process at the shipped configs/translation.yaml
     (the 128 px UNet, DeepLabV3+/ResNet-101 at OS16, the 4x SRGAN: 512 px
     out) and configs/diffusion.yaml, seeded random weights, a synthetic
     2048 x 1024 image and labelIds map, every inference command in f32 as
     JAX's: translate with DPM-20 and DDIM-50 on K2-f32 (the inference
     default) and DPM-20 with --no-int8-attn on K1-f32, sample (DPM-20,
     batch 8, K2-f32), super-resolve, train-ddpm (4 steps, bf16: K1 and K3);
     each must exit 0, write a PNG of its shape with finite values in range
     before the uint8 cast, and launch the kernels 8 times a UNet forward,
     K2 on f32 V only; then one translate in a fresh process; its wall time
     beside the library path's;
 14. the server (serving/server.py) on the card at the same configuration,
     sampler dpm at 5 steps, batch 4: 8 concurrent /v1/translate requests
     with labels of 3-19 classes and 2 /v1/sample requests, the chains in
     f32, on K2-f32 with one int8 scale a request (the default) under
     lcg_present_k='auto' and under the full sweep, and on K1-f32
     (--no-int8-attn) under the full sweep (latency p50/p95, translations a
     minute, occupancy, batches, buckets, peak memory, the kernels'
     launches); every response 200 with a PNG of its shape, /stats counts
     that add up; after each full sweep one seed solo and co-batched, within
     two solo runs' difference plus one uint8 level, under K2-f32 as under
     K1-f32; one chain of the per-row K2 service under bf16 autocast;
 15. segmentation at configs/segmentation.yaml (DeepLabV3+/ResNet-101 at
     OS16, 19 classes, batch 8, 270 x 480 images cropped to 256 x 256, SGD
     under PolyLR, bf16 autocast over f32 parameters, seeded random weights)
     on a synthetic ACDC tree (fog and rain, 16 train and 4 val 960 x 540
     pairs each, striped labelIds): loop_segmentation.train for 2 epochs
     (finite losses and input-gradient magnitudes, parameters and BatchNorm
     statistics that move, a Mean IoU each epoch, the best step restored
     equal to the saved one); timed windows of the augmented train step on
     one device-resident uint8 batch (ms/step, images/s, a profiled window's
     device ms/step, idle share, launches and top kernels, peak memory, the
     step's FLOPs from torch.utils.flop_counter and their bound at 989
     TFLOP/s); one batch-2 step card against CPU (f32) with the same seeded
     weights, each residual block's last BatchNorm scale x 0.1, and draws,
     in f32 and in bf16, each held to its precision's limits on the loss,
     the parameter update, the batch term of the BN statistics (all and the
     worst buffer) and the eval-step predictions' agreement
     (probes/seg_step_parity.py), and four planted faults, each of which
     must break a limit; train-seg (4 steps) and infer-seg
     on its best step through the CLI (exit 0, the three PNGs' shapes, finite
     values in range before the uint8 cast). It launches no kernel of ours;
 16. the rest of the DeepLab family at configs/segmentation.yaml (batch 8,
     256 x 256 crops of 270 x 480 images, bf16 autocast over f32
     parameters, seeded random weights) with the geometric legs of the
     augment on (scale 0.5-2.0, rotation 10 degrees, hue 0.1): DeepLabV3+
     over MobileNetV2, Xception, HRNetV2-W32 and HRNetV2-W48, and over
     ResNet-101 with the atrous-separable head; each model a few augmented
     train steps (finite losses, parameters and BatchNorm statistics that
     move), timed windows (ms/step, images/s, a profiled window's device
     ms/step, idle share and launches, peak memory, the step's FLOPs from
     torch.utils.flop_counter and their bound at 989 TFLOP/s), and an eval
     forward at batch 2, card f32 against CPU f32, on the logits' relative
     L2 error and the predictions' agreement; HRNet's stem with a ReLU put
     back between its convs must break those limits. No kernel of ours;
 17. Swift-SRGAN training at the JAX defaults (G 64 channels, 16 blocks,
     4x; the default discriminator; 96 px HR crops, batch 4, bf16 autocast
     over f32 parameters) on a synthetic tree of 16 HR PNGs:
     loop_srgan.train for a pretrain epoch and a GAN epoch (finite g and d
     losses, G and D that move, a checkpoint restored equal, a resume that
     goes on in the GAN phase), timed windows of the pretrain and the GAN
     step at batch 4 and 16 (the fields of phase 16), one pretrain step and
     one GAN step at batch 2 card f32 against CPU f32 (the losses, every
     parameter's update, Adam's first moments, the BatchNorm statistics'
     change), where two planted faults must each break a limit: D's
     statistics left updated in the G step, and the adversarial term
     detached from G's update; then
     train-srgan --max-steps 4 and super-resolve with that run's generator
     through the CLI (exit 0, a PNG of 4x the input, finite values in range
     before the uint8 cast). No kernel of ours;
 18. the legacy UNet (models/unet_legacy.py) at 128 px, seeded weights
     scaled to unit-variance eps, batch 8, 20 strided steps of
     ddpm_sample_legacy, in f32 (K1-f32 at attn_down3 and attn_up2, no
     TF32), in f32 with qk_int8 (K2-f32 at both: what the CLI runs, as JAX's
     sample enables its int8 kernel) and under bf16 with qk_int8 (K2 at
     attn_down3 and at attn_up2, D = 24, its launches there counted): each
     timed, profiled, its launches a forward asserted, its peak memory read;
     the precision check of probes/legacy_precision.py at batch 2 (the bf16,
     f32 and f32 qk_int8 card chains against the f32 CPU chain and its 3-run
     chaos floor; the f32 chain must pass, the others' verdicts are printed,
     not gated: the bf16 one fails by design); `sample --sampler legacy`
     through the CLI (exit 0, the PNG's shape, K2-f32 twice a forward);
 19. `quality --synthetic 8 --batch 8 --steps 20` through the CLI at
     configs/translation.yaml, with the seg backbone's FID and with
     InceptionV3 pool3 from a seeded torchvision-layout .pth written by
     compat/from_jax.export_inception_v3 (exit 0, the report's keys, finite
     numbers, K1-f32 8 times a UNet forward and no K2: JAX's quality never
     enables int8), then Inception's f32 time for a 299 px batch of 8 and
     FID's eigh at D = 2048;
 20. `visualize` through the CLI at configs/diffusion.yaml (seeded weights,
     K1) on a synthetic 128 px image, a frame every 25 steps of the chain
     on a copy of the config with a 250-step schedule, at batch 1, and
     `translate --debug-dir` at
     configs/translation.yaml (K2-f32 per layer) at 10 steps, a dump every 5,
     both in f32 (visualize on K1-f32),
     beside a plain translate with the same seed: exit 0, the files and
     their shapes, K1/K2/quantizer launches as the UNets' attention_kernels
     predict, the debug run's output PNG byte-equal to the plain one's; each
     run's wall time (core/profiling.StepTimer) and peak memory
     (device_memory_stats); a traced short run of each (core/profiling.trace,
     the trace written and not empty) for device time and idle share;
 21. `export-hlo --program translate --attn int8` through the CLI at
     configs/translation.yaml, batch 2, 2 steps, the program in f32 (K2-f32
     and its quantizer as custom ops in the traced program), then the live
     program twice on the card with seeded weights, input, labels and draws,
     and the archive run by serving/hlo_runtime.load_exported in a fresh
     process that imports no model code: K2-f32 and its quantizer launched 8
     times a UNet forward there as live, no K1, no bf16 cast in the loaded
     graph, the output bit-equal to the live one; the trace, export, save,
     load and run seconds and the archive's MiB;
 22. data parallel on the card (training/ under `mesh=`, parallel/): two
     ranks, child processes that load phase 1's library and share the one
     H100 over gloo (NCCL refuses two ranks on one device; gloo all-reduces,
     broadcasts, all-gathers and reduce-scatters CUDA tensors), each with its
     rows of the global batch: (a) one DDPM step of the default UNet at
     global batch 8 under bf16 autocast, K1 and K3 launched in each rank,
     held against the single-process batch-8 step on the card from the same
     weights and draws (loss, Adam's first moments), plain and FSDP-sharded,
     with the gradient all-reduce skipped as the planted fault; (b) one
     DeepLabV3+/ResNet-101 step of configs/segmentation.yaml at global batch
     8 over two microbatches with the synced BatchNorm, damped residual
     scales as phase 15, held against the single-process step (loss, update,
     BatchNorm statistics), a per-rank BatchNorm as the planted fault; (c)
     `torchrun --standalone --nproc-per-node 1 -m
     weatherconverter_tpu_torch.cli.main train-ddpm` with training.fsdp=true
     over NCCL at world size 1: exit 0, one run directory, the sharded
     fraction printed, a checkpoint that loads into a plain single-process
     state. Each rank's DDPM step wall and device ms, plain, FSDP and
     without the gradient all-reduce (that all-reduce's share of the step),
     and its launches are printed beside the card; two ranks sharing one
     card are no scaling figure;
 23. spatial guidance and the host feed: (a) two gloo ranks sharing the card
     run `sample_with_sgg(spatial_mesh=make_spatial_mesh(space=2))` at
     configs/translation.yaml's full width (128 px latents, the 4x SRGAN to
     512 px, DeepLabV3+/ResNet-101 at OS16), batch 2, bf16, the first 4
     steps of the config's span (t = 499 .. 496) of GSG in 'sr' space with
     replayed draws at the config's lam: the seg forward and input gradient
     on each rank's 256 rows (parallel/spatial.py's halo exchanges), K1
     counted in each rank; one guided step at SP_CHECK_LAM held against
     rank 0's single-process step (its difference over the guidance's own
     effect, limit SP_LIMIT), a per-shard valid-pixel count as the planted
     fault; one guidance field
     against the unsharded one under bf16 autocast and in f32 (rel L2,
     limits SP_FIELD_LIMITS), every halo row fetched as zeros as the planted
     fault; each rank's ms a step and peak memory over the chain and over
     one seg forward and backward beside the unsharded ones; (b) the native
     decoder's headers checked (present: a failed build fails the phase;
     absent: the reason printed, PIL goes on), synthetic 1920x1080 PNG and
     JPEG files decoded through the port's loader by the native batch path
     and by PIL on the loader's threads (probes/host_feed.py at a smoke
     size: one untimed epoch, then two timed): images per second each,
     beside the host's CPU count; native held within 1 level of PIL;
 24. DDPM training in f32 on the card (training.dtype float32: K1-f32 and
     K3-f32 at the UNet's flash-length layers, TF32 off for its
     convolutions and matmuls), cuDNN by its heuristics: (a) one step at
     batch 2 against phase 7's CPU f32 step (its weights, draws and result),
     within limits that phase 7's bf16 step must break; (b) `train-ddpm
     --set training.dtype=float32` through the CLI at configs/diffusion.yaml,
     batch 8, one 4-step epoch of phase 13's synthetic tree: exit 0, finite
     losses, the epoch's checkpoint restored at step 4, K1-f32 and K3-f32
     8 launches a step each, K1 and K3 none; (c) the f32 step at batch 8 on
     one batch: wall ms a step, a profiled step's device ms, idle share and
     launches, peak GiB;
 25. the f32 inference chain, card against CPU: make_translate_fn(dtype=None)
     at configs/translation.yaml with seeded weights, the UNet built
     qk_int8 (K2-f32 on the card, K2's plain version on the CPU), batch 1,
     F32_CHAIN_STEPS steps of GSG in latent space, the same draws: within
     F32_CHAIN_REL_TOL (relative L2), which the same card chain under bf16
     autocast must break.
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
# the legacy UNet's attn_up2 at batch 8 (96 channels over 4 heads on the 32 x 32 map): K1's D = 24, checked and timed
# beside the path shapes; and its two flash-length layers in f32, K1-f32's shapes on the legacy sampler's path
D24_SHAPE = (BATCH, 4, 1024, 24)
F32_SHAPES = [(BATCH, 4, 1024, 16), (BATCH, 4, 1024, 24)]
# K2-f32 (and its quantizer on f32 q, k): the path shapes (the CLI's and the server's f32 UNet), the legacy UNet's two
# flash-length layers and the 256 px UNet's D = 192, each per tensor and per batch row
QK_I8_F32_SHAPES = PATH_SHAPES + F32_SHAPES + [D192_SHAPE]
# K1-f32 against its plain version in f32: max |err| / max |ref| (the same products in another order, exp2 by
# ex2.approx: 2 ulp); also at the path shapes in f32 (the f32 training path) and at D192_SHAPE; and K2-f32 against
# its plain version in f32 at QK_I8_F32_SHAPES. H100 readings of K2-f32 (PERF.md section 6): 6.4e-7-3.2e-6; the
# planted faults (V rounded to bf16, P V in one TF32 pass) 3.3e-4-6.0e-3
F32_REL_TOL = 1e-5
# K3-f32 against its plain version in f32: max |err| / max |ref| of dQ, dK and dV each. H100 readings (this phase
# at the path shapes and D192_SHAPE): 1.2e-6-3.2e-6; the plain backward with TF32 matmuls (one TF32 pass, the
# planted fault) read 5.5e-4-1.6e-3 there and must break it
F32_BWD_REL_TOL = 2e-5
# phase 24 (a): one f32 train step at batch 2, card (K1-f32, K3-f32, TF32 off) against phase 7's CPU f32 step:
# relative error of the loss, relative L2 error of the flattened UNet gradient. Both must sit below phase 7's bf16
# readings against the same CPU step, which they must reject. H100 readings (PERF.md section 6): f32 0.0 and
# 1.6e-6; bf16 3.3e-4 and 1.2e-2
F32_TRAIN_LOSS_REL_TOL, F32_TRAIN_GRAD_REL_TOL = 1e-5, 1e-4
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
# phases 3 and 18 time each run once (twice until the inference phases ran in f32, for the time limit)
REPEATS = 1
# phase 10 times each sampler path once: its twelve timed runs took ~28 s of a run that passed its 1,200 s limit on
# an H100 (its two rounds differed by 1.6-9.6 % there)
SAMPLER_REPEATS = 1
# phase 3's warm-up runs: 4 steps take GSG, LCG and an unguided last step in every variant (the 20-step warm-ups took
# ~7 s of the run; phase 10 warms up at PROFILE_STEPS steps, where its full-length warm-ups took ~16 s)
WARMUP_STEPS = 4
# training: steps through loop_diffusion.train (one epoch, one checkpoint),
# then WINDOWS timed windows of WINDOW_STEPS steps on one fixed batch
TRAIN_STEPS, WINDOWS, WINDOW_STEPS = 24, 3, 20
# phase 10: ddpm_sample's strided run, and the fast guided translations as the JAX bench runs them
# (bench.py:403-412: GSG, lam 60, the default span; DDIM at eta 0); profiled runs take PROFILE_STEPS steps
SAMPLE_STEPS, DDIM_STEPS, DPM_STEPS, PROFILE_STEPS = 20, 50, 20, 5
FAST_GUIDED = dict(lam=60.0, num_classes=19, guidance_style="gsg")
# the chaos floors' runs: phase 12's int8 checks, bf16 and f32, whose verdicts are printed (5 until the f32 check came;
# 3 keep the script within its time), and phase 18's legacy precision check, whose f32 verdict gates (its floor's mean
# - 2 sigma, ddof 1, stays on 5 runs: ~4 s each on the CPU)
INT8_FLOOR_SEEDS, LEGACY_FLOOR_SEEDS = 3, 5
# phase 15: the synthetic ACDC tree (train and val pairs per condition, (W, H) of its PNGs). One seg train
# step at batch 2 on the card against the CPU (f32), on the seeded model with each residual block's last
# BatchNorm scale x SEG_RESIDUAL_SCALE: on the fresh model the CPU's own f64 step is 16 % from its f32 one
# in the update (in the stem and layer1), so nothing could be told from rounding there. Measures
# (probes/seg_step_parity.py): loss relative error; relative L2 error of the update over every leaf
# ("update") and without the ASPP pooling conv ("update_without_pooled": at batch 2 its bf16 gradient is
# rounding, see pooled_leaves); relative L2 error of the BatchNorm statistics' batch term over all
# buffers ("stats") and in the worst one ("stats_worst"); the share of equal eval-step predictions
# ("agree"). Limits from H100 readings (PERF.md section 6), in that order: f32 8.0e-8, 3.3e-3, 5.5e-6,
# 3.0e-5, 1.00000, and 1.3e-5, 2.0e-2, 1.5e-4, 3.9e-4, 0.99992 in a process that ran this phase alone
# (the card's step identical, the CPU's reference moved in that process); bf16 1.4e-4-3.5e-4,
# 0.154-0.168 (0.30-0.45 with the pooled leaf), 6.0e-3-7.5e-3, 1.5e-2-1.9e-2, 0.981-0.983 (the CPU's
# bf16 step 2.9e-4, 0.171, 5.9e-3, 1.4e-2, 0.970). The faults of SEG_CONTROLS read there, on the measure
# each breaks: head lr x 2, bf16 1.015; dropout, f32 0.27 and loss 2.1e-3; the unbiased running variance
# 1.000 in the pooled BatchNorm's buffer; zero logits 0.006 of predictions equal. Dropout in bf16
# (0.30-0.33 without the pooled leaf) clears its limit by too little to be a control.
SEG_PAIRS, SEG_SIZE = (16, 4), (960, 540)
SEG_RESIDUAL_SCALE = 0.1
SEG_LIMITS = {"f32": dict(loss=1e-4, update=5e-2, stats=2e-2, stats_worst=1e-2, agree=0.99),
              "bf16": dict(loss=1e-3, update_without_pooled=0.25, stats=2e-2, stats_worst=0.1, agree=0.95)}
SEG_CONTROLS = (("bf16", "head_lr_x2"), ("bf16", "unbiased_running_var"), ("bf16", "zero_logits"),
                ("f32", "dropout_on"))
# phase 12 runs its DDIM half only if the run reaches it this early, so that phases 13-21 fit the time limit (it was
# 420 s before phase 21 came: the runs reach phase 12 at 290-400 s on an H100, so the DDIM half runs only on a faster
# host)
INT8_DDIM_BEFORE_S = 240
# phase 16: the rest of the DeepLab family at configs/segmentation.yaml with the geometric legs on, each
# model (name, separable head) a few steps, FAMILY_WINDOWS timed windows of FAMILY_WINDOW_STEPS, a profiled
# window of FAMILY_PROFILED steps; its eval forward at batch 2, card f32 against CPU f32, held on the
# logits' relative L2 error and the predictions' agreement. H100 readings (PERF.md section 6): 4.5e-7-7.0e-7
# and 1.00000 (MobileNetV2, Xception, HRNet-W32); HRNet's stem with a ReLU put back 1.8e-2 and 0.99845
SEG_FAMILY = (("deeplabv3plus_mobilenet", False), ("deeplabv3plus_xception", False),
              ("deeplabv3plus_hrnetv2_32", False), ("deeplabv3plus_hrnetv2_48", False),
              ("deeplabv3plus_resnet101", True))
SEG_GEOMETRIC = dict(scale_range=[0.5, 2.0], rotation_degrees=10.0, hue=0.1)
FAMILY_STEPS, FAMILY_WINDOWS, FAMILY_WINDOW_STEPS, FAMILY_PROFILED = 3, 1, 5, 3
FAMILY_EVAL_LIMITS = dict(rel=1e-4, agree=0.999)
# phase 17: SRGAN training at the JAX defaults (G 64 channels, 16 blocks, 4x; the default D; 96 px HR
# crops, batch 4) on a synthetic HR tree of SRGAN_IMAGES (W, H) PNGs; timed windows of both phases at
# SRGAN_BATCHES; one pretrain and one GAN step card f32 against CPU f32 at batch 2, held on the losses'
# relative error, the relative L2 error of the parameters' update, of Adam's first moments (0.1 g: the
# gradients' scale, which the first updates, about lr * sign(g), do not carry) of G's pretrain step, G's GAN
# step and D's step, and of the BatchNorm statistics' change. H100 readings (PERF.md section 6): 8.1e-7,
# 1.47e-2 (a gradient entry near 0 that rounds to the other sign moves by 2 lr), 3.7e-5, 7.9e-3-2.1e-2,
# 5.6e-4-4.6e-3 (D's BatchNorms over batch 2 and 6 x 6 maps amplify f32 rounding; G's GAN gradient takes it
# through D), 1.1e-6; D's statistics left updated in the G step 0.32 on the statistics; the adversarial term
# detached from G's update 0.34 on G's GAN-step moments
SRGAN_IMAGES, SRGAN_SIZE, SRGAN_BATCHES = 16, (384, 216), (4, 16)
# phase 18: the legacy UNet at 128 px, batch 8, LEGACY_STEPS strided steps; the precision check (bf16 card chain and
# f32 card chain against the f32 CPU chain, a LEGACY_FLOOR_SEEDS-run floor) at LEGACY_CHECK_BATCH
LEGACY_STEPS, LEGACY_CHECK_BATCH = 20, 2
# phase 19: the quality command on configs/translation.yaml: --synthetic QUALITY_N --batch BATCH --steps
QUALITY_N, QUALITY_STEPS = 8, 20
# phase 20: visualize, a frame every VIS_EVERY steps of a copy of configs/diffusion.yaml with a VIS_T-step schedule
# (the full 1000-step chain took 49 s of a run that reached 1,242 s, the 250-step one 15 s); translate --debug-dir at
# DEBUG_STEPS steps, a dump every DEBUG_EVERY. Each is traced on a short run beside it: visualize on a copy of the config with a
# VIS_TRACE_T-step schedule, translate --debug-dir at DEBUG_TRACE_STEPS steps (a trace holds every host op and kernel:
# 68 MiB for 20 visualize steps, 304 MiB for 20 guided steps on an H100, so traces of the full runs would take
# minutes to write)
VIS_T, VIS_EVERY, VIS_TRACE_T, DEBUG_STEPS, DEBUG_EVERY, DEBUG_TRACE_STEPS = 100, 10, 20, 10, 5, 4
# phase 14: the server's DPM chains (translate and /v1/sample) take SERVER_STEPS steps where the server's default is
# 20, for SERVER_TRANSLATIONS concurrent translations and SERVER_SAMPLES samples, and phase 20's --debug-dir chains
# DEBUG_STEPS, so that phase 23 fits: with 10 steps and 16 + 4 requests the whole script reached 1,242 s of its
# 1,200 (PERF.md section 6). Three steps take each kind of step the server's warm-up takes: LCG, GSG, unguided
SERVER_STEPS, SERVER_TRANSLATIONS, SERVER_SAMPLES = 3, 8, 2
# phase 25: the f32 inference chain, card against CPU: configs/translation.yaml's models from the seed, batch 1,
# F32_CHAIN_STEPS steps of GSG in latent space through make_translate_fn(dtype=None), the UNet built qk_int8 (K2-f32 on
# the card, K2's plain version on the CPU), the same draws: relative L2 error of the images. An f32 last-bit difference
# upstream can flip an int8 value at a .5 boundary (tests/test_torch_f32_inference.py), which latent-space guidance over
# a few steps keeps local (phase 23's lesson). The limit is set from the card's reading, 3.2e-8 on an H100 (PERF.md
# section 6), with 30x room; the planted fault, the same chain under bf16 autocast (what the CLI ran before
# K2-f32), read 2.4e-4 there and must break it
F32_CHAIN_STEPS = 4
F32_CHAIN_REL_TOL = 1e-6
# phase 21: export-hlo --attn int8 of the translate program at configs/translation.yaml: steps (the JAX default
# schedule: GSG at i = 1, none at i = 0) and batch. At 3 steps (LCG at i = 2: five seg calls) the graph held 24,004
# nodes and the phase took 143 s on an H100 (save 28 s, load 41 s); tests/test_torch_export.py runs 3 steps tiny
EXPORT_STEPS, EXPORT_BATCH = 2, 2
SRGAN_LIMITS = dict(loss=1e-5, update=0.1, moments_g_pretrain=1e-3, moments_g_gan=0.1, moments_d=5e-2, stats=1e-4)
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
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text, peaks,
                                                          sdpa_ms, time_ms)

    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, kernel, plain in (
        ("flash_attention", A.flash_attention, A.flash_attention_plain),
        ("flash_attention_qk_i8", A.flash_attention_qk_i8, A.flash_attention_qk_i8_plain),
    ):
        total, bounds = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0), []
        for shape in PATH_SHAPES + [D192_SHAPE, D24_SHAPE]:
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
            out = kernel(q, k, v)
            torch.cuda.synchronize()
            ref = plain(q, k, v)
            err, rel = _forward_gate(torch, name, shape, out, ref)
            k_ms = time_ms(lambda: kernel(q, k, v), reps=20)
            p_ms = time_ms(lambda: plain(q, k, v), reps=5)
            lib_ms = sdpa_ms(q, k, v)
            bound = attention_roofline(peaks(card), shape, qk_int8=kernel is A.flash_attention_qk_i8)
            b, h, n, d = shape
            tflops = 4 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
            log(f"  {name} B*H={b * h} N={n} D={d}: max_abs_err {err:.3e} (tol {KERNEL_TOL}), max|err|/max|ref| "
                f"{rel:.3e} (tol {KERNEL_REL_TOL}); "
                f"kernel {k_ms:.4f} ms ({tflops:.1f} TFLOP/s of QK^T+PV), plain {p_ms:.3f} ms, "
                f"{bound_text(bound, k_ms)}, sdpa forward {lib_ms:.4f} ms (yardstick, never called by the port)"
                + (" [the 256 px UNet's shape: not in the sums]" if shape == D192_SHAPE else "")
                + (" [the legacy UNet's attn_up2, D = 24 on zero-filled 32-wide tiles: not in the sums]"
                   if shape == D24_SHAPE else ""))
            if shape in (D192_SHAPE, D24_SHAPE):
                if kernel is A.flash_attention_qk_i8:  # K2's own lines in the kernels line
                    results[f"{name}_d{shape[-1]}"] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                                          bound=bound)
                continue
            bounds.append(bound)
            total = dict(err=max(total["err"], err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms,
                         library_ms=total["library_ms"] + lib_ms)
            del q, k, v, out, ref
        results[name] = dict(total, bound=add_rooflines(*bounds))
    results.update(_f32_kernel(torch, A, device, card, gen))
    return results


def _f32_kernel(torch, A, device, card, gen):
    """K1-f32 against its plain version in f32 at the legacy UNet's two
    flash-length shapes, the default UNet's four path shapes and the 256 px
    UNet's (1024, 192), with its bound (the larger of the exponentials and
    the 3xTF32 products at 494.7 TFLOP/s), the f32 FMA bound beside it, and
    scaled_dot_product_attention's f32 time. Returns {"flash_attention_f32":
    sums over the legacy shapes, "flash_attention_f32_train": sums over the
    path shapes}."""
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text,
                                                          f32_fma_ms, peaks, sdpa_ms, time_ms)

    sums = {name: (dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0), []) for name in
            ("flash_attention_f32", "flash_attention_f32_train")}
    for shape in F32_SHAPES + PATH_SHAPES + [D192_SHAPE]:
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        out = A.flash_attention_f32(q, k, v)
        torch.cuda.synchronize()
        ref = A.flash_attention_plain(q, k, v)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not (rel <= F32_REL_TOL and torch.isfinite(out).all().item()):
            raise AssertionError(f"flash_attention_f32 {shape}: max|err|/max|ref| {rel} > {F32_REL_TOL} or not finite")
        del out, ref
        k_ms = time_ms(lambda: A.flash_attention_f32(q, k, v), reps=20)
        p_ms = time_ms(lambda: A.flash_attention_plain(q, k, v), reps=5)
        lib_ms = sdpa_ms(q, k, v)
        bound = attention_roofline(peaks(card), shape, f32=True)
        b, h, n, d = shape
        fma = f32_fma_ms(peaks(card), shape)
        where = ("the legacy UNet's" if shape in F32_SHAPES else "the 256 px UNet's: not in the sums"
                 if shape == D192_SHAPE else "the f32 training path's")
        log(f"  flash_attention_f32 B*H={b * h} N={n} D={d} [{where}]: max_abs_err {err:.3e}, max|err|/max|ref| "
            f"{rel:.3e} (tol {F32_REL_TOL}); kernel {k_ms:.4f} ms ({4 * b * h * n * n * d / (k_ms * 1e-3) / 1e12:.2f} "
            f"TFLOP/s of f32 products in 3xTF32), plain {p_ms:.3f} ms, {bound_text(bound, k_ms)}, f32 FMA bound "
            f"{'not known' if fma is None else f'{fma:.4f} ms'}, sdpa forward in f32 {lib_ms:.4f} ms (yardstick)")
        if shape != D192_SHAPE:
            total, bounds = sums["flash_attention_f32" if shape in F32_SHAPES else "flash_attention_f32_train"]
            bounds.append(bound)
            total.update(err=max(total["err"], err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms,
                         library_ms=total["library_ms"] + lib_ms)
        del q, k, v
        torch.cuda.empty_cache()
    return {name: dict(total, bound=add_rooflines(*bounds)) for name, (total, bounds) in sums.items()}


def _tf32_pass(torch, fn, *args):
    """fn(*args) with f32 matmuls in one TF32 pass (the planted fault of the
    f32 kernels' gates), whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def phase_qk_i8_f32(torch, A, device, card):
    """K2-f32 (int8 Q K^T, P V in 3xTF32) and its quantizer on f32 q and k,
    at QK_I8_F32_SHAPES, per tensor and per batch row: the quantizer equal
    to its plain version bit for bit; K2-f32 whole (quantizer included) and
    its forward alone within F32_REL_TOL of max |ref| of the f32 plain
    version, two calls bit-equal; per row, row 0 of a batch whose row 1 is
    x100 equal to row 0 alone (int8, scale, output); two planted faults that
    must each break the limit: the plain version with V (and p) rounded to
    bf16, what the port computed before K2-f32, and with P V in one TF32
    pass. Each timed beside its bound, sdpa's f32 forward, the plain version
    and K1-f32 at the same shape. Returns {name: dict(err, ms, plain_ms,
    library_ms, bound)} for "flash_attention_qk_i8_f32",
    "quantize_qk_i8_f32" and their "_per_item" lines, sums over the four
    path shapes."""
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text, peaks,
                                                          quantizer_roofline, sdpa_ms, time_ms)

    gen = torch.Generator(device=device).manual_seed(21)
    sums = {name: (dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0 if "flash" in name else None), [])
            for name in ("flash_attention_qk_i8_f32", "quantize_qk_i8_f32", "flash_attention_qk_i8_f32_per_item",
                         "quantize_qk_i8_f32_per_item")}

    def add(name, shape, err, ms, plain_ms, bound, library_ms=None):
        if shape in PATH_SHAPES:
            total, bounds = sums[name]
            bounds.append(bound)
            total.update(err=max(total["err"], err), ms=total["ms"] + ms, plain_ms=total["plain_ms"] + plain_ms)
            if library_ms is not None:
                total["library_ms"] += library_ms

    for shape in QK_I8_F32_SHAPES:
        b, h, n, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        lib_ms = sdpa_ms(q, k, v)
        k1_ms = time_ms(lambda: A.flash_attention_f32(q, k, v), reps=20)
        for per_item in (False, True):
            suffix = "_per_item" if per_item else ""
            got = A.quantize_qk_i8(q, k, per_item=per_item)
            torch.cuda.synchronize()
            plain_q = A.quantize_qk_i8_plain(q, k, per_item=per_item)
            if not all(g.is_contiguous() and torch.equal(g, r) for g, r in zip(got, plain_q)):
                raise AssertionError(f"quantize_qk_i8 f32 {shape} per_item={per_item}: differs from its plain version")
            out = A.flash_attention_qk_i8(q, k, v, per_item=per_item)
            torch.cuda.synchronize()
            if not (torch.equal(out, A.flash_attention_qk_i8(q, k, v, per_item=per_item))
                    and torch.equal(out, A.flash_qk_i8_forward(*got, v))):
                raise AssertionError(f"flash_attention_qk_i8 f32 {shape}: two calls (or the forward alone) differ")
            ref = A.qk_i8_attention_plain(*plain_q, v)
            scale = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            rel = err / scale
            faults = {"bf16 V": (A.qk_i8_attention_plain(*plain_q, v.to(torch.bfloat16)).float() - ref),
                      "one TF32 pass of P V": _tf32_pass(torch, A.qk_i8_attention_plain, *plain_q, v) - ref}
            faults = {what: f.abs().max().item() / scale for what, f in faults.items()}
            if not (rel <= F32_REL_TOL and out.dtype == torch.float32 and torch.isfinite(out).all().item()):
                raise AssertionError(f"flash_attention_qk_i8 f32 {shape} per_item={per_item}: max|err|/max|ref| {rel} "
                                     f"> {F32_REL_TOL}, or not f32 and finite")
            if not min(faults.values()) > F32_REL_TOL:
                raise AssertionError(f"flash_attention_qk_i8 f32 {shape}: a planted fault reads {faults}, within the "
                                     f"limit {F32_REL_TOL}: the gate cannot tell K2-f32 from it")
            if per_item:
                big_q, big_k = q.clone(), k.clone()
                big_q[1] *= 100
                big_k[1] *= 100  # row 1's maxima 100x the others': row 0 must not see them
                mixed, alone = A.quantize_qk_i8(big_q, big_k, per_item=True), A.quantize_qk_i8(big_q[:1], big_k[:1],
                                                                                                per_item=True)
                o_mixed = A.flash_attention_qk_i8(big_q, big_k, v, per_item=True)
                o_alone = A.flash_attention_qk_i8(big_q[:1], big_k[:1], v[:1], per_item=True)
                if not (all(torch.equal(m[:1], a) for m, a in zip(mixed, alone)) and torch.equal(o_mixed[:1], o_alone)):
                    raise AssertionError(f"per-row int8 f32 {shape}: row 0 moved with row 1 (scaled 100x)")
                del big_q, big_k, mixed, alone, o_mixed, o_alone
            del out, ref
            k_ms = time_ms(lambda: A.flash_attention_qk_i8(q, k, v, per_item=per_item), reps=20)
            f_ms = time_ms(lambda: A.flash_qk_i8_forward(*got, v), reps=20)
            p_ms = time_ms(lambda: A.flash_attention_qk_i8_plain(q, k, v, per_item=per_item), reps=5)
            qz_ms = time_ms(lambda: A.quantize_qk_i8(q, k, per_item=per_item), reps=20)
            qe_ms = time_ms(lambda: A.quantize_qk_i8_plain(q, k, per_item=per_item), reps=10)
            bound = attention_roofline(peaks(card), shape, qk_int8=True, f32=True)
            q_bound = quantizer_roofline(peaks(card), shape, scales=b if per_item else 1, elem_bytes=4)
            where = ("the path's" if shape in PATH_SHAPES else "the legacy UNet's: not in the sums"
                     if shape in F32_SHAPES else "the 256 px UNet's: not in the sums")
            log(f"  flash_attention_qk_i8 in f32 (K2-f32){' per row' if per_item else ''} B*H={b * h} N={n} D={d} "
                f"[{where}]: the quantizer equals its plain version on f32 q, k; max_abs_err {err:.3e}, "
                f"max|err|/max|ref| {rel:.3e} (tol {F32_REL_TOL}), two calls bit-equal"
                + (", row 0 beside a x100 row 1 equal to row 0 alone" if per_item else "")
                + f"; planted faults {', '.join(f'{w} {x:.3e}' for w, x in faults.items())}: break it; K2-f32 whole "
                f"{k_ms:.4f} ms ({4 * b * h * n * n * d / (k_ms * 1e-3) / 1e12:.2f} TOP/s of Q K^T + P V), its "
                f"forward alone {f_ms:.4f} ms, quantizer {qz_ms:.4f} ms (eager {qe_ms:.4f} ms, "
                f"{bound_text(q_bound, qz_ms)}); plain {p_ms:.3f} ms; {bound_text(bound, k_ms)}; K1-f32 "
                f"{k1_ms:.4f} ms; sdpa "
                f"forward in f32 {lib_ms:.4f} ms (yardstick, never called by the port)")
            add("flash_attention_qk_i8_f32" + suffix, shape, err, k_ms, p_ms, bound, lib_ms)
            add("quantize_qk_i8_f32" + suffix, shape, 0.0, qz_ms, qe_ms, q_bound)
            del got, plain_q
        del q, k, v
        torch.cuda.empty_cache()
    return {name: dict(total, bound=add_rooflines(*bounds)) for name, (total, bounds) in sums.items()}


def phase_backward_kernel(torch, A, device, card):
    """K3 against its plain version at the path shapes, bf16, with its
    roofline bound and the library's backward alone; two calls must agree
    bit for bit. Returns dict(err, ms, plain_ms, library_ms, bound), sums
    over the shapes (err: the largest max abs error)."""
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text, peaks,
                                                          sdpa_ms, time_ms)

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
        lib_ms = sdpa_ms(q, k, v, do)
        bound = attention_roofline(peaks(card), shape, backward=True)
        b, h, n, d = shape
        tflops = 10 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
        log(f"  flash_attention_bwd B*H={b * h} N={n} D={d}: max|err|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {BWD_REL_TOL}), max abs err {abs_err:.3e}, two calls bit-equal; kernel "
            f"{k_ms:.4f} ms ({tflops:.1f} TFLOP/s of the five products a backward needs), plain {p_ms:.3f} ms, "
            f"{bound_text(bound, k_ms)}, sdpa backward alone {lib_ms:.4f} ms (yardstick, never called by the port)"
            + (" [the 256 px UNet's shape: not in the sums]" if shape == D192_SHAPE else ""))
        if shape != D192_SHAPE:
            bounds.append(bound)
            total = dict(err=max(total["err"], abs_err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms,
                         library_ms=total["library_ms"] + lib_ms)
        del q, k, v, do, o, l, args
        torch.cuda.empty_cache()
    return dict(total, bound=add_rooflines(*bounds))


def phase_backward_f32_kernel(torch, A, device, card):
    """K3-f32 against its plain version in f32 (TF32 off, as this script sets
    it) at the path shapes and the 256 px UNet's (1024, 192), within
    F32_BWD_REL_TOL of max |ref| for dQ, dK and dV each; two calls must agree
    bit for bit; the plain backward with TF32 matmuls for that call alone
    (one TF32 pass: the planted fault) must break the limit. Each shape's
    kernel time beside its bound (five products in 3xTF32), sdpa's f32
    backward alone and the plain version's time. Returns dict(err, ms,
    plain_ms, library_ms, bound), sums over the path shapes."""
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text, peaks,
                                                          sdpa_ms, time_ms)

    gen = torch.Generator(device=device).manual_seed(12)
    total, bounds = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0), []
    for shape in PATH_SHAPES + [D192_SHAPE]:
        q, k, v, do = (torch.randn(shape, generator=gen, device=device) for _ in range(4))
        o, l = A.flash_attention_plain(q, k, v, return_l=True)
        args = (q, k, v, o, do, l)
        got = A.flash_attention_bwd_f32(*args)
        torch.cuda.synchronize()
        again = A.flash_attention_bwd_f32(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd_f32 {shape}: two calls on the same inputs differ")
        ref = A.flash_attention_bwd_plain(*args)
        fault = _tf32_pass(torch, A.flash_attention_bwd_plain, *args)
        rel, fault_rel, abs_err = [], [], 0.0
        for name, g, f, r in zip(("dq", "dk", "dv"), got, fault, ref):
            diff = (g - r).abs().max().item()
            scale = max(r.abs().max().item(), 1e-30)
            rel.append(diff / scale)
            fault_rel.append((f - r).abs().max().item() / scale)
            abs_err = max(abs_err, diff)
            if not (rel[-1] <= F32_BWD_REL_TOL and torch.isfinite(g).all().item()):
                raise AssertionError(f"flash_attention_bwd_f32 {shape} {name}: max|err|/max|ref| {rel[-1]} > "
                                     f"{F32_BWD_REL_TOL} or not finite")
        if not max(fault_rel) > F32_BWD_REL_TOL:
            raise AssertionError(f"flash_attention_bwd_f32 {shape}: the planted fault (one TF32 pass) reads "
                                 f"{fault_rel}, within the limit {F32_BWD_REL_TOL}: the gate cannot tell 3xTF32 "
                                 "from it")
        del got, again, ref, fault
        k_ms = time_ms(lambda: A.flash_attention_bwd_f32(*args), reps=20)
        p_ms = time_ms(lambda: A.flash_attention_bwd_plain(*args), reps=3, warmup=1)
        lib_ms = sdpa_ms(q, k, v, do)
        bound = attention_roofline(peaks(card), shape, backward=True, f32=True)
        b, h, n, d = shape
        tflops = 10 * b * h * n * n * d / (k_ms * 1e-3) / 1e12
        log(f"  flash_attention_bwd_f32 B*H={b * h} N={n} D={d}: max|err|/max|ref| dq {rel[0]:.3e} dk {rel[1]:.3e} "
            f"dv {rel[2]:.3e} (tol {F32_BWD_REL_TOL}), max abs err {abs_err:.3e}, two calls bit-equal; the planted "
            f"fault (plain backward, one TF32 pass) dq {fault_rel[0]:.3e} dk {fault_rel[1]:.3e} dv {fault_rel[2]:.3e}: "
            f"breaks it; kernel {k_ms:.4f} ms ({tflops:.2f} TFLOP/s of the five f32 products a backward needs, in "
            f"3xTF32), plain {p_ms:.3f} ms, {bound_text(bound, k_ms)}, sdpa backward alone in f32 {lib_ms:.4f} ms "
            f"(yardstick, never called by the port)"
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
    version's; K2's forward alone; two K2 calls bit-equal. Then both with one
    scale a batch row (`per_item`, the server's): the quantizer equal to its
    plain version on the views, K2 within KERNEL_TOL of its plain version and
    two calls bit-equal, and on a batch whose row 1 is scaled 100x, row 0's
    int8 values, scale and K2 output equal to those of row 0 alone; their
    times beside the bound and the eager and sdpa times. Returns {name:
    dict(err, ms, plain_ms, library_ms, bound)} for "quantize_qk_i8" (one
    scale), "quantize_qk_i8_per_item" and "flash_attention_qk_i8_per_item",
    sums over the shapes in the UNet's layout (err: the largest difference of
    an int8 value or of a scale, which must be 0, and K2's max abs error)."""
    from weatherconverter_tpu_torch.probes.common import (add_rooflines, attention_roofline, bound_text, peaks,
                                                          quantizer_roofline, sdpa_ms, time_ms)

    gen = torch.Generator(device=device).manual_seed(20)
    zero = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=None)
    total, rows, k2_rows = dict(zero), dict(zero), dict(zero, library_ms=0.0)
    bounds, row_bounds, k2_bounds = [], [], []

    def views(qkv):
        b, n, _ = qkv.shape
        return [t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]  # as models/layers.py

    def same(got, ref, where):
        err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
        if not all(g.is_contiguous() and torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"quantize_qk_i8 {where}: differs from its plain version (largest difference {err})")
        return err

    for shape in PATH_SHAPES:
        b, h, n, d = shape
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = views(qkv)
        if q.is_contiguous() or A._row_strides(q) is None:
            raise AssertionError(f"quantize_qk_i8 {shape}: the head-split views are not read in place")
        ms = {}
        for layout, (ql, kl) in (("views", (q, k)), ("contiguous", (q.contiguous(), k.contiguous()))):
            got = A.quantize_qk_i8(ql, kl)
            torch.cuda.synchronize()
            err = same(got, A.quantize_qk_i8_plain(ql, kl), f"{shape} ({layout})")
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
            f"{pc_ms:.4f} ms, {bound_text(bound, k_ms)}; K2's forward alone {f_ms:.4f} ms")
        total = dict(total, err=max(total["err"], err), ms=total["ms"] + k_ms, plain_ms=total["plain_ms"] + p_ms)

        # one scale a batch row
        got = A.quantize_qk_i8(q, k, per_item=True)
        torch.cuda.synchronize()
        err = same(got, A.quantize_qk_i8_plain(q, k, per_item=True), f"{shape} (views, per row)")
        if got[2].shape != (b,):
            raise AssertionError(f"quantize_qk_i8 {shape} per row: scales of shape {tuple(got[2].shape)}")
        big = qkv.clone()
        big[1] *= 100  # row 1's maximum 100x the others': row 0 must not see it
        qb, kb, vb = views(big)
        mixed, alone = A.quantize_qk_i8(qb, kb, per_item=True), A.quantize_qk_i8(qb[:1], kb[:1], per_item=True)
        out_mixed, out_alone = (A.flash_attention_qk_i8(qb, kb, vb, per_item=True),
                                A.flash_attention_qk_i8(qb[:1], kb[:1], vb[:1], per_item=True))
        if not (torch.equal(mixed[0][:1], alone[0]) and torch.equal(mixed[1][:1], alone[1])
                and torch.equal(mixed[2][:1], alone[2]) and torch.equal(out_mixed[:1], out_alone)):
            raise AssertionError(f"per-row int8 {shape}: row 0 moved with row 1 (scaled 100x)")
        out = A.flash_attention_qk_i8(q, k, v, per_item=True)
        if not torch.equal(out, A.flash_attention_qk_i8(q, k, v, per_item=True)):
            raise AssertionError(f"flash_attention_qk_i8 per row {shape}: two calls on the same inputs differ")
        k2r_err, _ = _forward_gate(torch, "flash_attention_qk_i8 per row on head-split views", shape, out,
                                   A.flash_attention_qk_i8_plain(q, k, v, per_item=True))
        r_ms = time_ms(lambda: A.quantize_qk_i8(q, k, per_item=True), reps=20)
        rp_ms = time_ms(lambda: A.quantize_qk_i8_plain(q, k, per_item=True), reps=20)
        k2r_ms = time_ms(lambda: A.flash_attention_qk_i8(q, k, v, per_item=True), reps=20)
        k2rp_ms = time_ms(lambda: A.flash_attention_qk_i8_plain(q, k, v, per_item=True), reps=5)
        fr_ms = time_ms(lambda: A.flash_qk_i8_forward(*got, vc), reps=20)
        lib_ms = sdpa_ms(q, k, v)
        r_bound, k2_bound = quantizer_roofline(peaks(card), shape, scales=b), attention_roofline(peaks(card), shape,
                                                                                                  qk_int8=True)
        row_bounds.append(r_bound)
        k2_bounds.append(k2_bound)
        log(f"  per row (one int8 scale a batch row) B*H={b * h} N={n} D={d}: the quantizer equals its plain version "
            f"on the views, row 0 of a batch whose row 1 is x100 equals row 0 alone (int8, scale, K2's output); K2 "
            f"max_abs_err {k2r_err:.3e} (tol {KERNEL_TOL}), two calls bit-equal; quantizer {r_ms:.4f} ms (one scale "
            f"{k_ms:.4f}), eager {rp_ms:.4f} ms, {bound_text(r_bound, r_ms)}; K2 whole {k2r_ms:.4f} ms, its forward "
            f"alone {fr_ms:.4f} ms (one scale {f_ms:.4f}), plain {k2rp_ms:.3f} ms, {bound_text(k2_bound, k2r_ms)}, "
            f"sdpa forward "
            f"{lib_ms:.4f} ms (yardstick)")
        rows = dict(rows, err=max(rows["err"], err), ms=rows["ms"] + r_ms, plain_ms=rows["plain_ms"] + rp_ms)
        k2_rows = dict(err=max(k2_rows["err"], k2r_err), ms=k2_rows["ms"] + k2r_ms,
                       plain_ms=k2_rows["plain_ms"] + k2rp_ms, library_ms=k2_rows["library_ms"] + lib_ms)
        del qkv, q, k, v, vc, got, out, big, qb, kb, vb, mixed, alone, out_mixed, out_alone
    return {"quantize_qk_i8": dict(total, bound=add_rooflines(*bounds)),
            "quantize_qk_i8_per_item": dict(rows, bound=add_rooflines(*row_bounds)),
            "flash_attention_qk_i8_per_item": dict(k2_rows, bound=add_rooflines(*k2_bounds))}


def phase_unet_256(torch, A, device):
    """One forward and backward of the default ladder at im_size 256 (batch 1,
    random weights from a seed) under bf16 autocast: its twelve flash-length
    layers, four of them at D = 192, go through K1 and K3; and in f32 (TF32
    off) through K1-f32 and K3-f32. With qk_int8 a forward takes K2 at all
    twelve under bf16, and in f32 K2-f32 at all twelve (the CLI's f32 UNet
    at 256 px)."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.core.precision import f32_arithmetic
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    model = Unet(UnetModelConfig(im_size=256)).to(device)
    shapes = [s for s in model.attention_shapes(256) if A.is_flash_length(s[0])]
    x = torch.randn((1, 3, 256, 256), generator=torch.Generator(device=device).manual_seed(7), device=device)
    A.flash_attention_f32.launches = A.flash_attention_bwd_f32.launches = 0
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        out = model(x, 5)
        out.square().mean().backward()
    torch.cuda.synchronize()
    counts = (A.flash_attention_f32.launches, A.flash_attention_bwd_f32.launches)
    if counts != (len(shapes),) * 2 or not torch.isfinite(out).all().item():
        raise AssertionError(f"256 px UNet in f32: launches (K1-f32, K3-f32) {counts}, expected {len(shapes)} each; "
                             "or not finite")
    log(f"  the default UNet at im_size 256, batch 1, f32 (TF32 off): forward and backward in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms (first call), K1-f32 and K3-f32 launched {counts[0]} times each")
    model.zero_grad(set_to_none=True)
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
        f"(N, D) = {sorted(set(shapes))}")
    # what the CLI builds on the card: qk_int8, which takes K2 in every flash-length layer, D = 192 included
    int8 = Unet(UnetModelConfig(im_size=256), qk_int8=True).to(device).eval()
    int8.load_state_dict(model.state_dict())
    kinds = [kind for _, _, kind in int8.attention_kernels(256)]
    A.flash_attention_f32.launches = A.flash_attention_qk_i8.launches = 0
    A.flash_attention_qk_i8.launches_by_dtype, A.flash_attention_qk_i8.launches_by_head_dim = {}, {}
    with torch.no_grad(), f32_arithmetic(device):
        out = int8(x, 5)
    torch.cuda.synchronize()
    by_d = dict(A.flash_attention_qk_i8.launches_by_head_dim)
    if (A.flash_attention_f32.launches, A.flash_attention_qk_i8.launches_by_dtype) != (0, {"float32": 12}) \
            or by_d.get(192) != 4 or not torch.isfinite(out).all().item():
        raise AssertionError(f"256 px UNet with qk_int8 in f32: K1-f32 {A.flash_attention_f32.launches}, K2 by dtype "
                             f"{A.flash_attention_qk_i8.launches_by_dtype} (12 in float32 expected), by head dim "
                             f"{by_d} (4 at D = 192); or not finite")
    log(f"  the same UNet with qk_int8 in f32 (TF32 off; the CLI's on the card): K2-f32 at all 12 flash-length layers, "
        f"by head dim {by_d}; output finite")
    A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
    A.flash_attention_qk_i8.launches_by_head_dim = {}
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        out = int8(x, 5)
    torch.cuda.synchronize()
    counts = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    expected = (kinds.count("K1"), kinds.count("K2"), kinds.count("K2"))
    by_d = dict(A.flash_attention_qk_i8.launches_by_head_dim)
    if counts != expected or expected != (0, 12, 12) or by_d.get(192) != 4 or not torch.isfinite(out).all().item():
        raise AssertionError(f"256 px UNet with qk_int8: launches (K1, K2, quantizer) {counts}, expected {expected} "
                             f"= (0, 12, 12), K2 by head dim {by_d} (4 at D = 192); or not finite")
    log(f"  the same UNet with qk_int8 under bf16 autocast: a forward takes K2 and its quantizer at all its "
        f"{counts[1]} flash-length layers, by head dim {by_d} (4 at D = 192); output finite")
    return by_d[192]


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
    algorithms; WARMUP_STEPS steps each, which take every kind of step the
    timed runs take), then REPEATS rounds that time each variant in turn, so
    drift on the shared host spreads over all alike. Peak memory is read per
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
        fn, warm = (make_translate_fn(model, sched, seg, gen, dtype=torch.bfloat16,
                                      **{**dict(num_steps=n, start_t=n - 1, mode="fixed", guidance_style="gsg"), **kw})
                    for n in (steps, WARMUP_STEPS))
        warm(inp, labels, torch.Generator(device=device).manual_seed(2))
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
        events = _kernel_events(torch, prof)
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
    bf16 error of the gradient grows relative to the gradient itself.
    Returns what phase 24 (a) holds its f32 card step against: the weights,
    the draws, the CPU step's loss and gradient, and this step's readings."""
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
    loss_rel, grad_rel = _step_errors(l_card, g_card, l_cpu, g_cpu)
    log(f"  card bf16 vs CPU f32, one train step at batch 2: loss {l_card:.6f} vs {l_cpu:.6f}, relative error "
        f"{loss_rel:.3e} (tol {TRAIN_LOSS_REL_TOL}); UNet gradient relative L2 error {grad_rel:.3e} "
        f"(tol {TRAIN_GRAD_REL_TOL}); CPU step {cpu_s:.1f} s")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"card and CPU train steps disagree: loss {loss_rel}, gradient {grad_rel}")
    return dict(model=reference_model, images=images, offsets=offsets, flip=flip, t=t, noise=noise,
                cpu=(l_cpu, g_cpu), bf16=(loss_rel, grad_rel))


def _step_errors(l_card, g_card, l_cpu, g_cpu):
    """(relative error of the loss, relative L2 error of the flattened gradient) of a card step against the CPU's."""
    return abs(l_card - l_cpu) / abs(l_cpu), ((g_card - g_cpu).norm() / g_cpu.norm()).item()


def phase_train_f32(torch, A, device, card, tmp, reference, dcfg=None, steps=4, window_steps=3):
    """DDPM training with training.dtype float32 on the card: K1-f32 forward
    and K3-f32 backward at every flash-length layer, convolutions and
    matmuls with TF32 off (core/precision.f32_arithmetic).
    (a) One f32 train step at batch 2 held against phase 7's CPU f32 step
    (`reference`: the same weights, t, noise, crop and flip; its CPU result
    reused): the loss's relative error and the UNet gradient's relative L2
    error within F32_TRAIN_*_REL_TOL, which phase 7's bf16 step, the planted
    fault, must break.
    (b) `train-ddpm --set training.dtype=float32` through the CLI at
    configs/diffusion.yaml's model, batch 8, on phase 13's synthetic tree
    (32 images under `tmp`/data: one epoch of `steps` steps, so the epoch's
    checkpoint is written; --max-steps would stop before it, as in JAX's
    loop): exit 0, finite losses, a checkpoint that restores at step
    `steps`; K1-f32 and K3-f32 launched as unet_attention_shapes predicts
    (8 a step each), K1 and K3 never.
    (c) The augmented f32 train step at batch 8 on one batch: wall ms a step
    over `window_steps`, device ms a step, idle share and launches from a
    profiled run, peak GiB.
    Returns the K1-f32 and K3-f32 launches that (b)'s counters read."""
    import copy

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.config import load_diffusion_config
    from weatherconverter_tpu_torch.core.precision import f32_arithmetic
    from weatherconverter_tpu_torch.data.transforms import diffusion_train_augment
    from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
    from weatherconverter_tpu_torch.models.unet import Unet, unet_attention_shapes
    from weatherconverter_tpu_torch.training import loop_diffusion
    from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state, train_step

    on_card = device.type == "cuda"
    counters = (A.flash_attention, A.flash_attention_bwd, A.flash_attention_f32, A.flash_attention_bwd_f32)

    def zero():
        for c in counters:
            c.launches = 0

    def counts():
        return tuple(c.launches for c in counters)

    # (a)
    model = copy.deepcopy(reference["model"]).to(device)
    state = create_ddpm_state(model, lr=1e-4)
    x = diffusion_train_augment(reference["images"].to(device), crop=128, offsets=reference["offsets"],
                                flip=reference["flip"].to(device))
    flash = sum(A.is_flash_length(n) for n, _ in model.attention_shapes(128))
    zero()
    with f32_arithmetic(device):
        _, loss = train_step(state, x, make_schedule("linear", 1000, device=device), t=reference["t"].to(device),
                             noise=reference["noise"].to(device))
    grad = torch.cat([p.grad.float().flatten() for p in model.parameters()]).cpu()
    got = counts()
    if on_card and got != (0, 0, flash, flash):
        raise AssertionError(f"f32 train step: launches (K1, K3, K1-f32, K3-f32) {got}, expected (0, 0, {flash}, "
                             f"{flash})")
    loss_rel, grad_rel = _step_errors(loss.item(), grad, *reference["cpu"])
    bf16_loss, bf16_grad = reference["bf16"]
    log(f"  (a) card f32 vs CPU f32, one train step at batch 2 (phase 7's weights, draws and CPU step): loss relative "
        f"error {loss_rel:.3e} (tol {F32_TRAIN_LOSS_REL_TOL}), UNet gradient relative L2 error {grad_rel:.3e} (tol "
        f"{F32_TRAIN_GRAD_REL_TOL}); the planted fault, phase 7's bf16 step: {bf16_loss:.3e} and {bf16_grad:.3e}; "
        f"launches K1-f32 {got[2]}, K3-f32 {got[3]}")
    if not (loss_rel <= F32_TRAIN_LOSS_REL_TOL and grad_rel <= F32_TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"f32 card and CPU train steps disagree: loss {loss_rel}, gradient {grad_rel}")
    if on_card and not (bf16_loss > F32_TRAIN_LOSS_REL_TOL and bf16_grad > F32_TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"the f32 limits do not reject phase 7's bf16 step ({bf16_loss}, {bf16_grad})")
    del model, state, x, grad
    torch.cuda.empty_cache()

    # (b)
    dcfg = dcfg or os.path.join(REPO, "configs", "diffusion.yaml")
    run = os.path.join(tmp, "train_f32")
    argv = ["train-ddpm", "--config", dcfg, "--set", "training.dtype=float32",
            f"data.root_dir={os.path.join(tmp, 'data')}", "data.acdc_images=rgb_anon", 'data.weather=["fog"]',
            f"training.batch_size={BATCH}", "training.num_workers=0", "training.log_interval=1", "training.epochs=1",
            "training.save_interval=1", f"folders.output={run}"]
    argv += [] if on_card else ["--device", "cpu"]
    model_cfg = load_diffusion_config(dcfg).model
    flash = sum(A.is_flash_length(n) for n, _ in unet_attention_shapes(model_cfg, model_cfg.im_size))
    zero()
    t0 = time.perf_counter()
    code = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_got = got = counts()
    expected = (0, 0, flash * steps, flash * steps) if on_card else (0, 0, 0, 0)
    if code != 0 or got != expected:
        raise AssertionError(f"cli train-ddpm f32: exit {code}, launches (K1, K3, K1-f32, K3-f32) {got}, expected 0 "
                             f"and {expected}")
    with open(os.path.join(run, "0", "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    if len(losses) != steps or not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"cli train-ddpm f32: {steps} finite losses expected, got {losses}")
    fresh = create_ddpm_state(Unet(model_cfg).to(device), lr=1e-4)
    loop_diffusion.ckpt_restore_into(os.path.join(run, "0", "checkpoints"), fresh)
    if fresh.step != steps:
        raise AssertionError(f"cli train-ddpm f32: the checkpoint's step {fresh.step}, expected {steps}")
    log(f"  (b) cli train-ddpm --set training.dtype=float32, batch {BATCH}, {steps} steps: exit 0 in {cli_s:.1f} s "
        f"(model from the seed, cuDNN's first shapes included), losses {', '.join(f'{l:.4f}' for l in losses)}, "
        f"checkpoint restored at step {fresh.step}; launches K1/K3/K1-f32/K3-f32 {'/'.join(map(str, got))} "
        f"({flash} a step each for the f32 kernels)")

    # (c)
    state = fresh
    del fresh
    step_fn = loop_diffusion.make_augmented_train_step(make_schedule("linear", 1000, device=device), model_cfg.im_size)
    batch = torch.stack([torch.from_numpy(SyntheticImages(BATCH, seed=1)[i]) for i in range(BATCH)]).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    with f32_arithmetic(device):
        step_fn(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        for _ in range(window_steps):
            _, loss = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / window_steps
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (loss.item() == loss.item() and abs(loss.item()) < float("inf")):
            raise AssertionError(f"f32 train step: loss {loss.item()}")
        if on_card:
            prof_wall, dev_ms, launches, ranked = _device_profile(torch, lambda: step_fn(state, batch, gen), 1,
                                                                  top=10**6)
            # the f32 flash kernels' device ms in that step: K1-f32's forwards, K3-f32's two passes
            fwd_ms, bwd_ms = (sum(ms for name, ms, _ in ranked if kernel in name)
                              for kernel in ("flash_fwd_f32", "flash_bwd_f32"))
    if on_card and got != (0, 0, flash * window_steps, flash * window_steps):
        raise AssertionError(f"f32 train window: launches (K1, K3, K1-f32, K3-f32) {got}")
    log(f"  (c) f32 train step (augment + fwd + bwd + Adam + EMA) at batch {BATCH}: {wall:.1f} ms/step wall over "
        f"{window_steps} steps, {1e3 * BATCH / wall:.1f} images/s [{card}]; "
        + (f"a profiled step: wall {prof_wall:.1f} ms, device {dev_ms:.1f} ms, idle share "
           f"{max(0.0, 1 - dev_ms / prof_wall):.2f}, {launches} kernel launches, K1-f32 {fwd_ms:.2f} ms and K3-f32 "
           f"{bwd_ms:.2f} ms of device time (flash share {(fwd_ms + bwd_ms) / dev_ms:.1%}); " if on_card else "")
        + f"peak {peak:.2f} GiB; launches a step K1-f32 {got[2] // window_steps}, K3-f32 {got[3] // window_steps}")
    return cli_got[2], cli_got[3]


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
    events = _kernel_events(torch, prof)
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


def _device_profile(torch, fn, steps: int, top: int = 0):
    """(wall ms, kernel ms, kernel launches) of one run of `fn` under the
    profiler, device activity only; with `top`, also the `top` kernels of
    most device time as (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(torch, prof)
    total = (wall_ms, sum(e.device_time_total for e in events) / 1e3, sum(e.count for e in events))
    if not top:
        return total
    ranked = sorted(events, key=lambda e: -e.device_time_total)[:top]
    return total + ([(e.key, e.device_time_total / 1e3, e.count) for e in ranked],)


class _DeviceSum:
    """One name's device time (us) and launch count, as an entry of key_averages() gives them."""

    def __init__(self, key, device_time_total, count):
        self.key, self.device_time_total, self.count = key, device_time_total, count


def _kernel_events(torch, prof):
    """The device's events (kernels, copies, annotated ranges) summed by name, those of non-zero time: the
    entries of the profiler's key_averages() whose device type is CUDA, read from its raw events with the
    same filters. key_averages() first builds a tree of every event, host operators included, which took
    ~80 s of this script's run on the chains' tens of thousands of launches."""
    from torch.autograd.profiler import _filter_name

    cuda = torch.autograd.DeviceType.CUDA
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda or _filter_name(e.name()) or getattr(e, "is_hidden_event", lambda: False)()
                or e.is_async() or e.start_thread_id() != e.end_thread_id()):
            continue
        s = sums.setdefault(e.name(), [0.0, 0])
        s[0] += e.duration_ns() / 1e3
        s[1] += 1
    return [_DeviceSum(torch._C._demangle(k), us, n) for k, (us, n) in sums.items() if us > 0]


def phase_samplers(torch, A, device, models, card):
    """ddpm_sample, sample_with_sgg_ddim and sample_with_sgg_dpm at batch 8,
    each through K1 and through K2 with its quantizer: warm-up (PROFILE_STEPS
    steps each: the same shapes), then SAMPLER_REPEATS rounds timing each in turn (host clock, ending in a
    synchronize), the kernels counted in every run, peak memory per run; then one profiled run
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
            runner(p["kind"], p["model"], PROFILE_STEPS)(torch.Generator(device=device).manual_seed(29))
        torch.cuda.synchronize()
        for rep in range(SAMPLER_REPEATS):
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
        log(f"  {name}: {ms_step:.2f} ms/step wall (median of {SAMPLER_REPEATS} runs of {p['steps']} steps: "
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


def phase_int8_quality(torch, state, card, ddim: bool = True):
    """probes/int8_quality at the fast samplers, on phase 10's models and
    inputs: DPM at 20 steps, and DDIM at 50 when `ddim`, under bf16 autocast
    (K2 against K1); then DPM at 20 steps in f32 as the CLI runs it (K2-f32
    against K1-f32, TF32 off) against a floor of INT8_FLOOR_SEEDS runs.
    Fails on a non-finite or misshapen output or a launch-count mismatch,
    never on the verdict."""
    from weatherconverter_tpu_torch.probes import int8_quality

    unet, unet_i8, seg, gen, sched, inp, gt = state
    if not ddim:
        log(f"  the DDIM half is left out: the run reached phase 12 after {INT8_DDIM_BEFORE_S} s (its verdict, PASS at "
            "50 steps, is recorded in PERF.md)")
    for sampler, steps in (("dpm", DPM_STEPS), ("ddim", DDIM_STEPS))[:2 if ddim else 1]:
        t0 = time.perf_counter()
        artifact, outs = int8_quality.run((unet, unet_i8, seg, gen), sched, inp, gt, sampler, steps, INT8_FLOOR_SEEDS,
                                          torch.bfloat16, card)
        int8_quality.check_launches(outs, steps)
        int8_quality.report(artifact, log)
        log(f"  {len(outs)} chains in {time.perf_counter() - t0:.1f} s; wrote {int8_quality.save(artifact)}")
    t0 = time.perf_counter()
    artifact, outs = int8_quality.run((unet, unet_i8, seg, gen), sched, inp, gt, "dpm", DPM_STEPS,
                                      INT8_FLOOR_SEEDS, None, card)
    int8_quality.check_launches(outs, DPM_STEPS)
    int8_quality.report(artifact, log)
    log(f"  {len(outs)} f32 chains in {time.perf_counter() - t0:.1f} s; wrote {int8_quality.save(artifact)}")


def _synthetic_pair(path_img, path_lbl, seed, classes=19, size=(2048, 1024)):
    """A (1024, 2048) RGB image and a labelIds map of `classes` train classes
    in vertical stripes (raw Cityscapes ids), both from `seed`, as PNGs."""
    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.data.labels import LABELS

    rng = np.random.default_rng(seed)
    w, h = size
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path_img)
    raw = rng.permutation([l.id for l in LABELS if l.trainId != 255])[:classes]
    Image.fromarray(np.repeat(raw[(np.arange(w) * classes) // w][None], h, 0).astype(np.uint8)).save(path_lbl)


class _Recorder:
    """Wraps utils.images.to_uint8_image: records whether each array it casts
    is finite and inside [0, 1] ('unit') or [-1, 1] ('pm1')."""

    def __init__(self, images):
        self.images, self.inner, self.seen = images, images.to_uint8_image, []

    def __enter__(self):
        def wrapped(x, from_range="pm1"):
            import numpy as np

            a = np.asarray(x.detach().float().cpu() if hasattr(x, "detach") else x, dtype=np.float32)
            lo = 0.0 if from_range == "unit" else -np.inf  # samples are unclamped [-1, 1]-ish before the cast
            self.seen.append((tuple(a.shape), bool(np.isfinite(a).all() and a.min() >= lo and
                                                   (from_range != "unit" or a.max() <= 1.0))))
            return self.inner(x, from_range)

        self.images.to_uint8_image = wrapped
        return self

    def __exit__(self, *exc):
        self.images.to_uint8_image = self.inner


def phase_cli(torch, A, device, card, tmp, tcfg=None, dcfg=None):
    """The port's CLI in-process (main([...])) at configs/translation.yaml and
    configs/diffusion.yaml, seeded random weights, a synthetic 2048 x 1024
    image and labelIds map, every inference command in f32 as JAX's:
    translate (DPM-20 and DDIM-50 on K2-f32, DPM-20 with --no-int8-attn on
    K1-f32), sample (DPM-20, batch 8, K2-f32), super-resolve (128 px to 512
    px), train-ddpm (4 steps at configs/diffusion.yaml's training.dtype,
    bfloat16: K1 and K3); then one translate as a fresh process. Gates: exit
    0, the PNGs' shapes, finite values in [0, 1] before the uint8 cast, the
    kernels' launch counts, K2's and its quantizer's all on f32 inputs (no
    bf16 K2, no bf16 autocast on those paths). Returns the K2-f32 launches of
    the first translate (DPM-20)."""
    import subprocess

    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.cli import commands
    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.utils import images

    from weatherconverter_tpu_torch.core.config import load_diffusion_config

    tcfg = tcfg or os.path.join(REPO, "configs", "translation.yaml")
    dcfg = dcfg or os.path.join(REPO, "configs", "diffusion.yaml")
    cfg = load_translation_config(tcfg)
    size, up, ds = cfg.diffusion.model.im_size, cfg.srgan.upscale_factor, load_diffusion_config(dcfg).model.im_size
    hr = size * up
    img, lbl, small = (os.path.join(tmp, n) for n in ("img.png", "lbl.png", "small.png"))
    _synthetic_pair(img, lbl, seed=50)
    Image.open(img).resize((size, size)).save(small)
    data = os.path.join(tmp, "data", "rgb_anon", "fog", "train")
    os.makedirs(data)
    rng = np.random.default_rng(51)
    for i in range(BATCH * 4):
        Image.fromarray(rng.integers(0, 256, (2 * ds, 2 * ds * 16 // 9, 3), dtype=np.uint8)).save(
            os.path.join(data, f"{i}.png"))
    unet_calls = lambda steps: FLASH_CALLS_PER_UNET * steps  # noqa: E731
    out = lambda name: os.path.join(tmp, name)  # noqa: E731
    translate = ["translate", "--config", tcfg, "--image", img, "--label", lbl]
    grid = (hr + 4, hr + 4, 3)  # one image in a grid's 2 px border
    runs = [  # argv, output, its PNG shape, launches (K1, K2, quantizer, K3, K1-f32)
        (translate + ["--sampler", "dpm", "--out", out("dpm.png")], out("dpm.png"), grid,
         (0, unet_calls(20), unet_calls(20), 0, 0)),
        (translate + ["--sampler", "ddim", "--steps", str(DDIM_STEPS), "--out", out("ddim.png")], out("ddim.png"),
         grid, (0, unet_calls(DDIM_STEPS), unet_calls(DDIM_STEPS), 0, 0)),
        (translate + ["--sampler", "dpm", "--no-int8-attn", "--out", out("dpm_k1.png")], out("dpm_k1.png"),
         grid, (0, 0, 0, 0, unet_calls(20))),
        (["sample", "--config", dcfg, "--sampler", "dpm", "--steps", "20", "--batch", str(BATCH), "--out",
          out("sample.png")], out("sample.png"), (2 + 2 * (ds + 2), 2 + 4 * (ds + 2), 3),
         (0, unet_calls(20), unet_calls(20), 0, 0)),
        (["super-resolve", "--config", tcfg, "--image", small, "--out", out("sr.png")], out("sr.png"), (hr, hr, 3),
         (0, 0, 0, 0, 0)),
        (["train-ddpm", "--config", dcfg, "--max-steps", "4", "--set", f"data.root_dir={os.path.join(tmp, 'data')}",
          "data.acdc_images=rgb_anon", 'data.weather=["fog"]', f"training.batch_size={BATCH}",
          "training.num_workers=0", "training.log_interval=1", f"folders.output={out('train')}"], None, None,
         (unet_calls(4), 0, 0, unet_calls(4), 0)),
    ]
    on_card = device.type == "cuda"  # the CLI's default; a CPU rehearsal passes --device cpu, and counts nothing
    counters = (A.flash_attention, A.flash_attention_qk_i8, A.quantize_qk_i8, A.flash_attention_bwd,
                A.flash_attention_f32)
    cli_s = k2_f32 = None
    for argv, path, shape, expected in runs:
        argv = argv if on_card else argv + ["--device", "cpu"]
        expected = expected if on_card else (0, 0, 0, 0, 0)
        for fn in counters:
            fn.launches = 0
        A.flash_attention_qk_i8.launches_by_dtype, A.quantize_qk_i8.launches_by_dtype = {}, {}
        t0 = time.perf_counter()
        with _Recorder(images) as rec:
            code = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = tuple(fn.launches for fn in counters)
        # K2 and its quantizer only on f32 inputs: the inference commands run no bf16 autocast
        f32_only = all(set(fn.launches_by_dtype) <= {"float32"} for fn in (A.flash_attention_qk_i8, A.quantize_qk_i8))
        if code != 0 or counts != expected or not f32_only:
            raise AssertionError(f"cli {argv[0]} {argv[-2:]}: exit {code}, launches (K1, K2, quantizer, K3, K1-f32) "
                                 f"{counts}, expected 0 and {expected}; K2 by V's dtype "
                                 f"{A.flash_attention_qk_i8.launches_by_dtype}, the quantizer's "
                                 f"{A.quantize_qk_i8.launches_by_dtype} (float32 only)")
        if k2_f32 is None:
            k2_f32 = counts[1]
        if path is not None:
            got = np.asarray(Image.open(path)).shape
            if got != shape or not rec.seen or not all(ok for _, ok in rec.seen):
                raise AssertionError(f"cli {argv[0]}: PNG {got}, expected {shape}; before the uint8 cast "
                                     f"{rec.seen} (shape, finite and in range)")
        elif not os.path.isfile(os.path.join(out("train"), "0", "metrics.jsonl")):
            raise AssertionError("cli train-ddpm: no metrics.jsonl")
        if cli_s is None:
            cli_s = secs
        flags = [a if i + 1 == len(argv) or argv[i + 1].startswith("--") else f"{a} {argv[i + 1]}"
                 for i, a in enumerate(argv) if a.startswith("--") and a not in ("--config", "--image", "--label",
                                                                                  "--out", "--set")]
        log(f"  cli {argv[0]} {' '.join(flags)}: exit 0 in {secs:.1f} s (models built from the seed, first-shape "
            f"autotuning included); launches K1/K2/quantizer/K3/K1-f32 {'/'.join(map(str, counts))}, K2 by V's dtype "
            f"{A.flash_attention_qk_i8.launches_by_dtype}" + (f"; PNG {shape}" if shape else ""))
    # the library path of the first run: the same chain on models built once, timed alone
    unet, seg, sr, sched = commands.build_translation(cfg, device, None, None, None, on_card, 0)
    fn = commands.fast_translate_fn("dpm", unet, sched, seg, sr, device, lam=cfg.guidance.lambda_, num_steps=20,
                                    span_t=cfg.guidance.num_steps, num_classes=cfg.seg.model.num_classes,
                                    lcg_present_k=commands._resolve_lcg_present_k("auto", _gt(lbl, hr),
                                                                                  cfg.seg.model.num_classes))
    x = torch.from_numpy(commands._load_image(img, size) * 2.0 - 1.0)[None].to(device)
    gt = torch.from_numpy(_gt(lbl, hr).astype(np.int64))[None].to(device)
    fn(x, gt, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(x, gt, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    # a fresh process through the console entry point's function
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys; from weatherconverter_tpu_torch.cli.main import main; "
                           "sys.exit(main())"] + translate + ["--sampler", "dpm", "--out", out("fresh.png")]
                          + ([] if on_card else ["--device", "cpu"]), cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0 or np.asarray(Image.open(out("fresh.png"))).shape != grid:
        raise AssertionError(f"cli translate in a fresh process: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    log(f"  one DPM-20 translation at batch 1 ({hr} px out, f32, K2-f32 on the card): the CLI in-process {cli_s:.2f} "
        f"s, in a fresh process {fresh_s:.2f} s (interpreter, imports, kernel library load, models from the seed, "
        f"autotuning), the library path's chain alone on built, warm models {lib_s:.2f} s [{card}]")
    return k2_f32


def _gt(lbl_path, hr):
    """A labelIds PNG as the CLI reads it: nearest-resized to (hr, hr), train ids."""
    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.data.labels import encode_target

    return encode_target(np.asarray(Image.open(lbl_path).resize((hr, hr), Image.NEAREST), dtype=np.uint8))


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))]


def phase_server(torch, A, device, card, tmp, tcfg=None, steps=None):
    """The server on the card at configs/translation.yaml, sampler dpm at
    `steps` (its default, 20, when None), batch 4: SERVER_TRANSLATIONS concurrent
    /v1/translate requests (labels of 3-19 classes drawn from a seed) and
    SERVER_SAMPLES /v1/sample requests, the chains in f32 as the JAX
    service's, on K2-f32 with one int8 scale a request (the server's
    default) under lcg_present_k='auto' and under the full sweep, and on
    K1-f32 (--no-int8-attn) under the full sweep; after each full sweep, one
    seed solo twice and co-batched with three others. Gates: every response
    200 with a PNG of the right shape, /stats counts that add up, K2-f32 (K2
    on f32 V only) and no K1 or K1-f32 launched (K1-f32 and no K2 with
    --no-int8-attn), the co-batched image within (two solo runs' difference
    + 1) uint8 levels of the solo one, under K2-f32 as under K1-f32, with
    the quantizer launched once for each K2 launch, on f32 q and k only. Then
    one batched chain of the K2 service under bf16 autocast (the library's
    bf16 path with one int8 scale a row: K2 on bf16 V and the quantizer on
    bf16 q and k, each launched once a UNet layer a step and in no other
    dtype). Returns K2-f32's launches in its full-sweep run, and K2's and
    the quantizer's in that bf16 chain."""
    import base64
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.serving.server import TranslationService, serve

    rng = np.random.default_rng(60)
    classes = [int(c) for c in rng.integers(3, 20, SERVER_TRANSLATIONS)]
    payloads = []
    for i, k in enumerate(classes):
        _synthetic_pair(os.path.join(tmp, f"s{i}.png"), os.path.join(tmp, f"l{i}.png"), seed=100 + i, classes=k)
        payloads.append({name: base64.b64encode(open(os.path.join(tmp, f"{p}{i}.png"), "rb").read()).decode()
                         for name, p in (("image", "s"), ("label", "l"))})
    cfg = load_translation_config(tcfg or os.path.join(REPO, "configs", "translation.yaml"))
    hr, size = cfg.diffusion.model.im_size * cfg.srgan.upscale_factor, cfg.diffusion.model.im_size
    on_card = device.type == "cuda"

    def post(base, path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            code, body = r.status, json.load(r)
        png = np.asarray(Image.open(__import__("io").BytesIO(base64.b64decode(body["image"]))))
        return code, png, time.perf_counter() - t0

    def traffic(base):
        results = {}

        def worker(key, path, payload):
            results[key] = post(base, path, payload)

        threads = [threading.Thread(target=worker, args=(("t", i), "/v1/translate", dict(p, seed=i)))
                   for i, p in enumerate(payloads)]
        threads += [threading.Thread(target=worker, args=(("s", i), "/v1/sample", {"steps": steps or 20, "seed": i}))
                    for i in range(SERVER_SAMPLES)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results, time.perf_counter() - t0

    summary, k2_launches, k2_bf16, quant_bf16 = {}, 0, 0, 0
    for name, present_k, int8 in (("auto, K2-f32", "auto", True), ("full sweep, K2-f32", None, True),
                                  ("full sweep, K1-f32 (--no-int8-attn)", None, False)):
        t0 = time.perf_counter()
        service = TranslationService(cfg, batch=4, sampler="dpm", max_wait_ms=100.0, lcg_present_k=present_k,
                                     device=device, steps=steps, qk_int8=int8 and on_card)
        warm_s = time.perf_counter() - t0
        httpd = serve(service, port=0, block=False, host="127.0.0.1")
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            torch.cuda.reset_peak_memory_stats()
            A.flash_attention_qk_i8.launches = A.flash_attention.launches = A.quantize_qk_i8.launches = 0
            A.flash_attention_f32.launches, A.flash_attention_qk_i8.launches_by_dtype = 0, {}
            A.quantize_qk_i8.launches_by_dtype = {}
            results, wall = traffic(base)
            k1, k2, k1_f32 = A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.flash_attention_f32.launches
            k2_dtypes = dict(A.flash_attention_qk_i8.launches_by_dtype)
            quant_dtypes = dict(A.quantize_qk_i8.launches_by_dtype)
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                stats = json.load(r)
            peak = torch.cuda.max_memory_allocated() / 2**30
            bad = [(k, c, png.shape) for k, (c, png, _) in results.items()
                   if c != 200 or png.shape != ((hr, hr, 3) if k[0] == "t" else (size, size, 3))]
            tr = stats["translate"]
            buckets = stats.get("lcg_k_buckets", {})
            kernels_ok = (not on_card and k1 == k2 == k1_f32 == 0) or (
                on_card and k1 == 0 and ((int8 and k2 > 0 and k2_dtypes == quant_dtypes == {"float32": k2}
                                          and k1_f32 == 0 and A.quantize_qk_i8.launches == k2) or
                                         (not int8 and k1_f32 > 0 and k2 == 0)))
            if bad or len(results) != SERVER_TRANSLATIONS + SERVER_SAMPLES or tr["requests"] != SERVER_TRANSLATIONS \
                    or stats["sample"]["requests"] != SERVER_SAMPLES or not kernels_ok or (
                    present_k == "auto" and sum(buckets.values()) != SERVER_TRANSLATIONS):
                raise AssertionError(f"server ({name}): responses {bad}, stats {stats}, K1 / K2 / quantizer / K1-f32 "
                                     f"launches {k1} / {k2} / {A.quantize_qk_i8.launches} / {k1_f32}, K2 by V's "
                                     f"dtype {k2_dtypes}, the quantizer by q's {quant_dtypes}")
            if int8 and present_k is None:
                k2_launches = k2
            lat = [results[("t", i)][2] for i in range(SERVER_TRANSLATIONS)]
            summary[name] = dict(p50=_percentile(lat, 50), p95=_percentile(lat, 95),
                                 per_min=SERVER_TRANSLATIONS * 60.0 / wall)
            log(f"  server, lcg {name}: {SERVER_TRANSLATIONS} translations and {SERVER_SAMPLES} samples in {wall:.2f} "
                f"s; translation latency p50 "
                f"{summary[name]['p50']:.2f} s, p95 {summary[name]['p95']:.2f} s; {summary[name]['per_min']:.1f} "
                f"translations/min; translate batches {tr['batches']}, mean occupancy {tr['mean_occupancy']:.2f}; "
                f"sample batches {stats['sample']['batches']}; buckets {buckets or 'none (one width, 19 classes)'}; "
                f"labels' classes {classes}; peak device memory {peak:.2f} GiB; start-up with warm-up of "
                f"{len(service.shapes())} translate shapes {warm_s:.1f} s; K1-f32 / K2 launches {k1_f32} / {k2}, K2 "
                f"by V's dtype {k2_dtypes} [{card}]")
            if present_k is None:
                # one seed solo twice, then co-batched with three other seeds: one width (the full sweep pads
                # every batch to 4), so only the batch-mates change
                solo = [post(base, "/v1/translate", dict(payloads[0], seed=7))[1].astype(int) for _ in range(2)]
                co = {}

                def one(seed):
                    co[seed] = post(base, "/v1/translate", dict(payloads[0], seed=seed))[1].astype(int)

                threads = [threading.Thread(target=one, args=(s,)) for s in (7, 8, 9, 10)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                self_diff = int(np.abs(solo[0] - solo[1]).max())
                co_diff = int(np.abs(co[7] - solo[0]).max())
                log(f"  per-seed determinism ({name}, width 4): two "
                    f"solo runs of seed 7 differ by at most {self_diff} uint8 levels (mean "
                    f"{np.abs(solo[0] - solo[1]).mean():.4f}), the solo and co-batched (with seeds 8-10) images by "
                    f"{co_diff} (mean {np.abs(co[7] - solo[0]).mean():.4f}; gate: <= {self_diff + 1}); seeds 7 and 8 "
                    f"differ by {int(np.abs(co[7] - co[8]).max())}")
                if co_diff > self_diff + 1:
                    raise AssertionError(f"server: a co-batched seed moved {co_diff} levels, solo runs {self_diff}")
            if int8 and present_k is None:
                # the same per-row K2 service's chain under bf16 autocast: the library's bf16 path (K2 on bf16 V)
                A.flash_attention_qk_i8.launches_by_dtype, A.quantize_qk_i8.launches_by_dtype = {}, {}
                with torch.autocast(device.type, dtype=torch.bfloat16, enabled=on_card):
                    out = service.translate_rows(np.zeros((4, size, size, 3), np.float32),
                                                 np.zeros((4, hr, hr), np.int64), [0, 1, 2, 3])
                torch.cuda.synchronize()
                k2_bf16 = A.flash_attention_qk_i8.launches_by_dtype.get("bfloat16", 0)
                quant_bf16 = A.quantize_qk_i8.launches_by_dtype.get("bfloat16", 0)
                expected = {"bfloat16": FLASH_CALLS_PER_UNET * service.steps}
                by_dtype = (A.flash_attention_qk_i8.launches_by_dtype, A.quantize_qk_i8.launches_by_dtype)
                if (on_card and by_dtype != (expected, expected)) or not torch.isfinite(out).all():
                    raise AssertionError(f"server's chain under bf16 autocast: K2 by V's dtype "
                                         f"{A.flash_attention_qk_i8.launches_by_dtype}, the quantizer by q's "
                                         f"{A.quantize_qk_i8.launches_by_dtype}, expected {expected} each; or not "
                                         f"finite")
                log(f"  the same service's batched chain under bf16 autocast (batch 4, {service.steps} steps): K2 on "
                    f"bf16 V and its quantizer, one int8 scale a row, launched {k2_bf16} and {quant_bf16} times")
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.close()
            del service
            torch.cuda.empty_cache()
    for a, b in (("auto, K2-f32", "full sweep, K2-f32"), ("full sweep, K2-f32", "full sweep, K1-f32 (--no-int8-attn)")):
        log(f"  {a} against {b}: p50 {summary[a]['p50']:.2f} / {summary[b]['p50']:.2f} s, p95 {summary[a]['p95']:.2f} "
            f"/ {summary[b]['p95']:.2f} s, {summary[a]['per_min']:.1f} / {summary[b]['per_min']:.1f} "
            f"translations/min [{card}]")
    return k2_launches, k2_bf16, quant_bf16


def _synthetic_acdc(root, seed, pairs=SEG_PAIRS, size=SEG_SIZE, classes=19):
    """An ACDC tree under `root`: fog and rain, pairs[0] train and pairs[1] val
    image/labelIds pairs each, `size` = (W, H) PNGs made by _synthetic_pair
    from consecutive seeds. Returns root."""
    n = 0
    for cond in ("fog", "rain"):
        for split, count in zip(("train", "val"), pairs):
            for i in range(count):
                paths = [os.path.join(root, top, cond, split, "GP010", f"GP010_frame_{i:06d}_{kind}.png")
                         for top, kind in (("rgb_anon", "rgb_anon"), ("gt", "gt_labelIds"))]
                for path in paths:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                _synthetic_pair(*paths, seed=seed + n, classes=classes, size=size)
                n += 1
    return root


def _seg_breaks(c, limits):
    """The measures of a seg_step_parity comparison `c` outside `limits`
    (predictions: a floor; the rest: ceilings; NaN breaks either)."""
    value = lambda k: c[k][1] if k == "stats_worst" else c[k]  # noqa: E731
    return [k for k, lim in limits.items() if not (value(k) >= lim if k == "agree" else value(k) <= lim)]


def phase_seg(torch, device, card, tmp, scfg=None, pairs=SEG_PAIRS, size=SEG_SIZE):
    """Segmentation on the card at configs/segmentation.yaml: the trainer for 2
    epochs on a synthetic ACDC tree, timed windows of the augmented train step,
    one batch-2 step card against CPU (f32) in bf16 and in f32, then
    train-seg and infer-seg through the CLI. `scfg`, `pairs` and `size` make a
    tiny CPU rehearsal possible (no timing or profile there)."""
    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, restore_auto
    from weatherconverter_tpu_torch.core.config import load_seg_config
    from weatherconverter_tpu_torch.models.factory import make_seg_model
    from weatherconverter_tpu_torch.probes import seg_step_parity as SP
    from weatherconverter_tpu_torch.training import loop_segmentation
    from weatherconverter_tpu_torch.training.losses import make_seg_loss
    from weatherconverter_tpu_torch.training.segmentation import create_seg_state
    from weatherconverter_tpu_torch.utils import images

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else None
    scfg = scfg or os.path.join(REPO, "configs", "segmentation.yaml")
    t0 = time.perf_counter()
    root = _synthetic_acdc(os.path.join(tmp, "acdc"), 70, pairs, size)
    log(f"  synthetic ACDC tree: fog and rain, {pairs[0]} train and {pairs[1]} val pairs each, {size[0]} x {size[1]} "
        f"PNGs, in {time.perf_counter() - t0:.1f} s")

    # the trainer: 2 epochs, a validation and a checkpoint each
    out = os.path.join(tmp, "seg_train")
    cfg = load_seg_config(scfg, data={"root_dir": root}, folders={"output": out},
                          training={"epochs": 2, "log_interval": 1, "device": device.type})
    m, t = cfg.model, cfg.data.transform
    t0 = time.perf_counter()
    state = loop_segmentation.train(cfg)
    sync()
    loop_s = time.perf_counter() - t0
    steps = 2 * (2 * pairs[0] // cfg.training.batch_size)
    with open(os.path.join(out, "0", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    igs = [r["train/input_grad"] for r in records if "train/input_grad" in r]
    mious = [r["val/mIoU"] for r in records if "val/mIoU" in r]
    finite = lambda xs: all(x == x and abs(x) < float("inf") for x in xs)  # noqa: E731
    if state.step != steps or len(losses) != steps or not finite(losses) or not (finite(igs) and min(igs) > 0):
        raise AssertionError(f"seg train loop: step {state.step} (expected {steps}), losses {losses}, input "
                             f"gradient magnitudes {igs}")
    if len(mious) != 2 or not finite(mious):
        raise AssertionError(f"seg train loop: 'Mean IoU' of the 2 epochs {mious}")
    ckdir = os.path.join(out, "0", "checkpoints")
    mgr = CheckpointManager(ckdir, best_metric_name="Mean IoU")
    saved = {s: mgr.restore(step=s) for s in mgr.all_steps()}
    if sorted(saved) != [1, 2] or mgr.best_step() not in saved:
        raise AssertionError(f"seg train loop: checkpoints {sorted(saved)}, best step {mgr.best_step()}")
    a, b = saved[1]["model"], saved[2]["model"]
    params = [k for k, _ in state.model.named_parameters()]
    moved = sum((b[k].float() - a[k].float()).abs().sum().item() for k in params)
    bn_moved = sum((b[k] - a[k]).abs().sum().item() for k in b if k.endswith(("running_mean", "running_var")))
    if not (moved > 0 and bn_moved > 0):
        raise AssertionError(f"seg train loop: epoch 1 -> 2, |params| moved {moved}, BN statistics {bn_moved}")
    max_iters = 2 * pairs[0] // cfg.training.batch_size * cfg.training.epochs
    fresh = create_seg_state(make_seg_model(m.name, m.num_classes, m.output_stride, train=True,
                                            bn_momentum=m.bn_momentum).to(device), cfg.optimizer, max_iters)
    restore_auto(ckdir, fresh, prefer_best=True)
    _state_dicts_equal(torch, saved[mgr.best_step()], fresh.state_dict())
    del fresh
    log(f"  loop_segmentation.train ({m.name}, OS{m.output_stride}, {m.num_classes} classes, batch "
        f"{cfg.training.batch_size}, {cfg.training.num_workers} loader workers): {steps} steps and 2 validations in "
        f"{loop_s:.1f} s (model build, loader start-up and cuDNN's first trials included); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, input-gradient magnitude {igs[0]:.3e} -> {igs[-1]:.3e}, Mean IoU {mious}; epoch 1 -> 2 "
        f"|params| moved {moved:.3e}, BN statistics {bn_moved:.3e}; best step {mgr.best_step()} restored equal")

    # timed windows of the augmented step on one device-resident uint8 batch
    loss_fn = make_seg_loss(cfg.training.loss_function.type, cfg.training.loss_function.params)
    step_fn = loop_segmentation.make_augmented_seg_train_step(cfg, loss_fn, dtype=dtype)
    bsz, (h, w) = cfg.training.batch_size, t.resize_resolution
    g = torch.Generator(device=device).manual_seed(5)
    batch = torch.randint(0, 256, (bsz, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    labels = SP.stripes(bsz, h, w, g)
    if on_card:
        outs, profiled = [], 5
        times, peak, prof, flops = _timed_windows(
            torch, lambda: outs.append(step_fn(state, batch, labels, g)[1:]), WINDOWS, WINDOW_STEPS, profiled, top=5)
        if not finite([v.item() for o in outs for v in o]):
            raise AssertionError("seg train windows: a loss or input-gradient magnitude is not finite")
        log("  " + _window_line(f"seg train step (augment + fwd + bwd with the input gradient + SGD), uint8 ({h}, {w}) "
                                f"-> {tuple(t.target_resolution)} crops, bf16", bsz, times, peak, prof, flops,
                                profiled, card))
        for name, dev_ms, count in prof[3]:
            log(f"    {dev_ms / profiled:8.3f} ms/step {100 * dev_ms / prof[1]:5.1f}% x{count // profiled:<4d} "
                f"{name[:100]}")
        del outs
    del batch, labels

    # one step at batch 2 against the CPU (f32), the same seeded weights, damped, and draws: in f32 and in
    # bf16 as the trainer runs it, each held to every limit of its precision; then planted faults, each
    # of which the same limits must reject
    reference = SP.reference_model(cfg, SEG_RESIDUAL_SCALE)
    pooled, data = SP.pooled_leaves(reference), SP.batch(cfg, 2)
    cpu_ref = SP.run_step(cfg, reference, data, torch.device("cpu"))
    log(f"  one seg train step at batch 2, card against CPU f32 (CPU step {cpu_ref['seconds']:.1f} s), each residual "
        f"block's last BatchNorm scale x {SEG_RESIDUAL_SCALE}; limits {SEG_LIMITS}")
    for tag, fault in (("f32", None), ("bf16", None)) + SEG_CONTROLS:
        c = SP.compare(SP.run_step(cfg, reference, data, device, dtype if tag == "bf16" else None, fault), cpu_ref,
                       pooled)
        broken = _seg_breaks(c, SEG_LIMITS[tag])
        log(f"    {SP.line(f'card {tag}' + (f' with the fault {fault}' if fault else ''), c)}; outside its limits: "
            f"{', '.join(broken) or 'none'}")
        if fault is None and broken:
            raise AssertionError(f"card {tag} and CPU f32 seg train steps disagree on {broken}")
        if fault is not None and not broken:
            raise AssertionError(f"the card {tag} step with the planted fault {fault} ({SP.FAULTS[fault]}) passes "
                                 "every limit")
    del reference, cpu_ref
    del state
    if on_card:
        torch.cuda.empty_cache()

    # the CLI: train-seg, then infer-seg on its best step
    big_img, big_lbl = os.path.join(tmp, "seg_img.png"), os.path.join(tmp, "seg_lbl.png")
    _synthetic_pair(big_img, big_lbl, seed=80)
    cli_out, inf_out = os.path.join(tmp, "seg_cli"), os.path.join(tmp, "seg_infer")
    device_flag = [] if on_card else ["--device", "cpu"]
    ck = os.path.join(cli_out, "0", "checkpoints")
    runs = (["train-seg", "--config", scfg, "--max-steps", "4", "--set", f"data.root_dir={root}",
             f"folders.output={cli_out}"],
            ["infer-seg", "--config", scfg, "--checkpoint", ck, "--image", big_img, "--label", big_lbl, "--out",
             inf_out])
    th, tw = t.target_resolution
    for argv in runs:
        t0 = time.perf_counter()
        with _Recorder(images) as rec:
            code = cli_main(argv + device_flag)
        sync()
        secs = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"cli {argv[0]}: exit {code}")
        if argv[0] == "train-seg":
            best = CheckpointManager(ck, best_metric_name="Mean IoU").best_step()
            if best is None:
                raise AssertionError(f"cli train-seg: no best step under {ck}")
            log(f"  cli train-seg --max-steps 4: exit 0 in {secs:.1f} s; best step {best}")
            continue
        shapes = {n: np.asarray(Image.open(os.path.join(inf_out, f"{n}.png"))).shape
                  for n in ("pred", "gradient_magnitude", "panels")}
        want = {"pred": (th, tw, 3), "gradient_magnitude": (th, tw), "panels": (th, 6 * tw, 3)}
        if shapes != want or len(rec.seen) != 2 or not all(ok for _, ok in rec.seen):
            raise AssertionError(f"cli infer-seg: PNGs {shapes}, expected {want}; before the uint8 cast {rec.seen} "
                                 "(shape, finite and in range)")
        log(f"  cli infer-seg --checkpoint <that run's checkpoints> on a 2048 x 1024 image and labelIds map: exit 0 "
            f"in {secs:.1f} s; PNGs {shapes}, finite and in [0, 1] before the uint8 cast")
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")


def _timed_windows(torch, step, windows, window_steps, profiled, top=0):
    """(wall ms/step of each window, peak GiB, (profiled wall ms, device ms, launches[, top kernels]), FLOPs
    of one call) of `step()` on the card, after two warm-up calls; `top` as in _device_profile."""
    from torch.utils.flop_counter import FlopCounterMode

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(window_steps):
            step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / window_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _device_profile(torch, lambda: [step() for _ in range(profiled)], profiled, top)
    with FlopCounterMode(display=False) as counter:
        step()
    return times, peak, prof, counter.get_total_flops()


def _window_line(what, bsz, times, peak, prof, flops, profiled, card):
    """The report of `_timed_windows` for a step of `bsz` images."""
    wall, dev, launches = prof[:3]
    ms = statistics.median(times)
    bound = flops / 989e12 * 1e3
    return (f"{what} at batch {bsz}: {ms:.2f} ms/step (windows {', '.join(f'{x:.2f}' for x in times)}), "
            f"{1e3 * bsz / ms:.1f} images/s [{card}]; profiled {profiled} steps: device {dev / profiled:.2f} "
            f"ms/step, wall {wall / profiled:.2f}, idle share {max(0.0, 1 - dev / wall):.2f}, "
            f"{launches / profiled:.0f} launches a step; peak {peak:.2f} GiB; {flops / 1e12:.4f} TFLOP a step "
            f"(torch.utils.flop_counter) -> bound {bound:.4f} ms at 989 TFLOP/s bf16 ({100 * bound / ms:.2f} % "
            f"of the wall step)")


def _rel_l2(a, b):
    """||a - b|| / ||b|| over two lists of tensors, in f64 on the CPU."""
    num = sum(((x.double().cpu() - y.double().cpu()) ** 2).sum().item() for x, y in zip(a, b))
    den = sum((y.double().cpu() ** 2).sum().item() for y in b)
    return (num / den) ** 0.5 if den > 0 else float("nan")


def phase_seg_family(torch, device, card, scfg=None):
    """The rest of the DeepLab family on the card at configs/segmentation.yaml
    with the geometric legs on: each model a few augmented train steps
    (finite losses, parameters and BatchNorm statistics that move), timed and
    profiled windows, and an eval forward at batch 2 card f32 against CPU
    f32; HRNet's stem with a ReLU put back must break that comparison.
    `scfg` makes a tiny CPU rehearsal possible (no timing there)."""
    import copy

    from weatherconverter_tpu_torch.core.config import load_seg_config
    from weatherconverter_tpu_torch.data.transforms import seg_eval_preprocess
    from weatherconverter_tpu_torch.models.factory import make_seg_model
    from weatherconverter_tpu_torch.probes import seg_step_parity as SP
    from weatherconverter_tpu_torch.training import loop_segmentation
    from weatherconverter_tpu_torch.training.losses import make_seg_loss
    from weatherconverter_tpu_torch.training.segmentation import create_seg_state

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else None
    cfg = load_seg_config(scfg or os.path.join(REPO, "configs", "segmentation.yaml"),
                          data={"transform": SEG_GEOMETRIC})
    m, t = cfg.model, cfg.data.transform
    (h, w), bsz = t.resize_resolution, cfg.training.batch_size
    crop = tuple(t.target_resolution)
    g = torch.Generator(device=device).manual_seed(16)
    batch = torch.randint(0, 256, (bsz, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    labels = SP.stripes(bsz, h, w, g)
    step_fn = loop_segmentation.make_augmented_seg_train_step(
        cfg, make_seg_loss(cfg.training.loss_function.type, cfg.training.loss_function.params), dtype=dtype)
    cpu_g = torch.Generator().manual_seed(17)
    x_eval = seg_eval_preprocess(torch.randint(0, 256, (2, h, w, 3), generator=cpu_g, dtype=torch.uint8), crop=crop,
                                 mean=tuple(t.mean), std=tuple(t.std)).permute(0, 3, 1, 2).contiguous()
    log(f"  augment: crop {crop} of uint8 ({h}, {w}) with {SEG_GEOMETRIC}; batch {bsz}, "
        f"{'bf16 autocast' if on_card else 'f32'}; eval limits {FAMILY_EVAL_LIMITS}")

    def eval_compare(card_model, cpu_logits):
        with torch.no_grad():
            got = card_model(x_eval.to(device)).float().cpu()
        return _rel_l2([got], [cpu_logits]), (got.argmax(1) == cpu_logits.argmax(1)).float().mean().item()

    for name, separable in SEG_FAMILY:
        t0 = time.perf_counter()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = make_seg_model(name, m.num_classes, m.output_stride, train=True, bn_momentum=m.bn_momentum,
                                   separable=separable).to(device)
        state = create_seg_state(model, cfg.optimizer, 100)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        outs = [step_fn(state, batch, labels, g)[1:] for _ in range(FAMILY_STEPS)]
        sync()
        losses = [o[0].item() for o in outs]
        after = model.state_dict()
        params = [k for k, _ in model.named_parameters()]
        moved = sum((after[k] - before[k]).abs().sum().item() for k in params)
        bn_moved = sum((after[k] - before[k]).abs().sum().item() for k in after
                       if k.endswith(("running_mean", "running_var")))
        if not (all(x == x and abs(x) < float("inf") for x in losses) and moved > 0 and bn_moved > 0):
            raise AssertionError(f"{name}: losses {losses}, |params| moved {moved}, BN statistics {bn_moved}")
        head = f"  {name}{' (separable head)' if separable else ''}: {FAMILY_STEPS} steps in " \
               f"{time.perf_counter() - t0:.1f} s (build and cuDNN's first trials included), loss " \
               f"{losses[0]:.4f} -> {losses[-1]:.4f}, |params| moved {moved:.3e}, BN statistics {bn_moved:.3e}"
        log(head)
        if on_card:
            times, peak, prof, flops = _timed_windows(torch, lambda: step_fn(state, batch, labels, g), FAMILY_WINDOWS,
                                                      FAMILY_WINDOW_STEPS, FAMILY_PROFILED)
            log("    " + _window_line("train step (augment + fwd + bwd with the input gradient + SGD)", bsz, times,
                                      peak, prof, flops, FAMILY_PROFILED, card))
        model.eval()
        cpu_model = copy.deepcopy(model).cpu()
        with torch.no_grad():
            cpu_logits = cpu_model(x_eval).float()
        rel, agree = eval_compare(model, cpu_logits)
        log(f"    eval forward at batch 2, card f32 against CPU f32: logits' relative L2 error {rel:.3e}, "
            f"predictions equal {agree:.5f}")
        if not (rel <= FAMILY_EVAL_LIMITS["rel"] and agree >= FAMILY_EVAL_LIMITS["agree"]):
            raise AssertionError(f"{name}: card f32 eval forward against the CPU's: {rel:.3e}, {agree:.5f}")
        if name == "deeplabv3plus_hrnetv2_32":
            bn1 = model.backbone.bn1
            model.backbone.bn1 = torch.nn.Sequential(bn1, torch.nn.ReLU())
            f_rel, f_agree = eval_compare(model, cpu_logits)
            model.backbone.bn1 = bn1
            log(f"    planted fault, a ReLU between HRNet's stem convs: {f_rel:.3e}, {f_agree:.5f}")
            if f_rel <= FAMILY_EVAL_LIMITS["rel"] and f_agree >= FAMILY_EVAL_LIMITS["agree"]:
                raise AssertionError("the HRNet stem with a ReLU put back passes the eval limits")
        del model, state, cpu_model, before, after
        if on_card:
            torch.cuda.empty_cache()
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")


def _srgan_tree(root, n, size, seed=90):
    """`n` random (W, H) = `size` PNGs under <root>/ACDC/rgb_anon/fog/train; returns root."""
    import numpy as np
    from PIL import Image

    folder = os.path.join(root, "ACDC", "rgb_anon", "fog", "train")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
            os.path.join(folder, f"hr_{i:03d}.png"))
    return root


def phase_srgan(torch, device, card, tmp, overrides=None, images=SRGAN_IMAGES, size=SRGAN_SIZE):
    """SRGAN training on the card at the JAX defaults: loop_srgan.train for a
    pretrain epoch and a GAN epoch on a synthetic HR tree (finite losses,
    parameters that move, the checkpoint restored equal, a resume that goes
    on in the GAN phase), timed windows of both steps, one pretrain and one
    GAN step card f32 against CPU f32 (D's statistics left updated in the G
    step must break the comparison), then train-srgan and super-resolve on
    its generator through the CLI. `overrides` (config sections), `images`
    and `size` make a tiny CPU rehearsal possible (no timing)."""
    import contextlib
    import copy

    import numpy as np
    import yaml
    from PIL import Image

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.checkpoint import CheckpointManager, restore_auto
    from weatherconverter_tpu_torch.core.config import load_srgan_train_config
    from weatherconverter_tpu_torch.models.srgan import Discriminator, Generator
    from weatherconverter_tpu_torch.training import loop_srgan
    from weatherconverter_tpu_torch.training import srgan as S
    from weatherconverter_tpu_torch.utils import images as image_utils

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = _srgan_tree(os.path.join(tmp, "srgan_data"), images, size)
    out = os.path.join(tmp, "srgan_train")
    sections = copy.deepcopy(overrides or {})
    sections.setdefault("data", {}).update(root_dir=root, weather=["fog"])
    sections.setdefault("folders", {})["output"] = out
    base_training = dict(sections.pop("training", {}))
    cfg = load_srgan_train_config(None, training=dict(base_training, epochs=2, pretrain_epochs=1, save_interval=1,
                                                      log_interval=1, device=device.type), **sections)
    s, tr = cfg.srgan, cfg.training
    per_epoch = images // tr.batch_size

    # the loop: a pretrain epoch, a GAN epoch, a checkpoint each; then a resume into the GAN phase
    t0 = time.perf_counter()
    gs, ds = loop_srgan.train(cfg)
    sync()
    loop_s = time.perf_counter() - t0
    with open(os.path.join(out, "0", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if "train/g_loss" in line]
    g_losses = [r["train/g_loss"] for r in recs]
    d_losses = [r["train/d_loss"] for r in recs if "train/d_loss" in r]
    finite = lambda xs: all(x == x and abs(x) < float("inf") for x in xs)  # noqa: E731
    if (gs.step, ds.step) != (2 * per_epoch, per_epoch) or len(d_losses) != per_epoch or not finite(
            g_losses + d_losses) or [r["phase"] for r in recs] != ["pretrain"] * per_epoch + ["gan"] * per_epoch:
        raise AssertionError(f"srgan loop: steps G {gs.step}, D {ds.step}; records {recs}")
    ckdir = os.path.join(out, "0", "checkpoints")
    mgr = CheckpointManager(ckdir)
    saved = {e: mgr.restore(step=e) for e in mgr.all_steps()}
    if sorted(saved) != [1, 2]:
        raise AssertionError(f"srgan loop: checkpoints {sorted(saved)}")
    g_moved = sum((saved[2]["model"][k] - saved[1]["model"][k]).abs().sum().item()
                  for k, _ in gs.model.named_parameters())
    d_moved = sum((saved[2]["disc"][k] - saved[1]["disc"][k]).abs().sum().item()
                  for k, _ in ds.model.named_parameters())
    if not (g_moved > 0 and d_moved > 0):
        raise AssertionError(f"srgan loop: epoch 1 -> 2, G moved {g_moved}, D moved {d_moved}")
    fresh = S.SRGANStates(*S.create_srgan_states(Generator(s.in_channels, s.num_channels, s.num_blocks,
                                                           s.upscale_factor).to(device),
                                                 Discriminator(s.in_channels).to(device)))
    restore_auto(ckdir, fresh, prefer_best=False)
    _state_dicts_equal(torch, saved[2], fresh.state_dict())
    del fresh
    resumed = load_srgan_train_config(None, training=dict(base_training, epochs=3, pretrain_epochs=1, log_interval=1,
                                                          device=device.type, resume_training=True,
                                                          resume_checkpoint=ckdir), **sections)
    gs2, ds2 = loop_srgan.train(resumed)
    with open(os.path.join(out, "1", "metrics.jsonl")) as f:
        phases = {json.loads(line)["phase"] for line in f if "train/g_loss" in line}
    if (gs2.step, ds2.step, gs2.epoch) != (3 * per_epoch, 2 * per_epoch, 3) or phases != {"gan"}:
        raise AssertionError(f"srgan resume: G {gs2.step}, D {ds2.step}, epoch {gs2.epoch}, phases {phases}")
    log(f"  loop_srgan.train (G {s.num_channels} channels, {s.num_blocks} blocks, {s.upscale_factor}x; HR crop "
        f"{tr.hr_crop}, batch {tr.batch_size}, {tr.dtype if on_card else 'f32'}): {2 * per_epoch} steps (a pretrain "
        f"epoch, a GAN epoch) in {loop_s:.1f} s (build, loader start-up and cuDNN's first trials included); g loss "
        f"{g_losses[0]:.4f} -> {g_losses[-1]:.4f}, d loss {d_losses[0]:.4f} -> {d_losses[-1]:.4f}; epoch 1 -> 2 G "
        f"moved {g_moved:.3e}, D {d_moved:.3e}; checkpoint restored equal; a resume went on in the GAN phase to "
        f"step {gs2.step}")
    del gs, ds, gs2, ds2, saved

    def seeded_states(to):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            gen = Generator(s.in_channels, s.num_channels, s.num_blocks, s.upscale_factor)
            disc = Discriminator(s.in_channels)
        return S.create_srgan_states(gen.to(to), disc.to(to), tr.g_lr, tr.d_lr)

    # timed windows of both phases' steps on one device-resident uint8 batch
    if on_card:
        dtype = torch.bfloat16 if tr.dtype == "bfloat16" else None
        pair_fn = loop_srgan.make_pair_fn(tr.hr_crop, s.upscale_factor)
        pre = S.make_pretrain_step(tr.pixel_loss, dtype=dtype)
        gan = S.make_gan_step(tr.adv_weight, pixel_loss=tr.pixel_loss, dtype=dtype)
        g = torch.Generator(device=device).manual_seed(18)
        h, w = tr.hr_crop, int(round(tr.hr_crop * 16 / 9))
        for bsz in SRGAN_BATCHES:
            gst, dst = seeded_states(device)
            batch = torch.randint(0, 256, (bsz, h, w, 3), generator=g, device=device, dtype=torch.uint8)
            for what, step in (("pretrain step (pairs + G fwd/bwd + Adam)", lambda: pre(gst, *pair_fn(batch, g))),
                               ("GAN step (pairs + D update + G update)", lambda: gan(gst, dst, *pair_fn(batch, g)))):
                times, peak, prof, flops = _timed_windows(torch, step, FAMILY_WINDOWS, FAMILY_WINDOW_STEPS,
                                                          FAMILY_PROFILED)
                log("    " + _window_line(what, bsz, times, peak, prof, flops, FAMILY_PROFILED, card))
            del gst, dst, batch
            torch.cuda.empty_cache()

    # one pretrain and one GAN step, card f32 against CPU f32, the same seeded weights and batch
    cpu = torch.device("cpu")
    gcpu = torch.Generator().manual_seed(19)
    hr = torch.rand((2, tr.hr_crop, tr.hr_crop, 3), generator=gcpu)
    lr = torch.nn.functional.avg_pool2d(hr.permute(0, 3, 1, 2), s.upscale_factor).permute(0, 2, 3, 1)

    @contextlib.contextmanager
    def adversarial_term_detached(module):
        hook = module.register_forward_pre_hook(lambda m, args: (args[0].detach(),))
        try:
            with frozen(module):
                yield
        finally:
            hook.remove()

    frozen = S.frozen_statistics
    faults = {"d_statistics_left_updated": lambda module: contextlib.nullcontext(),
              "adversarial_term_detached": adversarial_term_detached}

    def both_steps(to, fault=None):
        gst, dst = seeded_states(to)
        snap = lambda st: {k: v.detach().clone().cpu() for k, v in st.model.state_dict().items()}  # noqa: E731
        # Adam's first moments, 0.1 g after a first step, by parameter name: they carry the gradients' scale,
        # which the first updates (about lr * sign(g)) do not
        moments = lambda st: {n: st.optimizer.state[p]["exp_avg"].detach().clone().cpu()  # noqa: E731
                              for n, p in st.model.named_parameters()}
        g0, d0 = snap(gst), snap(dst)
        _, pre_loss = S.make_pretrain_step(tr.pixel_loss)(gst, lr.to(to), hr.to(to))
        mid, mom_mid = snap(gst), moments(gst)
        if fault:
            S.frozen_statistics = faults[fault]
        try:
            _, _, g_loss, d_loss = S.make_gan_step(tr.adv_weight, pixel_loss=tr.pixel_loss)(gst, dst, lr.to(to),
                                                                                          hr.to(to))
        finally:
            S.frozen_statistics = frozen
        mom_g1 = moments(gst)
        return dict(losses=[pre_loss.item(), g_loss.item(), d_loss.item()], g0=g0, d0=d0, mid=mid, g1=snap(gst),
                    d1=snap(dst), names=(list(mom_mid), list(moments(dst))),
                    # per step and network, each times 0.1: G's pretrain gradient, G's GAN-step gradient (its
                    # moment less the decayed first one), D's gradient
                    moments_g_pretrain=list(mom_mid.values()),
                    moments_g_gan=[mom_g1[n] - 0.9 * mom_mid[n] for n in mom_g1],
                    moments_d=list(moments(dst).values()))

    def measures(run, ref):
        gp, dp = ref["names"]
        stats = lambda sd: [k for k in sd if k.endswith(("running_mean", "running_var"))]  # noqa: E731
        delta = lambda r, a, b, keys: [r[b][k].double() - r[a][k].double() for k in keys]  # noqa: E731
        return dict(
            loss=max(abs(x - y) / abs(y) for x, y in zip(run["losses"], ref["losses"])),
            update=_rel_l2(delta(run, "g0", "mid", gp) + delta(run, "mid", "g1", gp) + delta(run, "d0", "d1", dp),
                           delta(ref, "g0", "mid", gp) + delta(ref, "mid", "g1", gp) + delta(ref, "d0", "d1", dp)),
            **{k: _rel_l2(run[k], ref[k]) for k in ("moments_g_pretrain", "moments_g_gan", "moments_d")},
            stats=_rel_l2(delta(run, "g0", "g1", stats(ref["g1"])) + delta(run, "d0", "d1", stats(ref["d1"])),
                          delta(ref, "g0", "g1", stats(ref["g1"])) + delta(ref, "d0", "d1", stats(ref["d1"]))))

    t0 = time.perf_counter()
    ref = both_steps(cpu)
    cpu_s = time.perf_counter() - t0
    sound = measures(both_steps(device), ref)
    fmt = lambda c: ", ".join(f"{k} {v:.3e}" for k, v in c.items())  # noqa: E731
    log(f"  a pretrain step then a GAN step at batch 2, card f32 against CPU f32 (CPU {cpu_s:.1f} s; the largest "
        f"relative error of the three losses; relative L2 errors of every parameter's update, of Adam's first "
        f"moments of G's pretrain step, G's GAN step and D's step, and of the BatchNorm statistics' change), limits "
        f"{SRGAN_LIMITS}: {fmt(sound)}")
    if any(sound[k] > lim or sound[k] != sound[k] for k, lim in SRGAN_LIMITS.items()):
        raise AssertionError(f"card f32 and CPU f32 SRGAN steps disagree: {sound}")
    for fault in faults:
        faulty = measures(both_steps(device, fault), ref)
        broken = [k for k, lim in SRGAN_LIMITS.items() if not faulty[k] <= lim]
        log(f"    planted fault {fault}: {fmt(faulty)}; outside its limits: {', '.join(broken) or 'none'}")
        if not broken:
            raise AssertionError(f"the GAN step with the planted fault {fault} passes every limit: {faulty}")

    # the CLI: train-srgan, then super-resolve with the run's generator
    yml = os.path.join(tmp, "srgan.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump({"srgan": cfg.srgan.model_dump(), "data": {"root_dir": root, "weather": ["fog"]},
                        "training": dict(base_training, log_interval=1)}, f)
    cli_out, png = os.path.join(tmp, "srgan_cli"), os.path.join(tmp, "srgan_cli.png")
    small = os.path.join(tmp, "srgan_in.png")
    Image.fromarray(np.random.default_rng(91).integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(small)
    device_flag = [] if on_card else ["--device", "cpu"]
    for argv in (["train-srgan", "--config", yml, "--max-steps", "4", "--set", f"folders.output={cli_out}"],
                 ["super-resolve", "--config", yml, "--image", small, "--checkpoint",
                  os.path.join(cli_out, "0", "checkpoints"), "--out", png]):
        t0 = time.perf_counter()
        with _Recorder(image_utils) as rec:
            code = cli_main(argv + device_flag)
        sync()
        if code != 0:
            raise AssertionError(f"cli {argv[0]}: exit {code}")
        log(f"  cli {argv[0]}: exit 0 in {time.perf_counter() - t0:.1f} s")
    shape = Image.open(png).size
    want = (40 * s.upscale_factor, 30 * s.upscale_factor)
    if shape != want or len(rec.seen) != 1 or not rec.seen[0][1]:
        raise AssertionError(f"cli super-resolve: PNG {shape}, expected {want}; before the uint8 cast {rec.seen}")
    log(f"  super-resolve with that run's generator: a {shape[0]} x {shape[1]} PNG, finite and in [0, 1] before the "
        f"uint8 cast")
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")


def phase_legacy(torch, A, device, card, tmp):
    """The legacy UNet (models/unet_legacy.py) at 128 px with seeded weights
    (probes/legacy_precision.build: eps at unit scale), batch 8,
    LEGACY_STEPS strided steps of ddpm_sample_legacy, in f32 (K1-f32 at
    attn_down3 and attn_up2, no TF32), in f32 with qk_int8 (K2-f32 at both:
    the CLI's default, as JAX's sample takes its int8 kernel there) and under
    bf16 autocast with qk_int8 (K2 at attn_down3 and at attn_up2, D = 24):
    each timed (REPEATS runs), profiled, its launches a forward asserted, its
    peak memory read; then the precision check at LEGACY_CHECK_BATCH (the f32
    chain's verdict gated; the f32 qk_int8 chain's and the bf16 chain's
    printed: the bf16 one fails by design) and `sample --sampler legacy`
    through the CLI (K2-f32 twice a forward). Returns the f32 run's launches
    (K1-f32's count for the kernels line) and the bf16 run's K2 launches at
    D = 24."""
    import numpy as np
    from PIL import Image

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample_legacy
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.core.precision import f32_arithmetic
    from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet
    from weatherconverter_tpu_torch.probes import legacy_precision

    on_card = device.type == "cuda"  # a CPU rehearsal runs the plain versions and counts nothing
    base = legacy_precision.build()
    sched = linear_schedule(1000, device=device)
    shape = (BATCH, 128, 128, 3)
    counters = (A.flash_attention, A.flash_attention_qk_i8, A.quantize_qk_i8, A.flash_attention_f32)
    launches = {}
    for name, dtype, qk_int8 in (("f32", None, False), ("f32_qk_int8", None, True),
                                 ("bf16_qk_int8", torch.bfloat16, True)):
        model = LegacyUNet(128, qk_int8=qk_int8)
        model.load_state_dict(base.state_dict())
        model = model.to(device)
        kinds = [k for _, _, k in model.attention_kernels(128)]
        per = (kinds.count("K1"), kinds.count("K2"))
        expected = [0, per[1], per[1], per[0]] if dtype is None else [per[0], per[1], per[1], 0]
        expected = expected if on_card else [0] * 4
        ctx = (lambda: torch.autocast(device.type, dtype=dtype)) if dtype is not None else \
            (lambda: f32_arithmetic(device))

        def run(seed, steps=LEGACY_STEPS):
            with ctx():
                return ddpm_sample_legacy(model, sched, shape, torch.Generator(device=device).manual_seed(seed),
                                          num_steps=steps)

        run(60)  # warm-up: cuDNN picks its algorithms
        times, peak = [], 0.0
        for rep in range(REPEATS):
            for fn in counters:
                fn.launches = 0
            A.flash_attention_qk_i8.launches_by_head_dim, A.flash_attention_qk_i8.launches_by_dtype = {}, {}
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(61 + rep)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / LEGACY_STEPS)
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            counts = [fn.launches for fn in counters]
            if counts != [e * LEGACY_STEPS for e in expected] or tuple(out.shape) != shape \
                    or not torch.isfinite(out).all().item():
                raise AssertionError(f"legacy {name}: launches (K1, K2, quantizer, K1-f32) {counts}, expected "
                                     f"{[e * LEGACY_STEPS for e in expected]} ({expected} a forward); output "
                                     f"{tuple(out.shape)} or not finite")
            d24 = A.flash_attention_qk_i8.launches_by_head_dim.get(24, 0)
            v_dtype = "bfloat16" if dtype is not None else "float32"
            if on_card and qk_int8 and (d24 != LEGACY_STEPS or A.flash_attention_qk_i8.launches_by_dtype
                                        != {v_dtype: counts[1]}):
                raise AssertionError(f"legacy {name}: K2 launched {d24} times at D = 24 (attn_up2), expected "
                                     f"{LEGACY_STEPS}; by V's dtype {A.flash_attention_qk_i8.launches_by_dtype} "
                                     f"({v_dtype} only)")
        launches[name] = counts
        if qk_int8 and dtype is not None:
            launches["k2_d24"] = d24
        wall, kernel, count = _device_profile(torch, lambda: run(70, PROFILE_STEPS), PROFILE_STEPS)
        log(f"  legacy {name} (layers {kinds}): {statistics.median(times):.2f} ms/step wall (median of {REPEATS} "
            f"runs of {LEGACY_STEPS} steps at batch {BATCH}: {', '.join(f'{t:.2f}' for t in times)}); profiled "
            f"{PROFILE_STEPS}-step run: device {kernel / PROFILE_STEPS:.2f} ms/step, idle share ~"
            f"{max(0.0, 1 - kernel / wall):.2f}, {count / PROFILE_STEPS:.0f} launches a step; K1/K2/quantizer/K1-f32 "
            f"a forward {'/'.join(map(str, expected))}"
            + (f" (K2 at D = 24, attn_up2: {d24} launches)" if qk_int8 else "") + f"; peak {peak:.2f} GiB [{card}]")
        del model
    t0 = time.perf_counter()
    artifact = legacy_precision.run(base, (LEGACY_CHECK_BATCH, 128, 128, 3), LEGACY_STEPS, LEGACY_FLOOR_SEEDS, device)
    artifact["card"] = card
    if on_card:
        legacy_precision.check_launches(artifact)
    legacy_precision.report(artifact, card, log)
    log(f"  the check in {time.perf_counter() - t0:.1f} s; wrote {legacy_precision.save(artifact)}")
    # the f32 chain (K1-f32) is the f32 arithmetic's: it must pass; the f32 qk_int8 chain (K2-f32, the CLI's by
    # JAX's default) is printed, as phase 12's int8 verdicts are; the bf16 chain fails by design
    if not artifact["runs"]["f32"]["passes"]:
        raise AssertionError(f"legacy precision: the f32 card chain fails the check: pearson "
                             f"{artifact['runs']['f32']['pearson']:.9f} < threshold {artifact['threshold']:.9f}")
    # the CLI: the legacy UNet at configs/diffusion.yaml's im_size (128), f32, seeded weights, K2-f32 (JAX's default)
    path = os.path.join(tmp, "legacy.png")
    for fn in counters:
        fn.launches = 0
    A.flash_attention_qk_i8.launches_by_dtype = {}
    t0 = time.perf_counter()
    code = cli_main(["sample", "--config", os.path.join(REPO, "configs", "diffusion.yaml"), "--sampler", "legacy",
                     "--steps", str(LEGACY_STEPS), "--batch", str(BATCH), "--out", path]
                    + ([] if on_card else ["--device", "cpu"]))
    torch.cuda.synchronize()
    counts = [fn.launches for fn in counters]
    png = np.asarray(Image.open(path)).shape
    expected = [0, 2 * LEGACY_STEPS, 2 * LEGACY_STEPS, 0] if on_card else [0] * 4
    rows = -(-BATCH // 4)
    if code != 0 or counts != expected or png != (2 + rows * 130, 2 + 4 * 130, 3) or (
            on_card and A.flash_attention_qk_i8.launches_by_dtype != {"float32": counts[1]}):
        raise AssertionError(f"cli sample --sampler legacy: exit {code}, launches (K1, K2, quantizer, K1-f32) "
                             f"{counts}, expected {expected}, K2 by V's dtype "
                             f"{A.flash_attention_qk_i8.launches_by_dtype}; PNG {png}")
    log(f"  cli sample --sampler legacy --steps {LEGACY_STEPS} --batch {BATCH}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s (model from the seed, f32), K2-f32 launched {counts[1]} times (two a "
        f"forward), K2 by V's dtype {A.flash_attention_qk_i8.launches_by_dtype}; PNG {png}")
    return launches["f32"], launches["k2_d24"]


def _seeded_inception_pth(torch, path, seed=80):
    """A torchvision-layout InceptionV3 .pth written by
    compat/from_jax.export_inception_v3 from a flax-layout tree of numpy
    draws (He-scale kernels, BatchNorm near identity), with AuxLogits keys
    as torchvision's file has them."""
    import numpy as np

    from weatherconverter_tpu_torch.compat.from_jax import export_inception_v3
    from weatherconverter_tpu_torch.models.inception import InceptionV3

    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, t in InceptionV3(classify=True).state_dict().items():
        *parents, mod, leaf = name.split(".")
        p, st = params, stats
        for part in parents + [mod]:
            p, st = p.setdefault(part, {}), st.setdefault(part, {})
        shape = tuple(t.shape)
        if mod == "conv":
            kernel = rng.standard_normal((shape[2], shape[3], shape[1], shape[0]), dtype=np.float32)
            p["kernel"] = kernel * np.float32(np.sqrt(2.0 / np.prod(kernel.shape[:-1])))
        elif mod == "bn" and leaf in ("weight", "bias"):
            p["scale" if leaf == "weight" else "bias"] = (1.0 if leaf == "weight" else 0.0) + \
                0.05 * rng.standard_normal(shape, dtype=np.float32)
        elif mod == "bn" and leaf in ("running_mean", "running_var"):
            st["mean" if leaf == "running_mean" else "var"] = (
                0.05 * rng.standard_normal(shape, dtype=np.float32) if leaf == "running_mean"
                else np.exp(0.2 * rng.standard_normal(shape, dtype=np.float32)))
        elif mod == "fc":
            p["kernel" if leaf == "weight" else "bias"] = 0.01 * rng.standard_normal(
                shape[::-1] if leaf == "weight" else shape, dtype=np.float32)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_inception_v3(params, stats).items()}
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, path)


def phase_quality(torch, A, device, card, tmp, tcfg=None):
    """`quality` through the CLI in-process on configs/translation.yaml
    (the 128 px UNet, DeepLabV3+/ResNet-101, the 4x SRGAN: 512 px), seeded
    weights, --synthetic QUALITY_N --batch BATCH --steps QUALITY_STEPS: once
    with the seg backbone's FID and once with InceptionV3 pool3 from a seeded
    torchvision-layout .pth. Gates: exit 0, the report's keys, finite
    numbers, K1-f32 8 times a UNet forward and no K2 (JAX's run_quality
    never enables int8; the command computes in f32), no K1. Then
    Inception's time in f32 for a 299 px batch and FID's eigh at D = 2048."""
    import json

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.cli.commands import load_inception
    from weatherconverter_tpu_torch.core.precision import f32_arithmetic
    from weatherconverter_tpu_torch.metrics.fid import _psd_sqrt
    from weatherconverter_tpu_torch.models.inception import fid_input_resize
    from weatherconverter_tpu_torch.probes.common import time_ms

    tcfg = tcfg or os.path.join(REPO, "configs", "translation.yaml")
    on_card = device.type == "cuda"  # a CPU rehearsal runs the plain versions and counts nothing
    pth = os.path.join(tmp, "inception.pth")
    _seeded_inception_pth(torch, pth)
    keys = ["data", "weights", "guidance", "steps", "fid_kind", "fid_original_vs_translated", "miou_original",
            "miou_translated", "miou_consistency_gap"]
    forwards = QUALITY_STEPS * -(-QUALITY_N // BATCH)
    for kind, extra in (("backbone", []), ("inception", ["--inception-checkpoint", pth])):
        out = os.path.join(tmp, f"quality_{kind}.json")
        A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
        A.flash_attention_f32.launches = 0
        t0 = time.perf_counter()
        code = cli_main(["quality", "--config", tcfg, "--synthetic", str(QUALITY_N), "--batch", str(BATCH), "--steps",
                         str(QUALITY_STEPS), "--out", out] + extra + ([] if on_card else ["--device", "cpu"]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches,
                  A.flash_attention_f32.launches)
        expected = (0, 0, 0, FLASH_CALLS_PER_UNET * forwards) if on_card else (0, 0, 0, 0)
        report = json.load(open(out))
        numbers = [report.get(k) for k in keys[5:]]
        if code != 0 or counts != expected or list(report) != keys or not all(
                isinstance(v, float) and v == v and abs(v) != float("inf") for v in numbers):
            raise AssertionError(f"cli quality ({kind}): exit {code}, launches (K1, K2, quantizer, K1-f32) {counts}, "
                                 f"expected {expected}; report {report}")
        log(f"  cli quality --synthetic {QUALITY_N} --batch {BATCH} --steps {QUALITY_STEPS} ({report['fid_kind']}): "
            f"exit 0 in {secs:.1f} s (models from the seed, first-shape autotuning included); FID "
            f"{report['fid_original_vs_translated']}, mIoU original {report['miou_original']} / translated "
            f"{report['miou_translated']}, gap {report['miou_consistency_gap']}; K1/K2/quantizer/K1-f32 "
            f"{'/'.join(map(str, counts))} [{card}]")
    inception = load_inception(pth).to(device)
    x = torch.rand((BATCH, 3, 512, 512), generator=torch.Generator(device=device).manual_seed(81), device=device)
    with torch.no_grad(), f32_arithmetic(device):  # as the command runs it
        feats = inception(fid_input_resize(x))
        inc_ms = time_ms(lambda: inception(fid_input_resize(x)), reps=5)
    f = feats.float()
    cov = (f.T @ f) / BATCH + torch.eye(2048, device=device)
    eigh_ms = time_ms(lambda: torch.linalg.eigh(cov), reps=3, warmup=1)
    psd_ms = time_ms(lambda: _psd_sqrt(cov), reps=3, warmup=1)
    log(f"  InceptionV3 pool3 at batch {BATCH} (512 px resized to 299, f32, TF32 off): {inc_ms:.2f} ms a batch; "
        f"FID at D = 2048: torch.linalg.eigh {eigh_ms:.1f} ms, one PSD square root {psd_ms:.1f} ms (a distance "
        f"takes two) [{card}]")


def phase_visualize_debug(torch, A, device, card, tmp, tcfg=None, dcfg=None, vis_every=VIS_EVERY):
    """`visualize` and `translate --debug-dir` through the CLI in-process at
    configs/diffusion.yaml and configs/translation.yaml (full width, seeded
    weights). visualize on a synthetic 128 px image, a frame every
    `vis_every` steps of a copy of the config with a VIS_T-step schedule
    (the config's own where shorter), then once more traced on a
    copy of the config with a VIS_TRACE_T-step schedule; translate
    --debug-dir at DEBUG_STEPS steps, a dump every DEBUG_EVERY, a plain
    translate with the same seed, and a traced --debug-dir run at
    DEBUG_TRACE_STEPS steps; both commands in f32. Gates: exit 0, the files
    and their shapes, the launches (K1-f32, K2-f32, quantizer on f32 q and k;
    no K1, no K2 on bf16) that the UNets' attention_kernels predict,
    the --debug-dir output PNG byte-equal to the plain one, each trace
    written and not empty. Each run's wall time from
    core/profiling.StepTimer, its peak memory from device_memory_stats, the
    traced runs' device time and idle share."""
    import contextlib

    import numpy as np
    import yaml
    from PIL import Image

    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core import profiling
    from weatherconverter_tpu_torch.core.config import load_diffusion_config, load_translation_config
    from weatherconverter_tpu_torch.models.unet import Unet

    tcfg = tcfg or os.path.join(REPO, "configs", "translation.yaml")
    dcfg = dcfg or os.path.join(REPO, "configs", "diffusion.yaml")
    on_card = device.type == "cuda"  # a CPU rehearsal passes --device cpu and counts nothing
    flag = [] if on_card else ["--device", "cpu"]
    # the commands compute in f32: the UNet's "K1" layers take K1-f32, its "K2" layers K2-f32; bf16 K1 never
    counters = (A.flash_attention_f32, A.flash_attention_qk_i8, A.quantize_qk_i8, A.flash_attention)

    def per_forward(model_cfg, qk_int8):
        with torch.device("meta"):
            kinds = [k for _, _, k in Unet(model_cfg, qk_int8=qk_int8).attention_kernels(model_cfg.im_size)]
        return (kinds.count("K1"), kinds.count("K2"), kinds.count("K2"), 0)

    def run(argv, forwards, per, trace_dir=None):
        """One CLI run: (seconds, peak GiB, launches; with `trace_dir` also
        device ms and kernel launches from its trace)."""
        for fn in counters:
            fn.launches = 0
        A.flash_attention_qk_i8.launches_by_dtype = {}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        timer = profiling.StepTimer(warmup=0, device=device)
        with (profiling.trace(trace_dir) if trace_dir else contextlib.nullcontext()) as prof, timer:
            code = cli_main(argv + flag)
        counts = tuple(fn.launches for fn in counters)
        expected = tuple(forwards * c for c in per) if on_card else (0, 0, 0, 0)
        if code != 0 or counts != expected or set(A.flash_attention_qk_i8.launches_by_dtype) - {"float32"}:
            raise AssertionError(f"cli {argv[0]}: exit {code}, launches (K1-f32, K2, quantizer, K1) {counts}, expected "
                                 f"{expected}; K2 by V's dtype {A.flash_attention_qk_i8.launches_by_dtype}")
        peak = profiling.device_memory_stats(device).get("peak_bytes_in_use", 0) / 2**30
        result = dict(s=timer.summary()["mean_s"], peak=peak, counts=counts)
        if trace_dir:
            path = os.path.join(trace_dir, profiling.TRACE_FILE)
            if not (os.path.isfile(path) and os.path.getsize(path) > 0):
                raise AssertionError(f"cli {argv[0]}: no trace at {path}")
            events = _kernel_events(torch, prof)
            result.update(device_ms=sum(e.device_time_total for e in events) / 1e3,
                          kernels=sum(e.count for e in events), trace_mib=os.path.getsize(path) / 2**20)
        return result

    def line(what, r, steps):
        text = (f"  cli {what}: exit 0, {r['s']:.1f} s wall (StepTimer, device synchronized); launches "
                f"K1-f32/K2-f32/quantizer/K1 {'/'.join(map(str, r['counts']))}; peak {r['peak']:.2f} GiB "
                f"(device_memory_stats)")
        if "device_ms" in r:
            text += (f"; traced: device {r['device_ms'] / steps:.2f} ms/step, idle share ~"
                     f"{max(0.0, 1 - r['device_ms'] / (r['s'] * 1e3)):.2f}, {r['kernels'] / steps:.0f} kernels a "
                     f"step, trace {r['trace_mib']:.1f} MiB")
        log(text + f" [{card}]")

    # visualize: a synthetic 128 px image; the UNet on K1-f32 (visualize never takes K2)
    d = load_diffusion_config(dcfg)
    size, T = d.model.im_size, min(VIS_T, d.diffusion.num_timesteps)
    image = os.path.join(tmp, "vis.png")
    Image.fromarray(np.random.default_rng(52).integers(0, 256, (size, size, 3), dtype=np.uint8)).save(image)
    with open(dcfg) as fh:
        doc = yaml.safe_load(fh)
    vis, short = os.path.join(tmp, "diffusion_vis.yaml"), os.path.join(tmp, "diffusion_short.yaml")
    for path, t in ((vis, T), (short, VIS_TRACE_T)):
        doc["diffusion"]["num_timesteps"] = t
        with open(path, "w") as fh:
            yaml.safe_dump(doc, fh)
    k1 = per_forward(d.model, False)
    frames = {"forward": -(-T // vis_every), "backward": -(-T // vis_every), "aug_photometric": 5, "aug_geometric": 5}
    for cfg_path, steps, every, traced in ((vis, T, vis_every, False), (short, VIS_TRACE_T, 10, True)):
        out = os.path.join(tmp, "strips_traced" if traced else "strips")
        r = run(["visualize", "--config", cfg_path, "--image", image, "--out", out, "--every", str(every)], steps, k1,
                os.path.join(tmp, "trace_vis") if traced else None)
        want = frames if not traced else {k: (-(-steps // every) if k in ("forward", "backward") else v)
                                          for k, v in frames.items()}
        shapes = {k: np.asarray(Image.open(os.path.join(out, f"{k}.png"))).shape for k in want}
        if shapes != {k: (size, n * size, 3) for k, n in want.items()}:
            raise AssertionError(f"cli visualize: strips {shapes}, expected {want} frames of {size} px")
        line(f"visualize ({steps}-step chain at batch 1, a frame every {every}; strips {shapes})", r, steps)

    # translate --debug-dir, the plain translate with the same seed, a short traced --debug-dir
    tc = load_translation_config(tcfg)
    lat = tc.diffusion.model.im_size
    hr = lat * tc.srgan.upscale_factor
    img, lbl = os.path.join(tmp, "dbg_img.png"), os.path.join(tmp, "dbg_lbl.png")
    _synthetic_pair(img, lbl, seed=53)
    k2 = per_forward(tc.diffusion.model, on_card)  # the CLI's qk_int8 on the card
    common = ["translate", "--config", tcfg, "--image", img, "--label", lbl, "--seed", "5"]
    dbg = os.path.join(tmp, "debug")
    # the two outputs are compared byte for byte: with autotuning the guided chain is not reproducible on the card
    # (the same translate four times in one process gave two PNGs, before the custom ops as after; PERF.md
    # section 6): the fastest backward convolutions add in a varying order
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        r = run(common + ["--steps", str(DEBUG_STEPS), "--out", os.path.join(tmp, "debug.png"), "--debug-dir", dbg,
                          "--debug-every", str(DEBUG_EVERY)], DEBUG_STEPS, k2)
        line(f"translate --debug-dir (DDPM, {DEBUG_STEPS} steps, a dump every {DEBUG_EVERY}; cuDNN deterministic)",
             r, DEBUG_STEPS)
        r = run(common + ["--steps", str(DEBUG_STEPS), "--out", os.path.join(tmp, "plain.png")], DEBUG_STEPS, k2)
        line("translate, plain (the same seed; cuDNN deterministic)", r, DEBUG_STEPS)
    r = run(common + ["--steps", str(DEBUG_TRACE_STEPS), "--out", os.path.join(tmp, "short.png"), "--debug-dir",
                      os.path.join(tmp, "debug_short"), "--debug-every", "2"], DEBUG_TRACE_STEPS, k2,
            os.path.join(tmp, "trace_dbg"))
    line(f"translate --debug-dir, traced ({DEBUG_TRACE_STEPS} steps, a dump every 2)", r, DEBUG_TRACE_STEPS)
    lats = [f"xt_{lo}.png" for lo in range((DEBUG_STEPS - 1) // DEBUG_EVERY * DEBUG_EVERY, -1, -DEBUG_EVERY)]
    # debug_tensor's grids: one image in a 2 px border
    want = {"input.png": (lat + 4, lat + 4, 3), "gt.png": (hr + 4, hr + 4, 3),
            f"xt_{DEBUG_STEPS}_noised.png": (lat + 4, lat + 4, 3), "sr_x0.png": (hr + 4, hr + 4, 3),
            "sr_x0_pred.png": (hr + 4, hr + 4, 3), **{n: (lat + 4, lat + 4, 3) for n in lats}}
    got = {n: np.asarray(Image.open(os.path.join(dbg, n))).shape for n in sorted(os.listdir(dbg))}
    if got != want:
        raise AssertionError(f"cli translate --debug-dir: files {got}, expected {want}")
    with open(os.path.join(tmp, "debug.png"), "rb") as a, open(os.path.join(tmp, "plain.png"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli translate --debug-dir: its output PNG differs from the plain translate's with "
                                 "the same seed")
    log(f"  translate --debug-dir wrote {len(got)} files ({', '.join(got)}), its output byte-equal to the plain "
        f"translate's")


def phase_f32_chain(torch, A, device, card, tcfg=None, steps=F32_CHAIN_STEPS):
    """The f32 inference chain, card against CPU (see F32_CHAIN_REL_TOL):
    make_translate_fn(dtype=None) over configs/translation.yaml's models
    from the seed, the UNet with qk_int8, batch 1, `steps` steps of GSG in
    latent space at the config's lam, the same input, labels and draws on
    both sides; K2-f32 launched 8 times a UNet forward on f32 V only; the
    same card chain under bf16 autocast, the planted fault, must break the
    limit."""
    import copy

    from weatherconverter_tpu_torch.cli import commands
    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn

    cfg = load_translation_config(tcfg or os.path.join(REPO, "configs", "translation.yaml"))
    size, nc = cfg.diffusion.model.im_size, cfg.seg.model.num_classes
    hr = size * cfg.srgan.upscale_factor
    on_card = device.type == "cuda"
    unet, seg, sr, sched = commands.build_translation(cfg, device, None, None, None, True, 0)
    host = [copy.deepcopy(m).to("cpu") for m in (unet, seg, sr)]
    g = torch.Generator().manual_seed(90)
    x, gt = torch.randn((1, size, size, 3), generator=g) * 0.2, torch.randint(0, nc, (1, hr, hr), generator=g)
    noise = (torch.randn((1, size, size, 3), generator=g), torch.randn((steps, 1, size, size, 3), generator=g))
    kw = dict(lam=cfg.guidance.lambda_, num_steps=steps, start_t=steps - 1, mode="fixed", guidance_style="gsg",
              guidance_every=1, guidance_space="latent", num_classes=nc)

    def on(dev, models, schedule, dtype=None):
        fn = make_translate_fn(*models[:1], schedule, *models[1:], dtype=dtype, **kw)
        return fn(x.to(dev), gt.to(dev), noise=tuple(n.to(dev) for n in noise)).cpu()

    A.flash_attention_qk_i8.launches_by_dtype, A.flash_attention_f32.launches = {}, 0
    t0 = time.perf_counter()
    card_out = on(device, (unet, seg, sr), sched)
    card_s = time.perf_counter() - t0
    by_dtype, k1_f32 = dict(A.flash_attention_qk_i8.launches_by_dtype), A.flash_attention_f32.launches
    fault = on(device, (unet, seg, sr), sched, torch.bfloat16)
    t0 = time.perf_counter()
    host_out = on("cpu", host, commands.make_schedule_from(cfg.diffusion.diffusion, "cpu"))
    host_s = time.perf_counter() - t0
    rel, fault_rel = (((o - host_out).norm() / host_out.norm()).item() for o in (card_out, fault))
    expected = {"float32": FLASH_CALLS_PER_UNET * steps} if on_card else {}
    log(f"  f32 chain, card (K2-f32) against CPU (plain K2), {steps}-step GSG in latent space at batch 1, {hr} px out: "
        f"relative L2 error {rel:.3e} (limit {F32_CHAIN_REL_TOL}), max abs {(card_out - host_out).abs().max().item():.3e}; "
        f"the planted fault (the chain under bf16 autocast) {fault_rel:.3e}: breaks it; K2 by V's dtype {by_dtype}, "
        f"K1-f32 {k1_f32}; card chain {card_s:.1f} s, CPU chain {host_s:.1f} s [{card}]")
    if by_dtype != expected or k1_f32 or card_out.shape != (1, hr, hr, 3) or not torch.isfinite(card_out).all():
        raise AssertionError(f"f32 chain: K2 by V's dtype {by_dtype}, expected {expected}; K1-f32 {k1_f32}; output "
                             f"{tuple(card_out.shape)} or not finite")
    if not rel <= F32_CHAIN_REL_TOL < fault_rel:
        raise AssertionError(f"f32 chain: card against CPU {rel} (limit {F32_CHAIN_REL_TOL}), the bf16 fault "
                             f"{fault_rel}: the limit must hold the f32 chain and break the fault")


_EXPORT_CONSUMER = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[4])
import torch
torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
from weatherconverter_tpu_torch.serving import load_exported
t1 = time.perf_counter()
call = load_exported(sys.argv[1])
t2 = time.perf_counter()
args = torch.load(sys.argv[2], map_location=sys.argv[5])
from weatherconverter_tpu_torch.ops import attention as A
A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
A.flash_attention_f32.launches, A.flash_attention_qk_i8.launches_by_dtype = 0, {}
t3 = time.perf_counter()
out = call(*args)
if sys.argv[5] == "cuda":
    torch.cuda.synchronize()
t4 = time.perf_counter()
casts = sum(1 for n in call.module.graph.nodes
            if n.target is torch.ops.aten._to_copy.default and n.kwargs.get("dtype") == torch.bfloat16)
models = [m for m in sys.modules if m.startswith(("weatherconverter_tpu_torch.models", "weatherconverter_tpu.", "jax"))]
torch.save(out.cpu(), sys.argv[3])
json.dump(dict(import_s=t1 - t0, load_s=t2 - t1, run_s=t4 - t3, k1=A.flash_attention.launches,
               k2=A.flash_attention_qk_i8.launches, quantizer=A.quantize_qk_i8.launches,
               k1_f32=A.flash_attention_f32.launches, k2_by_dtype=A.flash_attention_qk_i8.launches_by_dtype,
               bf16_casts=casts,
               model_modules=models, dtype=str(out.dtype)), open(sys.argv[3] + ".json", "w"))
"""


def phase_export(torch, A, device, card, tmp, tcfg=None, steps=None, batch=None):
    """`export-hlo --program translate --attn int8` through the CLI in-process
    at configs/translation.yaml (the program in f32, as JAX exports it: the
    128 px UNet with K2-f32 and one int8 scale per tensor,
    DeepLabV3+/ResNet-101, the 4x SRGAN), batch EXPORT_BATCH,
    EXPORT_STEPS steps; the live program on the card (the same seeded weights,
    input, labels and draws, cudnn deterministic, no autotuning) twice; the
    archive loaded by serving/hlo_runtime.load_exported in a fresh process
    that imports no model code, counts its K1, K2 and quantizer launches and
    runs it on those arguments. Gates: exit 0, the launches (K2-f32 and its
    quantizer 8 a UNet forward, on f32 V only, no K1 or K1-f32, live and
    loaded), no bf16 cast in the loaded graph, output dtypes equal, the
    loaded output equal to the live
    one bit for bit, finite, in [0, 1], of (B, 512, 512, 3). Prints the
    trace, export, save, load and run seconds and the archive's MiB. Returns
    with the fresh process running: the call it returns waits for it, holds
    it to those gates and prints the line."""
    import subprocess

    from weatherconverter_tpu_torch.cli import commands
    from weatherconverter_tpu_torch.cli.main import main as cli_main
    from weatherconverter_tpu_torch.core.config import load_translation_config

    tcfg = tcfg or os.path.join(REPO, "configs", "translation.yaml")
    steps, batch = steps or EXPORT_STEPS, batch or EXPORT_BATCH
    on_card = device.type == "cuda"
    out = os.path.join(tmp, "translate_int8.pt2")
    argv = ["export-hlo", "--config", tcfg, "--program", "translate", "--steps", str(steps), "--batch", str(batch),
            "--attn", "int8" if on_card else "bf16", "--out", out] + ([] if on_card else ["--device", "cpu"])
    t0 = time.perf_counter()
    code = cli_main(argv)
    export_wall = time.perf_counter() - t0
    with open(out + ".json") as fh:
        info = json.load(fh)
    if code != 0:
        raise AssertionError(f"export-hlo: exit {code}")
    cfg = load_translation_config(tcfg)
    size, nc = cfg.diffusion.model.im_size, cfg.seg.model.num_classes
    hr = size * cfg.srgan.upscale_factor
    models = commands.inference_models(cfg, "translate", info["attn"], device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(70)
    data = [torch.randn((batch, size, size, 3), generator=gen, device=device) * 0.2,
            torch.randint(0, nc, (batch, hr, hr), generator=gen, device=device),
            torch.randn((batch, size, size, 3), generator=gen, device=device),
            torch.randn((steps, batch, size, size, 3), generator=gen, device=device)]
    args = commands.weight_arguments(models) + data
    spec = [(tuple(s), d) for _, s, d in info["args"]]
    if [(tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in args] != spec:
        raise AssertionError("export-hlo: the archive's argument list differs from the live program's")
    fn = commands.inference_program(cfg, "translate", steps, models, device)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):  # as fresh
        lives = []
        for _ in range(2):
            A.flash_attention.launches = A.flash_attention_qk_i8.launches = A.quantize_qk_i8.launches = 0
            A.flash_attention_f32.launches, A.flash_attention_qk_i8.launches_by_dtype = 0, {}
            t0 = time.perf_counter()
            lives.append(fn(*args).cpu())
            live_s = time.perf_counter() - t0
        live_counts = (A.flash_attention.launches + A.flash_attention_f32.launches,
                       A.flash_attention_qk_i8.launches_by_dtype.get("float32", 0), A.quantize_qk_i8.launches)
    torch.save(args, os.path.join(tmp, "export_args.pt"))
    del args, models, data
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    err = open(os.path.join(tmp, "export_consumer.err"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", _EXPORT_CONSUMER, out, os.path.join(tmp, "export_args.pt"),
                             os.path.join(tmp, "export_out.pt"), REPO, device.type], stdout=subprocess.DEVNULL,
                            stderr=err)

    def finish():
        try:
            proc.wait(timeout=max(600 - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        fresh_s = time.perf_counter() - t0
        err.seek(0)
        stderr = err.read()
        err.close()
        if proc.returncode != 0:
            raise AssertionError(f"hlo_runtime in a fresh process: exit {proc.returncode}\n{stderr[-3000:]}")
        live = lives[0]
        with open(os.path.join(tmp, "export_out.pt.json")) as fh:
            fresh = json.load(fh)
        served = torch.load(os.path.join(tmp, "export_out.pt"))
        expect = (0, FLASH_CALLS_PER_UNET * steps, FLASH_CALLS_PER_UNET * steps) if on_card else (0, 0, 0)
        loaded_counts = (fresh["k1"] + fresh["k1_f32"], fresh["k2_by_dtype"].get("float32", 0), fresh["quantizer"])
        log(f"  export-hlo --attn {info['attn']} translate, {steps} steps, batch {batch}: exit 0 in "
            f"{export_wall:.1f} s (trace {info['export']['trace_s']:.1f} s, torch.export {info['export']['export_s']:.1f} s, save "
            f"{info['export']['save_s']:.1f} s), {info['export']['nodes']} nodes, {info['export']['mib']:.1f} MiB, "
            f"{len(info['args'])} arguments; the live program {live_s:.2f} s, launches K1 (any)/K2-f32/quantizer "
            f"{'/'.join(map(str, live_counts))}; two live runs {'bit-equal' if torch.equal(*lives) else 'DIFFER'}; "
            f"the fresh process {fresh_s:.1f} s (imports "
            f"{fresh['import_s']:.1f} s, load {fresh['load_s']:.1f} s, run {fresh['run_s']:.2f} s), launches "
            f"K1 (any)/K2-f32/quantizer {'/'.join(map(str, loaded_counts))} (K2 by V's dtype "
            f"{fresh['k2_by_dtype']}), {fresh['bf16_casts']} bf16 casts in the loaded "
            f"graph, model modules imported {fresh['model_modules'] or 'none'}; loaded against live: max |diff| "
            f"{(served - live).abs().max().item():.3e} [{card}]")
        if not (torch.equal(*lives) and torch.equal(served, live)):
            raise AssertionError(f"export: the loaded program differs from the live one (or two live runs differ: "
                                 f"{(lives[0] - lives[1]).abs().max().item()})")
        if live_counts != expect or loaded_counts != expect or fresh["model_modules"] or fresh["k2"] != expect[1] \
                or fresh["dtype"] != str(live.dtype) or fresh["bf16_casts"]:
            raise AssertionError(f"export: launches live {live_counts} / loaded {loaded_counts}, expected {expect}; "
                                 f"model modules {fresh['model_modules']}; dtypes {fresh['dtype']} / {live.dtype}; "
                                 f"bf16 casts {fresh['bf16_casts']}")
        if live.shape != (batch, hr, hr, 3) or not (torch.isfinite(live).all() and live.min() >= 0
                                                    and live.max() <= 1):
            raise AssertionError(f"export: output {tuple(live.shape)}, finite and in [0, 1]: not so")

    return finish


# phase 22: two ranks on the one card; the DDPM step at global batch DP_BATCH (DP_BATCH / 2 a rank), the seg step
# at configs/segmentation.yaml's batch over DP_SEG_ACCUM microbatches; DP_TIMED_STEPS warm steps timed a rank.
# Limits (bf16, two ranks against one process on the card): the relative error of the loss and the relative L2
# error of Adam's first moments (DDPM), of the update without the pooled leaves and of the BatchNorm statistics'
# batch term (seg). H100 readings (PERF.md section 6): DDPM 4.6e-6 to 6.3e-6 (the single-process loss moves in
# its sixth digit from run to run) and 2.8e-3, plain and FSDP alike, the skipped all-reduce 0.52 on the moments;
# seg 3.4e-4, 0.131 and 5.8e-4, a per-rank BatchNorm 1.2e-3, 0.70 and 2.1e-2
DP_WORLD, DP_BATCH, DP_SEG_ACCUM, DP_TIMED_STEPS, DP_TIMEOUT_S = 2, 8, 2, 2, 300
DP_LIMITS = dict(ddpm_loss=1e-3, ddpm_moments=2e-2, seg_loss=5e-3, seg_update=0.25, seg_stats=5e-3)


def _dp_rank(rank: int, port: int, workdir: str, on_card: bool = True) -> None:
    """One rank of phase 22, in a child process: gloo on card 0 (or the CPU in
    a rehearsal), the cases of `_dp_rank_cases`, its results written to
    <workdir>/rank<r>.pt."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()  # a crash in a rank prints its Python stack
    sys.path.insert(0, REPO)
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=DP_WORLD)
    try:
        torch.save(_dp_rank_cases(torch, rank, workdir, on_card), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_rank_cases(torch, rank: int, workdir: str, on_card: bool) -> dict:
    import contextlib
    import copy

    from torch.distributed.tensor import DTensor

    from weatherconverter_tpu_torch.core.config import UnetModelConfig, load_seg_config
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.ops import attention as A
    from weatherconverter_tpu_torch.ops import cuda_build
    from weatherconverter_tpu_torch.parallel import make_mesh, shard_batch
    from weatherconverter_tpu_torch.parallel.fsdp import full_state, shard_state_fsdp, sharded_fraction
    from weatherconverter_tpu_torch.probes import seg_step_parity as SP
    from weatherconverter_tpu_torch.training import diffusion as PD
    from weatherconverter_tpu_torch.training import loop_segmentation
    from weatherconverter_tpu_torch.training import segmentation as PS
    from weatherconverter_tpu_torch.training.losses import make_seg_loss
    from weatherconverter_tpu_torch.training.segmentation import create_seg_state

    t0 = time.perf_counter()
    if on_card:
        cuda_build.library()  # phase 1's build, loaded from _build/ (the same sources: no nvcc run)
    device = torch.device("cuda" if on_card else "cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else None
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(device_type=device.type)
    out = dict(rank=rank, load_s=time.perf_counter() - t0)
    sched = linear_schedule(1000, device=device)
    x = shard_batch(mesh, inp["x"]).to(device)
    t, noise = inp["t"].to(device), inp["noise"].to(device)

    def timed(state, step):
        """Medians of DP_TIMED_STEPS warm steps (cuDNN's choices are made): wall and between CUDA events."""
        walls, devs = [], []
        for _ in range(DP_TIMED_STEPS if on_card else 0):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            e0.record()
            step(state, x, t=t, noise=noise)
            e1.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - w0) * 1e3)
            devs.append(e0.elapsed_time(e1))
        return dict(wall=statistics.median(walls or [0.0]), device=statistics.median(devs or [0.0]))

    def ddpm(fsdp=False, fault=None):
        unet = Unet(UnetModelConfig(**inp["unet_cfg"]))
        unet.load_state_dict(inp["unet"])
        state = PD.create_ddpm_state(unet.to(device), lr=1e-4)
        if fsdp:
            shard_state_fsdp(mesh, state)
        step = PD.make_train_step(sched, mesh=mesh, fsdp=fsdp, dtype=dtype)
        ctx = contextlib.nullcontext()
        if fault == "no_grad_all_reduce":
            real = PD.sync_grads
            PD.sync_grads = lambda params, mesh: None
            ctx = contextlib.ExitStack()
            ctx.callback(setattr, PD, "sync_grads", real)
        A.flash_attention.launches = A.flash_attention_bwd.launches = 0
        with ctx:
            state, loss = step(state, x, t=t, noise=noise)
            sync()
            res = dict(loss=loss.item(), launches=(A.flash_attention.launches, A.flash_attention_bwd.launches))
            names = {id(p): n for n, p in state.model.named_parameters()}
            res["moments"] = {names[id(p)]: full_state(s["exp_avg"]).float().cpu()
                              for p, s in state.optimizer.state.items()}
            if fsdp:
                res["fraction"] = sharded_fraction(state)
                res["foreach"] = all(len({isinstance(p, DTensor) for p in g["params"]}) == 1
                                     and g["foreach"] is not False for g in state.optimizer.param_groups)
            res["ms"] = timed(state, step)
        return res

    def progress(what):
        print(f"  [rank {rank}] {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    out["ddpm"] = ddpm()
    progress("DDPM step")
    out["ddpm_fsdp"] = ddpm(fsdp=True)
    progress("DDPM step under FSDP")
    out["ddpm_no_grad_all_reduce"] = ddpm(fault="no_grad_all_reduce")
    if on_card:
        torch.cuda.empty_cache()

    cfg = load_seg_config(inp["scfg"], training={"accum_steps": DP_SEG_ACCUM, "device": device.type})
    imgs, lbls, draws = inp["seg"]
    loss_fn = make_seg_loss(cfg.training.loss_function.type, cfg.training.loss_function.params)
    local = shard_batch(mesh, (imgs, lbls), DP_SEG_ACCUM)

    def seg(fault=None):
        model = copy.deepcopy(inp["seg_model"]).to(device)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        st = create_seg_state(model, cfg.optimizer, 100, cfg.training.scheduler.type, cfg.training.scheduler.params)
        step = loop_segmentation.make_augmented_seg_train_step(cfg, loss_fn, mesh=mesh, dtype=dtype)
        ctx = contextlib.ExitStack()
        if fault == "per_rank_batchnorm":
            real = PS.synced_batchnorm
            PS.synced_batchnorm = lambda module, group: contextlib.nullcontext()
            ctx.callback(setattr, PS, "synced_batchnorm", real)
        sync()
        w0 = time.perf_counter()
        with ctx, SP._pinned_cudnn():
            _, loss, ig = step(st, local[0].to(device), local[1].to(device), draws=SP._draws_to(draws, device))
        sync()
        after = model.state_dict()
        return dict(loss=loss.item(), input_grad=ig.item(), wall_ms=(time.perf_counter() - w0) * 1e3,
                    update={k: (after[k] - before[k]).double().cpu() for k, _ in model.named_parameters()},
                    stats={f"{n}.{b}": (after[f"{n}.{b}"] - (1.0 - bn.momentum) * before[f"{n}.{b}"]).double().cpu()
                           for n, bn in model.named_modules() if isinstance(bn, torch.nn.BatchNorm2d)
                           for b in ("running_mean", "running_var")})

    out["seg"] = seg()
    out["seg_per_rank_batchnorm"] = seg("per_rank_batchnorm")
    progress("seg steps")
    if rank != 0:  # rank 0 carries the tensors; every rank its counts and times
        for key in ("ddpm", "ddpm_fsdp", "ddpm_no_grad_all_reduce"):
            out[key].pop("moments")
        for key in ("seg", "seg_per_rank_batchnorm"):
            out[key].pop("update"), out[key].pop("stats")
    return out


def _rel_l2_dict(a: dict, b: dict) -> float:
    num = sum(((a[k].double() - b[k].double()) ** 2).sum().item() for k in b)
    return (num / sum((b[k].double() ** 2).sum().item() for k in b)) ** 0.5


def phase_data_parallel(torch, A, device, card, tmp, scfg=None, dcfg=None, unet_cfg=None):
    """Phase 22 (module docstring): the single-process references on the card,
    then the two ranks, then `torchrun ... train-ddpm` with FSDP at world 1.
    `scfg`, `dcfg` (seg and diffusion YAMLs) and `unet_cfg` (UnetModelConfig
    fields) make a tiny CPU rehearsal possible: gloo, f32, no launch counts,
    `--device cpu` for the CLI."""
    import socket
    import subprocess

    from PIL import Image

    from weatherconverter_tpu_torch.core.config import UnetModelConfig, load_seg_config
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models.unet import Unet
    from weatherconverter_tpu_torch.probes import seg_step_parity as SP
    from weatherconverter_tpu_torch.training import diffusion as PD
    from weatherconverter_tpu_torch.training.loop_diffusion import ckpt_restore_into

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else None
    scfg = scfg or os.path.join(REPO, "configs", "segmentation.yaml")
    unet_cfg = unet_cfg or {}
    workdir = os.path.join(tmp, "dp")
    os.makedirs(workdir)
    torch.manual_seed(0)
    unet = Unet(UnetModelConfig(**unet_cfg))
    px = unet.config.im_size
    g = torch.Generator().manual_seed(22)
    x = torch.rand((DP_BATCH, px, px, 3), generator=g) * 2 - 1
    t, noise = torch.randint(0, 1000, (DP_BATCH,), generator=g), torch.randn((DP_BATCH, px, px, 3), generator=g)
    cfg = load_seg_config(scfg, training={"accum_steps": DP_SEG_ACCUM, "device": device.type})
    seg_model = SP.reference_model(cfg, SEG_RESIDUAL_SCALE)
    data = SP.batch(cfg, DP_BATCH)
    torch.save(dict(unet=unet.state_dict(), unet_cfg=unet_cfg, x=x, t=t, noise=noise, seg_model=seg_model, seg=data,
                    scfg=scfg), os.path.join(workdir, "inputs.pt"))

    # the single-process references on the card, from the same weights and draws
    state = PD.create_ddpm_state(unet.to(device), lr=1e-4)
    _, loss = PD.make_train_step(linear_schedule(1000, device=device), dtype=dtype)(
        state, x.to(device), t=t.to(device), noise=noise.to(device))
    names = {id(p): n for n, p in state.model.named_parameters()}
    ref = dict(loss=loss.item(), moments={names[id(p)]: s["exp_avg"].float().cpu()
                                          for p, s in state.optimizer.state.items()})
    del state, unet
    seg_ref = SP.run_step(cfg, seg_model, data, device, dtype)
    if on_card:
        torch.cuda.empty_cache()
    log(f"  single-process references on the card in {time.perf_counter() - t_phase:.1f} s: DDPM loss "
        f"{ref['loss']:.6f}, seg loss {seg_ref['loss']:.6f}")

    # (c) FSDP over NCCL at world size 1, through torchrun and the CLI: started here, beside the two ranks, and
    # held to its gates after them (its run is mostly process start-up, imports and the model's build)
    root = os.path.join(tmp, "dp_data")
    folder = os.path.join(root, "rgb_anon", "fog", "train")
    os.makedirs(folder)
    for i in range(2 * DP_BATCH):
        Image.fromarray(SyntheticImages(1, seed=30 + i)[0][:, :px * 228 // 128][:px]).save(
            os.path.join(folder, f"{i}.png"))
    runs = os.path.join(tmp, "dp_runs")
    t_run = time.perf_counter()
    with open(os.path.join(tmp, "torchrun.out"), "w") as out, open(os.path.join(tmp, "torchrun.err"), "w") as err:
        torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", "-m",
             "weatherconverter_tpu_torch.cli.main", "train-ddpm", "--config",
             dcfg or os.path.join(REPO, "configs", "diffusion.yaml"), "--set", "training.fsdp=true",
             "training.epochs=1", "training.save_interval=1", f"training.batch_size={DP_BATCH}",
             "training.num_workers=0", f"data.root_dir={root}", "data.acdc_images=rgb_anon", 'data.weather=["fog"]',
             f"folders.output={runs}"] + ([] if on_card else ["--device", "cpu"]),
            cwd=REPO, stdout=out, stderr=err)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    # plain child processes, not multiprocessing's spawn: that would leave its resource tracker running
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke._dp_rank({r}, {port}, "
                               f"{workdir!r}, {on_card})"], cwd=REPO) for r in range(DP_WORLD)]
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if [p.returncode for p in procs] != [0] * DP_WORLD:
        raise AssertionError(f"phase 22: the ranks exited {[p.returncode for p in procs]}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
    log(f"  two ranks over gloo on the one card: spawned, ran and joined in {time.perf_counter() - t0:.1f} s "
        f"(each loaded phase 1's library in {', '.join(f'{r['load_s']:.1f}' for r in ranks)} s)")

    # (a) DDPM: plain, FSDP, and the planted fault
    r0 = ranks[0]
    readings = {}
    for key in ("ddpm", "ddpm_fsdp", "ddpm_no_grad_all_reduce"):
        got = r0[key]
        readings[key] = (abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), _rel_l2_dict(got["moments"], ref["moments"]))
    for r in ranks:
        for key in ("ddpm", "ddpm_fsdp"):
            if on_card and r[key]["launches"] != (FLASH_CALLS_PER_UNET,) * 2:
                raise AssertionError(f"phase 22 rank {r['rank']} {key}: launches (K1, K3) {r[key]['launches']}, "
                                     f"expected {FLASH_CALLS_PER_UNET} each")
    for key in ("ddpm", "ddpm_fsdp"):
        loss_err, mom_err = readings[key]
        if not (loss_err <= DP_LIMITS["ddpm_loss"] and mom_err <= DP_LIMITS["ddpm_moments"]):
            raise AssertionError(f"phase 22 {key}: loss rel err {loss_err:.3e} (limit {DP_LIMITS['ddpm_loss']}), "
                                 f"moments rel L2 {mom_err:.3e} (limit {DP_LIMITS['ddpm_moments']})")
    loss_err, mom_err = readings["ddpm_no_grad_all_reduce"]
    if loss_err <= DP_LIMITS["ddpm_loss"] and mom_err <= DP_LIMITS["ddpm_moments"]:
        raise AssertionError(f"phase 22: the planted fault (gradient all-reduce skipped) passed: {readings}")
    if not all(r["ddpm_fsdp"]["foreach"] for r in ranks):
        raise AssertionError("phase 22: the FSDP optimizer mixes DTensors and plain tensors in a group or has its "
                             "foreach kernels off")
    for key, what in (("ddpm", "plain"), ("ddpm_fsdp", f"FSDP, {r0['ddpm_fsdp']['fraction']:.1%} of state bytes "
                                                        "sharded over the 2 ranks (gloo took FSDP2's "
                                                        "all_gather_into_tensor and reduce_scatter_tensor on CUDA "
                                                        "tensors), Adam's foreach kept")):
        log(f"  (a) DDPM step, default UNet, global batch {DP_BATCH} (4 a rank), bf16, {what}: loss rel err "
            f"{readings[key][0]:.3e} (limit {DP_LIMITS['ddpm_loss']}), Adam first moments rel L2 "
            f"{readings[key][1]:.3e} (limit {DP_LIMITS['ddpm_moments']}) against the single-process step; "
            f"K1/K3 launches a rank {[r[key]['launches'] for r in ranks]}")
    log(f"  (a) planted fault, the gradient all-reduce skipped: loss rel err {readings['ddpm_no_grad_all_reduce'][0]:.3e}"
        f", moments rel L2 {readings['ddpm_no_grad_all_reduce'][1]:.3e}: breaks the limits")
    for r in ranks:
        ms = {key: r[key]["ms"] for key in ("ddpm", "ddpm_fsdp", "ddpm_no_grad_all_reduce")}
        share = 1.0 - ms["ddpm_no_grad_all_reduce"]["wall"] / max(ms["ddpm"]["wall"], 1e-9)
        log(f"  (a) rank {r['rank']}: DDPM step (median of {DP_TIMED_STEPS} warm steps, wall / between its CUDA "
            f"events) plain {ms['ddpm']['wall']:.2f} / {ms['ddpm']['device']:.2f} ms, FSDP "
            f"{ms['ddpm_fsdp']['wall']:.2f} / {ms['ddpm_fsdp']['device']:.2f} ms, without the gradient all-reduce "
            f"{ms['ddpm_no_grad_all_reduce']['wall']:.2f} / {ms['ddpm_no_grad_all_reduce']['device']:.2f} ms (the "
            f"all-reduce's share of the plain step {share:.3f}), K1/K3 launches {r['ddpm']['launches']} a step "
            f"[{card}; two ranks sharing one card over gloo: no scaling figure]")

    # (b) seg
    pooled = SP.pooled_leaves(seg_model)
    seg_read = {}
    for key in ("seg", "seg_per_rank_batchnorm"):
        c = SP.compare(dict(r0[key], pred=seg_ref["pred"]), seg_ref, pooled)  # the ranks run no eval step
        seg_read[key] = (c["loss"], c["update_without_pooled"], c["stats"])
    loss_err, upd_err, stats_err = seg_read["seg"]
    if not (loss_err <= DP_LIMITS["seg_loss"] and upd_err <= DP_LIMITS["seg_update"]
            and stats_err <= DP_LIMITS["seg_stats"]):
        raise AssertionError(f"phase 22 seg: loss {loss_err:.3e}, update without pooled {upd_err:.3e}, stats "
                             f"{stats_err:.3e} against the limits {DP_LIMITS}")
    f_loss, f_upd, f_stats = seg_read["seg_per_rank_batchnorm"]
    if f_loss <= DP_LIMITS["seg_loss"] and f_upd <= DP_LIMITS["seg_update"] and f_stats <= DP_LIMITS["seg_stats"]:
        raise AssertionError(f"phase 22: the planted fault (per-rank BatchNorm) passed: {seg_read}")
    log(f"  (b) seg step, {cfg.model.name}, global batch {DP_BATCH} over {DP_SEG_ACCUM} microbatches (2 a rank each), "
        f"synced BatchNorm, bf16, residual scales x {SEG_RESIDUAL_SCALE}: loss rel err {loss_err:.3e} (limit "
        f"{DP_LIMITS['seg_loss']}), update rel L2 without the pooled leaves {upd_err:.3e} (limit "
        f"{DP_LIMITS['seg_update']}), BatchNorm statistics {stats_err:.3e} (limit {DP_LIMITS['seg_stats']}) against "
        f"the single-process step; planted fault, a per-rank BatchNorm: {f_loss:.3e}, {f_upd:.3e}, {f_stats:.3e}")
    for r in ranks:
        log(f"  (b) rank {r['rank']}: seg step {r['seg']['wall_ms']:.1f} ms wall (first step, cuDNN pinned to its "
            f"heuristics) [{card}; two ranks sharing one card: no scaling figure]")

    # (c) the torchrun started above
    try:
        torchrun.wait(timeout=max(DP_TIMEOUT_S - (time.perf_counter() - t_run), 1))
    except subprocess.TimeoutExpired:
        torchrun.kill()
        torchrun.wait()
    secs = time.perf_counter() - t_run
    stdout, stderr = (open(os.path.join(tmp, f"torchrun.{n}")).read() for n in ("out", "err"))
    fsdp_line = next((ln for ln in stdout.splitlines() if ln.startswith("FSDP:")), None)
    listing = sorted(os.listdir(runs)) if os.path.isdir(runs) else []
    if torchrun.returncode != 0 or listing != ["0"] or fsdp_line is None:
        raise AssertionError(f"torchrun train-ddpm fsdp: exit {torchrun.returncode}, runs {listing}, FSDP line "
                             f"{fsdp_line!r}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    plain = PD.create_ddpm_state(Unet(UnetModelConfig(**unet_cfg)).to(device), lr=1e-4)
    ckpt_restore_into(os.path.join(runs, "0", "checkpoints"), plain)
    if plain.step != 2 or not all(torch.isfinite(p).all().item() for p in plain.model.parameters()):
        raise AssertionError(f"torchrun train-ddpm fsdp: the checkpoint's step {plain.step}, expected 2")
    log(f"  (c) torchrun --nproc-per-node 1 ... cli.main train-ddpm, training.fsdp=true, NCCL at world size 1: exit 0 in "
        f"{secs:.1f} s (process start-up included; beside the two ranks), one run directory, {fsdp_line!r}, its "
        f"checkpoint (step {plain.step}) loaded into a plain single-process state")
    log(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")


# phase 23: spatial guidance across two ranks on the one card, then the host feed
SP_WORLD, SP_BATCH, SP_STEPS, SP_TIMEOUT_S = 2, 2, 4, 400
# the timed chains run translation.yaml's lambda, 60, for SP_STEPS steps. The sharded chain is held against
# the single-process one over one guided step at SP_CHECK_LAM: with the phase's random seg weights at 512 px,
# lambda 60 moves the latent by about one f32 ulp a step, and under bf16 any difference in the second step's
# UNet input flips its bf16 roundings, which swamps the guidance (PERF.md section 6: 4 steps at lambda
# 60 and at 6000 both read the guidance's effect at ~3.4e-4, the sharded chain 1.0 of it at 6000).
SP_LAM = 60.0
SP_CHECK_LAM = 6e4
# the one-step check's largest difference from the single-process step, over the guidance's own effect (the
# single step's largest difference from the unguided one), and one guidance field's rel L2 from the unsharded
# field, under the chain's bf16 autocast and in f32 with TF32 off: read on the card (PERF.md section 6:
# the step 3.09e-2, the per-shard count 1.33; the fields 9.35e-3 and 4.27e-4, a zero halo 0.110 and 0.105)
SP_LIMIT = 0.1
SP_FIELD_LIMITS = (3e-2, 5e-3)
# the host feed's smoke: 8 PNG and 8 JPEG files at ACDC's size, one untimed epoch and 2 timed; the probe
# weatherconverter_tpu_torch/probes/host_feed.py measures it at 128 + 128 files
FEED_FILES, FEED_SIZE, FEED_WORKERS, FEED_EPOCHS = 8, (1920, 1080), 8, 2


def _spatial_rank(rank: int, port: int, workdir: str, on_card: bool = True) -> None:
    """One rank of phase 23 (a), in a child process: gloo on card 0 (or the
    CPU in a rehearsal), `_spatial_rank_cases`, written to <workdir>/rank<r>.pt."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, REPO)
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False  # main()'s settings
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=SP_WORLD)
    try:
        torch.save(_spatial_rank_cases(torch, rank, workdir, on_card), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spatial_rank_cases(torch, rank: int, workdir: str, on_card: bool) -> dict:
    """Rank 0 first runs the single-process chains (guided, unguided) and
    the unsharded seg gradient, alone; then both ranks run the sharded chain
    (warm-up, then timed), the sharded seg gradient, the chain with the
    planted per-shard valid-pixel count, and the seg gradient with the
    planted zero halo."""
    import contextlib

    from weatherconverter_tpu_torch.cli.commands import load_seg_model, load_srgan, load_unet
    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.guidance.sgg import guidance_field
    from weatherconverter_tpu_torch.guidance.translate import make_translate_fn, translate_entry
    from weatherconverter_tpu_torch.ops import attention as A
    from weatherconverter_tpu_torch.ops import cuda_build
    from weatherconverter_tpu_torch.parallel import spatial

    t0 = time.perf_counter()
    if on_card:
        cuda_build.library()  # phase 1's build, loaded from _build/
    device = torch.device("cuda" if on_card else "cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else None
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    cfg = load_translation_config(inp["tcfg"])
    unet = load_unet(cfg.diffusion.model, None, 0).to(device)
    seg = load_seg_model(cfg.seg, None, 1).requires_grad_(False).to(device)
    gen = load_srgan(cfg.srgan, None, 2).to(device)
    sched = linear_schedule(cfg.diffusion.diffusion.num_timesteps, cfg.diffusion.diffusion.beta_start,
                            cfg.diffusion.diffusion.beta_end, device=device)
    x, gt = inp["x"].to(device), inp["gt"].to(device)
    noise0, z_steps = (n.to(device) for n in inp["noise"])
    # the chains enter where the config's does (t = guidance.num_steps - 1: 499 in translation.yaml), by
    # translate_entry's q-sample of x with the replayed noise0, and run the first steps of the config's span;
    # they return the final latent (final_sr=False), in f32: under bf16 the SRGAN's output would round the
    # guidance's effect
    start_t = cfg.guidance.num_steps - 1
    xt0 = translate_entry(sched, x, cfg.guidance.num_steps, None, start_t, noise0)
    kw = dict(xt_init=xt0, mode="fixed", guidance_space="sr", num_classes=cfg.seg.model.num_classes, dtype=dtype,
              final_sr=False)
    out = dict(rank=rank, load_s=time.perf_counter() - t0)
    pool = gt.shape[1] // x.shape[1]
    amp = torch.autocast(device.type, dtype=dtype) if dtype is not None else contextlib.nullcontext()
    peak = (lambda: torch.cuda.max_memory_allocated()) if on_card else (lambda: 0)
    base = (lambda: torch.cuda.memory_allocated()) if on_card else (lambda: 0)

    def reset():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        return base()

    def chain(style, mesh=None, steps=SP_STEPS, lam=SP_LAM):
        """The final latent of the first `steps` steps, on the CPU."""
        fn = make_translate_fn(unet, sched, seg, gen, guidance_style=style, spatial_mesh=mesh, lam=lam,
                               num_steps=steps, t_offset=start_t - steps + 1, **kw)
        return fn(x, gt, noise=(None, z_steps[:steps])).float().cpu()

    def timed(mesh=None):
        """The config's GSG chain of SP_STEPS steps after a warm-up (cuDNN's choices, the kernels' first
        launch): (its final latent, ms a step, its peak above what was allocated before it, K1 launches)."""
        chain("gsg", mesh)
        before = reset()
        A.flash_attention.launches = 0
        w0 = time.perf_counter()
        y = chain("gsg", mesh)
        sync()
        ms = (time.perf_counter() - w0) * 1e3 / SP_STEPS
        return y, ms, (peak() - before) / 2**30, A.flash_attention.launches

    def check(style, mesh=None):
        """One step at SP_CHECK_LAM (see there), from the same latent."""
        return chain(style, mesh, steps=1, lam=SP_CHECK_LAM)

    def field(ctx, low=True):
        """One guidance field (GSG's) at the input's upscale, and the peak of the seg forward and
        backward above what was allocated before it; under the chain's autocast, or in f32 (`low`
        False; TF32 is off in the ranks, as in the script)."""
        prec = amp if low else contextlib.nullcontext()
        with torch.no_grad(), prec:
            sr_xt = gen(x.permute(0, 3, 1, 2))
        before = reset()
        with prec:
            if ctx is None:
                f = guidance_field(seg, sr_xt, gt, pool)
            else:
                with ctx:
                    f = guidance_field(seg, ctx.own_rows(sr_xt, 2), ctx.own_rows(gt, 1), pool)
        sync()
        return f.float().cpu(), (peak() - before) / 2**30

    if rank == 0:
        out["single"] = timed()
        out["check_single"], out["check_unguided"] = check("gsg"), check("none")
        out["field_single"], out["field_single_f32"] = field(None), field(None, low=False)
    mesh = spatial.make_spatial_mesh(data=1, space=SP_WORLD)
    out["sharded"] = timed(mesh)
    out["check_sharded"] = check("gsg", mesh)
    out["field_sharded"] = field(spatial.SpatialContext(mesh))
    out["field_sharded_f32"] = field(spatial.SpatialContext(mesh), low=False)
    real = spatial.SpatialContext.sum_over_space
    spatial.SpatialContext.sum_over_space = lambda self, t, differentiable: (
        real(self, t, differentiable) if differentiable else t)  # a planted fault: a per-shard count
    try:
        out["check_fault"] = check("gsg", mesh)
    finally:
        spatial.SpatialContext.sum_over_space = real
    gather = spatial._all_gather
    spatial._all_gather = lambda t, group, width: [  # a planted fault: every halo row fetched as zeros
        p if q == rank else torch.zeros_like(p) for q, p in enumerate(gather(t, group, width))]
    try:
        out["field_zero_halo"] = field(spatial.SpatialContext(mesh))
        out["field_zero_halo_f32"] = field(spatial.SpatialContext(mesh), low=False)
    finally:
        spatial._all_gather = gather
    print(f"  [rank {rank}] models loaded at {out['load_s']:.1f} s, spatial cases at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_spatial_feed(torch, device, card, tmp, tcfg=None, feed_files=FEED_FILES, feed_size=FEED_SIZE):
    """Phase 23 (module docstring): (a) spatial guidance over two ranks on the
    card, (b) the host feed. `tcfg` (a translation YAML), `feed_files` and
    `feed_size` make a tiny CPU rehearsal possible (gloo, f32, no launch
    counts)."""
    import socket
    import subprocess

    from weatherconverter_tpu_torch.data import native
    from weatherconverter_tpu_torch.probes import host_feed

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    tcfg = tcfg or os.path.join(REPO, "configs", "translation.yaml")
    from weatherconverter_tpu_torch.core.config import load_translation_config

    cfg = load_translation_config(tcfg)
    s, hr = cfg.diffusion.model.im_size, cfg.diffusion.model.im_size * cfg.srgan.upscale_factor
    workdir = os.path.join(tmp, "spatial")
    os.makedirs(workdir)
    g = torch.Generator().manual_seed(23)
    x = torch.randn((SP_BATCH, s, s, 3), generator=g) * 0.2
    # blocky labels with an ignored band, so that the two shards hold different valid counts
    gt = torch.randint(0, cfg.seg.model.num_classes, (SP_BATCH, hr // 16, hr // 16), generator=g)
    gt = gt.repeat_interleave(16, 1).repeat_interleave(16, 2)
    gt[:, : hr // 8] = 255
    noise = (torch.randn((SP_BATCH, s, s, 3), generator=g), torch.randn((SP_STEPS, SP_BATCH, s, s, 3), generator=g))
    torch.save(dict(tcfg=tcfg, x=x, gt=gt, noise=noise), os.path.join(workdir, "inputs.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke._spatial_rank({r}, {port}, "
                               f"{workdir!r}, {on_card})"], cwd=REPO) for r in range(SP_WORLD)]
    deadline = time.monotonic() + SP_TIMEOUT_S
    try:
        for p in procs:
            p.wait(max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if [p.returncode for p in procs] != [0] * SP_WORLD:
        raise AssertionError(f"phase 23: the ranks exited {[p.returncode for p in procs]}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(SP_WORLD)]
    r0 = ranks[0]
    single, unguided = r0["check_single"], r0["check_unguided"]
    effect = (single - unguided).abs().max().item()
    if not effect > 0:
        raise AssertionError("phase 23: the guidance does not move the translation; nothing to compare")
    errs = {}
    for r in ranks:
        for key in ("sharded", "check_sharded", "check_fault"):
            y, want = (r[key][0], r0["single"][0]) if key == "sharded" else (r[key], single)
            if y.shape != want.shape or not torch.isfinite(y).all().item():
                raise AssertionError(f"phase 23 rank {r['rank']} {key}: output {tuple(y.shape)}, finite "
                                     f"{torch.isfinite(y).all().item()}")
            errs[(r["rank"], key)] = (y - want).abs().max().item() / (effect if key != "sharded" else 1.0)
    # one guidance field, sharded (and with the zero halo planted) against the unsharded one, by rank:
    # {precision: (sharded rel L2s, zero-halo rel L2s)}
    fields = {prec: tuple([_rel_l2(r[f"field_{key}{sfx}"][0], r0[f"field_single{sfx}"][0]) for r in ranks]
                          for key in ("sharded", "zero_halo"))
              for prec, sfx in (("bf16 autocast" if on_card else "f32 as the chain", ""), ("f32", "_f32"))}
    sharded_err = max(errs[(r, "check_sharded")] for r in range(SP_WORLD))
    fault_err = min(errs[(r, "check_fault")] for r in range(SP_WORLD))
    start_t = cfg.guidance.num_steps - 1
    log(f"  (a) {SP_WORLD} gloo ranks on the one card, space={SP_WORLD}, spawned, ran and joined in "
        f"{time.perf_counter() - t0:.1f} s; {os.path.basename(tcfg)}: {s} px latents, {cfg.srgan.upscale_factor}x "
        f"SRGAN to {hr} px, {cfg.seg.model.name} at OS{cfg.seg.model.output_stride}, batch {SP_BATCH}, GSG in "
        f"'sr' space from t = {start_t}, {'bf16 autocast' if on_card else 'f32'}, the draws replayed")
    log(f"  (a) one guided step at lam {SP_CHECK_LAM}, the sharded chain's latent against the single-process "
        f"one's: max |diff| / max |guided - unguided| = "
        f"{', '.join(f'{errs[(r, "check_sharded")]:.3e}' for r in range(SP_WORLD))} by rank (limit {SP_LIMIT}; "
        f"the guidance's own effect {effect:.4e}); planted fault, a per-shard valid-pixel count: "
        f"{', '.join(f'{errs[(r, "check_fault")]:.3e}' for r in range(SP_WORLD))}; the timed chains ({SP_STEPS} "
        f"steps at lam {SP_LAM}), max |sharded - single|: "
        f"{', '.join(f'{errs[(r, "sharded")]:.3e}' for r in range(SP_WORLD))} (bf16's rounding, which the "
        f"UNet amplifies from the second step on: not gated)")
    for (prec, (sharded, halo)), limit in zip(fields.items(), SP_FIELD_LIMITS):
        log(f"  (a) one guidance field (GSG's, at the input's upscale), {prec}, sharded against unsharded, rel L2 "
            f"by rank: {', '.join(f'{e:.3e}' for e in sharded)} (limit {limit}); planted fault, every halo row "
            f"fetched as zeros: {', '.join(f'{e:.3e}' for e in halo)}")
    if sharded_err > SP_LIMIT:
        raise AssertionError(f"phase 23: the sharded chain is {sharded_err:.3e} of the guidance's effect from the "
                             f"single-process chain (limit {SP_LIMIT})")
    if fault_err <= SP_LIMIT:
        raise AssertionError(f"phase 23: the planted fault (a per-shard valid-pixel count) passed: {fault_err:.3e}")
    for (prec, (sharded, halo)), limit in zip(fields.items(), SP_FIELD_LIMITS):
        if max(sharded) > limit:
            raise AssertionError(f"phase 23: the sharded guidance field ({prec}) is {max(sharded):.3e} (rel L2) from "
                                 f"the unsharded one (limit {limit})")
        if min(halo) <= limit:
            raise AssertionError(f"phase 23: the planted fault (a zero halo) passed the {prec} field's limit: "
                                 f"{min(halo):.3e}")
    expected = FLASH_CALLS_PER_UNET * SP_STEPS
    for r in ranks:
        if on_card and r["sharded"][3] != expected:
            raise AssertionError(f"phase 23 rank {r['rank']}: K1 launches {r['sharded'][3]}, expected {expected}")
    single_ms, single_peak = r0["single"][1], r0["single"][2]
    log(f"  (a) single process (rank 0 alone on the card): {single_ms:.1f} ms a step, peak above the weights "
        f"{single_peak:.3f} GiB over the chain, {r0['field_single'][1]:.3f} GiB over one seg forward and backward; "
        f"K1 launches {r0['single'][3]} a run of {SP_STEPS} steps [{card}]")
    for r in ranks:
        log(f"  (a) rank {r['rank']}: sharded chain {r['sharded'][1]:.1f} ms a step (both ranks on the one card, over "
            f"gloo), peak above the weights {r['sharded'][2]:.3f} GiB over the chain, {r['field_sharded'][1]:.3f} GiB "
            f"over one seg forward and backward ({r['field_sharded'][1] / max(r0['field_single'][1], 1e-9):.3f} of "
            f"the unsharded); K1 launches {r['sharded'][3]} a run (expected {expected}) [{card}]")

    # (b) the host feed
    reason = None
    missing = native.missing_headers()
    if missing:
        reason = f"missing headers {missing}"
    else:
        native.build()  # the headers are there: a failed build fails the phase
        if not native.available():
            raise AssertionError(f"phase 23: the native decoder built but did not load: {native.unavailable_reason()}")
    feed = host_feed.measure(os.path.join(tmp, "feed"), feed_files, feed_size, FEED_EPOCHS, FEED_WORKERS)
    if reason is None and feed["native_vs_pil_levels"] > 1:
        raise AssertionError(f"phase 23: the native decoder is {feed['native_vs_pil_levels']} levels from PIL "
                             f"(limit 1)")
    if reason is not None:
        log(f"  (b) native decoder: unavailable ({reason}); the datasets decode with PIL")
    for ln in host_feed.report(feed):
        log(f"  (b) {ln}")
    log(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")


def _round(x):
    return None if x is None else round(x, 4)


PTXAS_KERNELS = ("flash_fwd_qk_i8_wgmma_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                 "flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
                 "flash_fwd_f32_wgmma_kernel", "flash_bwd_f32_dq_kernel", "flash_bwd_f32_dkv_kernel",
                 "flash_bwd_f32_dq_wgmma_kernel", "flash_bwd_f32_dkv_wgmma_kernel", "absmax_qk_kernel",
                 "quantize_qk_kernel",
                 "probe_exp2_attn_wgmma_kernel", "probe_qk_kernel", "probe_dw3x3_kernel",
                 "probe_dw_fma81_kernel")


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: its name, registers and spill bytes."""
    lines, name, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next((k for k in PTXAS_KERNELS if k in mangled), mangled)
            args = (["f16"] if "6__half" in mangled else ["bf16"] if "13__nv_bfloat16" in mangled or "4Bf16E" in mangled
                    else ["int8"] if "2I8E" in mangled else ["f32"] if "IfLi" in mangled else [])
            if "I8Scores" in mangled:  # K1-f32's kernels with int8 scores
                args.append("K2-f32")
            dims = re.findall(r"Li(\d+)E", mangled)  # K1: <T, D, G>, G the head dim on D-wide tiles
            if "dkv" in name and len(dims) == 2:  # K3's and K3-f32's pass 2: <(T,) D, which gradients>
                args.append(f"D={dims[0]}, {('dV', 'dK', 'dK and dV')[int(dims[1]) - 1]}")
            elif dims:
                args.append(f"D={dims[-1]}" + (f" on {dims[0]}-wide tiles" if dims[0] != dims[-1] else ""))
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
    log("settings: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False cudnn.benchmark=True; the library's "
        "translation, sampler and training phases (3-12) run under bf16 autocast, the inference commands (13-21) and "
        "phase 25 in f32")

    log("phase 1: build")
    t0 = time.perf_counter()
    cuda_build.library()
    ptxas = ptxas_summary(cuda_build.build_log())
    log(f"  built {', '.join(cuda_build.SOURCES)} in {time.perf_counter() - t0:.1f} s; ptxas, per kernel:")
    for ln in ptxas:
        log(f"    {ln}")
    # K1-K4, the wgmma kernels, and the f32 flash kernels K1-f32 and K3-f32 must not spill; the log is that of the
    # loaded library, also when an earlier run built it
    gated = [k for k in PTXAS_KERNELS if "wgmma_kernel" in k or "_f32_" in k]
    wgmma = [ln for ln in ptxas if any(ln.startswith(k + "<") or ln.startswith(k + ":") for k in gated)]
    missing = [k for k in gated if not any(ln.startswith(k + "<") or ln.startswith(k + ":") for ln in wgmma)]
    if missing:
        raise AssertionError(f"the build log does not name {missing}: the spill and wgmma gates have nothing to read")
    # K2-f32 at its six head dims (K1-f32's two kernels with int8 scores) and the quantizer's f32 kernels
    k2_f32 = [ln for ln in wgmma if "K2-f32" in ln]
    quant_f32 = [ln for ln in ptxas if ln.startswith(("absmax_qk_kernel<f32", "quantize_qk_kernel<f32"))]
    if len(k2_f32) != 6 or len(quant_f32) != 4:
        raise AssertionError(f"the build log names K2-f32 {len(k2_f32)} times (6 head dims) and the f32 quantizer's "
                             f"kernels {len(quant_f32)} times (two passes, two group sizes): {k2_f32 + quant_f32}")
    spilled = [ln for ln in wgmma + quant_f32 if " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    if spilled:
        raise AssertionError(f"ptxas reports register spills in K1-K4, K1-f32, K2-f32, K3-f32 or the f32 quantizer: "
                             f"{spilled}")
    if "Potential Performance Loss" in cuda_build.build_log():
        raise AssertionError("ptxas serialized the wgmma instructions of a kernel (see the build log): "
                             + next(ln for ln in cuda_build.build_log().splitlines() if "Potential" in ln))

    log(f"phase 2: kernels against their plain versions, bf16 and f32 [{card}]")
    kernel_results = phase_kernels(torch, A, device, card)
    kernel_results.update(phase_quantizer(torch, A, device, card))
    kernel_results["flash_attention_bwd"] = phase_backward_kernel(torch, A, device, card)
    kernel_results["flash_attention_bwd_f32"] = phase_backward_f32_kernel(torch, A, device, card)
    kernel_results.update(phase_qk_i8_f32(torch, A, device, card))
    k2_d192_launches = phase_unet_256(torch, A, device)
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
    train_reference = phase_train_reference(torch, device, UnetModelConfig())

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
    phase_int8_quality(torch, sampler_state, card, ddim=time.perf_counter() - _T0 < INT8_DDIM_BEFORE_S)
    del sampler_state
    torch.cuda.empty_cache()

    import tempfile

    # from phase 13 on cuDNN picks its algorithms by its heuristics, as in a process of the CLI, the server or a
    # training loop (torch's default): the timed windows of phases 3, 6 and 10 keep its first-shape trials, which
    # took ~96 s of phase 16's 120 before phase 16 ran without them (PERF.md section 6)
    with tempfile.TemporaryDirectory() as tmp, \
            torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        log(f"phase 13: the CLI on the card, every inference command in f32 [{card}]")
        cli_k2_f32_launches = phase_cli(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 14: the server on the card [{card}]")
        server_k2_launches, server_k2_bf16_launches, server_quant_bf16_launches = phase_server(
            torch, A, device, card, tmp, steps=SERVER_STEPS)
        torch.cuda.empty_cache()
        log(f"phase 15: segmentation on the card [{card}]")
        phase_seg(torch, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 16: the rest of the DeepLab family on the card [{card}]")
        phase_seg_family(torch, device, card)
        torch.cuda.empty_cache()
        log(f"phase 17: SRGAN training on the card [{card}]")
        phase_srgan(torch, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 18: the legacy UNet on the card [{card}]")
        legacy_launches, k2_d24_launches = phase_legacy(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 19: the quality command on the card [{card}]")
        phase_quality(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 20: visualize and translate --debug-dir on the card [{card}]")
        phase_visualize_debug(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 21: export-hlo --attn int8 and serving/hlo_runtime on the card [{card}]")
        # the fresh process that loads the archive runs beside phase 22, and is held to its gates after it
        export_finish = phase_export(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 22: data parallel on the card [{card}]")
        phase_data_parallel(torch, A, device, card, tmp)
        torch.cuda.empty_cache()
        log("  phase 21's fresh process, which ran beside phase 22:")
        export_finish()
        log(f"phase 23: spatial guidance across two ranks and the host feed [{card}]")
        phase_spatial_feed(torch, device, card, tmp)
        torch.cuda.empty_cache()
        log(f"phase 24: DDPM training in f32 on the card [{card}]")
        f32_fwd_launches, f32_bwd_launches = phase_train_f32(torch, A, device, card, tmp, train_reference)
        del train_reference
        torch.cuda.empty_cache()
        log(f"phase 25: the f32 inference chain, card against CPU [{card}]")
        phase_f32_chain(torch, A, device, card)

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
        ("flash_attention_f32", csrc + "flash_fwd_f32.cu", "weatherconverter_tpu/ops/attention.py:78",
         legacy_launches[3]),
        ("flash_attention_f32_train", csrc + "flash_fwd_f32.cu", "weatherconverter_tpu/ops/attention.py:456",
         f32_fwd_launches),
        ("flash_attention_bwd_f32", csrc + "flash_bwd_f32.cu", "weatherconverter_tpu/ops/attention.py:305",
         f32_bwd_launches),
        ("flash_attention_qk_i8_per_item", csrc + "flash_fwd_qk_i8.cu",
         "weatherconverter_tpu/ops/attention.py:125 under jax.vmap (weatherconverter_tpu/serving/server.py:191-226)",
         server_k2_bf16_launches),
        ("quantize_qk_i8_per_item", csrc + "quantize_i8.cu",
         "weatherconverter_tpu/ops/attention.py:173-189 under jax.vmap (weatherconverter_tpu/serving/server.py:191-226)",
         server_quant_bf16_launches),
        ("flash_attention_qk_i8_f32", csrc + "flash_fwd_f32.cu",
         "weatherconverter_tpu/ops/attention.py:125 (on an f32 V, as JAX's inference commands run it)",
         cli_k2_f32_launches),
        ("quantize_qk_i8_f32", csrc + "quantize_i8.cu",
         "weatherconverter_tpu/ops/attention.py:173-189 on f32 q and k (plain jnp that XLA fused there)",
         cli_k2_f32_launches),
        ("flash_attention_qk_i8_f32_per_item", csrc + "flash_fwd_f32.cu",
         "weatherconverter_tpu/ops/attention.py:125 under jax.vmap on an f32 V (weatherconverter_tpu/serving/server.py"
         ":191-226)", server_k2_launches),
        ("quantize_qk_i8_f32_per_item", csrc + "quantize_i8.cu",
         "weatherconverter_tpu/ops/attention.py:173-189 under jax.vmap on f32 q and k "
         "(weatherconverter_tpu/serving/server.py:191-226)", server_k2_launches),
        ("flash_attention_qk_i8_d24", csrc + "flash_fwd_qk_i8.cu", "weatherconverter_tpu/ops/attention.py:125",
         k2_d24_launches),
        ("flash_attention_qk_i8_d192", csrc + "flash_fwd_qk_i8.cu", "weatherconverter_tpu/ops/attention.py:125",
         k2_d192_launches),
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
        "path shapes (K1's and K3's lines at (1024, 192) and K1's at (1024, 24) stand beside them in phase 2, not in "
        "the sums); K2's ms includes its quantizer's; K1-f32's are sums over the legacy UNet's (1024, 16) and "
        "(1024, 24) in f32, its library sdpa's f32 forward; flash_attention_f32_train (K1-f32 with l) and "
        "flash_attention_bwd_f32 (K3-f32) sum over the four path shapes in f32, their library sdpa's f32 forward and "
        "f32 backward alone; launches are from "
        "the headline run (K1), the int8 run (K2, quantizer), the loop_diffusion.train run (K3), phase 18's f32 "
        "legacy run (K1-f32) and phase 24's train-ddpm run in f32 (K1-f32 with l, K3-f32); the *_per_item lines "
        "are K2 and its quantizer with one int8 scale a batch row (the "
        "server's), timed in phase 2 at the path shapes (K2's ms whole, quantizer included), launched in phase 14's "
        "bf16 chain of the per-row service (bf16 V; the server itself runs in f32); the *_f32 lines are K2-f32 "
        "(quantizer included, P V in 3xTF32) and the quantizer on f32 q and k, timed in phase 2 at the four path "
        "shapes in f32 (library: sdpa's f32 forward), launched in phase 13's first translate (DPM-20, f32) and, "
        "*_f32_per_item, in phase 14's K2-f32 full-sweep run; the *_d24 and *_d192 lines are K2 (quantizer included) at (1024, 24) and (1024, 192), "
        "B*H = 32, timed in phase 2, launched at those head dims in phase 18's bf16 qk_int8 legacy run (attn_up2) "
        "and the 256 px UNet's qk_int8 forward; for the probes K4-K7 "
        "they are from phase 9's probe runs (K4: sums over D=64 and D=16, library the same sdpa forward; "
        "qk_dot: int8 plus bf16, k_bf16 at scripts/probe_int8_dot.py:34, library torch._int_mm plus "
        "torch.mm(out_dtype=torch.float32), null if this torch lacks the latter; dw3x3: library cuDNN's channels-last "
        "depthwise conv; null where no single PyTorch call computes the function). bound_ms is the larger of "
        "bytes over 3.35 TB/s and operations over the peak of their type (989 TFLOP/s bf16, 1979 TOP/s int8, "
        "494.7 TFLOP/s TF32, three TF32 products a K1-f32 or K3-f32 product and a K2-f32 P V product, 67 TFLOP/s f32, "
        "3.86e12 exponentials/s)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _become_subreaper() -> None:
    """Have orphaned descendants (a torchrun worker whose agent died, say)
    re-parented to this process, so that `_stop_descendants` finds them."""
    import ctypes

    try:
        ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def _descendants() -> dict[int, str]:
    """{pid: command line} of every live process below this one, from /proc."""
    parent, state = {}, {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                parent[int(name)], state[int(name)] = int(fields[1]), fields[0]
            except (OSError, IndexError, ValueError):
                pass
    found, frontier = {}, [os.getpid()]
    while frontier:
        pid = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        frontier += kids
        for pid in kids:
            if state[pid] != "Z":
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        found[pid] = f.read().replace(b"\0", b" ").decode(errors="replace")[:200]
                except OSError:
                    pass
    return found


def _stop_descendants(grace_s: float = 5.0) -> None:
    """Stop every process this run started that is still running at its end,
    then reap what is left of this process's children; what it had to stop
    goes to standard error."""
    import signal

    left = _descendants()
    if left:
        print(f"chip_smoke: stopping the processes still running at the end: {left}", file=sys.stderr, flush=True)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = _descendants()
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break


if __name__ == "__main__":
    _become_subreaper()
    try:
        code = main()
    finally:
        _stop_descendants()
    sys.exit(code)
