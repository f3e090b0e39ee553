"""The legacy UNet's precision check: does its chain on the card sample as
its f32 chain does?

JAX builds the legacy UNet in f32 (weatherconverter_tpu/models/unet_legacy.py:151)
and its `sample` enables the int8 kernel before the legacy branch. On the
card the port can run it in bf16 (under autocast with qk_int8: K2 at
attn_down3, D = 16, and attn_up2, D = 24), in f32 (K1-f32 at both, no TF32)
or in f32 with qk_int8 (K2-f32 at both: JAX's default).
Each card chain is held against an f32 chain of the same weights and the
same draws, run on the CPU (the plain versions), by the method of
probes/int8_quality.py: a chain this long amplifies any change of the size
of a rounding. The floor is the f32 chain's own spread: N runs (5 by
default) whose initial draw gets PERT_SCALE * N(0, 1) added, each compared
with the unperturbed f32 run by the Pearson correlation of the outputs. A
card chain passes if its correlation with the unperturbed f32 run is at
least the floor's mean - 2 sigma (ddof 1). The CLI's `sample --sampler
legacy` follows JAX's default, f32 with K2-f32 (cli/commands.py), whatever
the verdicts; the f32 chain's is the one the f32 arithmetic must pass.

Weights: LegacyUNet(128) from a seed, its output conv scaled so that eps has
unit standard deviation on N(0, 1) input at t = T / 2, as a trained model's
has (torch's default init gives 0.08, which would leave the chain to its
noise and the check nothing to see). The schedule is the linear 1000-step
one; `ddpm_sample_legacy` strides it when --steps < 1000.

    python -m weatherconverter_tpu_torch.probes.legacy_precision                     # 1000 steps, batch 1
    python -m weatherconverter_tpu_torch.probes.legacy_precision --steps 20 --batch 2

On the card only (exit 2 without one). The result goes to
chiprun_out/legacy_precision_<steps>_b<batch>.json under the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample_legacy
from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
from weatherconverter_tpu_torch.core.precision import f32_arithmetic
from weatherconverter_tpu_torch.models.unet_legacy import LegacyUNet
from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.probes import common

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PERT_SCALE = 1e-3
N_SIGMA = 2.0
SEED = 0  # the weights', the draws' and (times 1000 plus the run's index) the perturbations'


def build(image_size: int = 128) -> LegacyUNet:
    """The seeded legacy UNet on the CPU in f32, eps scaled to unit std at
    1 - alpha_bar[T / 2] of the linear schedule."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = LegacyUNet(image_size)
        x = torch.randn(2, 3, image_size, image_size)
    t = float(linear_schedule(1000).one_minus_cum_prod[500])
    with torch.no_grad():
        model.output.weight.div_(model(x, torch.full((2,), t)).std())
    return model


def draws(shape, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_init (B, H, W, 3), z_steps (steps, B, H, W, 3)), N(0, 1) on the CPU from SEED."""
    g = torch.Generator().manual_seed(SEED)
    return torch.randn(tuple(shape), generator=g), torch.randn((steps, *shape), generator=g)


# the device chains: (name, autocast dtype or None for f32, qk_int8)
RUNS = (("bf16", torch.bfloat16, True), ("f32", None, False), ("f32_qk_int8", None, True))


def device_chain(model: LegacyUNet, shape, steps: int, device, dtype, qk_int8: bool, noise) -> dict:
    """One chain on `device`: under `dtype` autocast (the model built with
    `qk_int8`), or in f32 inside `f32_arithmetic` (dtype None; K2-f32 with
    `qk_int8`). Returns its output on the CPU, launches (K1, K2, quantizer,
    K1-f32) and K2's by V's dtype, the model's per-layer kernels and its
    seconds."""
    card_model = LegacyUNet(model.image_size, qk_int8=qk_int8)
    card_model.load_state_dict(model.state_dict())
    card_model = card_model.to(device)
    counters = (A.flash_attention, A.flash_attention_qk_i8, A.quantize_qk_i8, A.flash_attention_f32)
    for fn in counters:
        fn.launches = 0
    A.flash_attention_qk_i8.launches_by_dtype = {}
    t0 = time.perf_counter()
    ctx = torch.autocast(device.type, dtype=dtype) if dtype is not None else f32_arithmetic(device)
    with ctx:
        out = ddpm_sample_legacy(card_model, linear_schedule(1000, device=device), shape,
                                 num_steps=None if steps == 1000 else steps, noise=noise).float().cpu()
    return dict(out=out, launches=[fn.launches for fn in counters], seconds=time.perf_counter() - t0,
                k2_by_dtype=dict(A.flash_attention_qk_i8.launches_by_dtype),
                kernels=card_model.attention_kernels(shape[1], shape[2]), dtype=str(dtype or torch.float32),
                qk_int8=qk_int8)


def run(model: LegacyUNet, shape, steps: int, n_floor: int, device) -> dict:
    """The check: each of RUNS on `device`, and 1 + n_floor f32 chains on
    the CPU, all with one set of draws. Returns the artifact: the settings,
    the floor, and for each run its statistics against the unperturbed f32
    chain, launches, per-layer kernels, seconds and verdict."""
    x_init, zs = draws(shape, steps)
    chains = {name: device_chain(model, shape, steps, device, dtype, qk_int8, (x_init, zs))
              for name, dtype, qk_int8 in RUNS}
    sched = linear_schedule(1000)
    num_steps = None if steps == 1000 else steps
    t0 = time.perf_counter()
    f32 = ddpm_sample_legacy(model, sched, shape, num_steps=num_steps, noise=(x_init, zs))
    floor = []
    for s in range(1, n_floor + 1):
        g = torch.Generator().manual_seed(SEED * 1000 + s)
        pert = ddpm_sample_legacy(model, sched, shape, num_steps=num_steps,
                                  noise=(x_init + PERT_SCALE * torch.randn(x_init.shape, generator=g), zs))
        floor.append(common.pearson(pert, f32))
    cpu_s = time.perf_counter() - t0
    v = torch.tensor(floor, dtype=torch.float64)
    mean, std = float(v.mean()), float(v.std(correction=1))
    threshold = mean - N_SIGMA * std
    artifact = dict(steps=steps, batch=shape[0], image_size=shape[1], n_floor_seeds=n_floor, pert_scale=PERT_SCALE,
                    device=str(device), f32_std=float(f32.std()), cpu_chains_s=cpu_s,
                    chaos_floor=dict(mean=mean, std=std, values=floor), threshold=threshold, runs={})
    for name, chain in chains.items():
        out = chain.pop("out")
        for what, x in ((name, out), ("f32", f32)):
            if x.shape != tuple(shape) or not torch.isfinite(x).all():
                raise AssertionError(f"legacy_precision: the {what} chain's output is {tuple(x.shape)} or not finite")
        pearson = common.pearson(out, f32)
        artifact["runs"][name] = dict(chain, pearson=pearson, max_abs_diff=float((out - f32).abs().max()),
                                      mean_abs_diff=float((out - f32).abs().mean()), passes=pearson >= threshold)
    return artifact


def check_launches(artifact: dict) -> None:
    """On the card, per forward of each run: K1 at each layer its `kernels`
    list as "K1" (K1-f32 instead in an f32 run), K2 and its quantizer at each
    "K2" (K2-f32, on an f32 V, in an f32 run)."""
    for name, r in artifact["runs"].items():
        kinds = [k for _, _, k in r["kernels"]]
        k1 = kinds.count("K1") * artifact["steps"]
        k2 = kinds.count("K2") * artifact["steps"]
        f32 = r["dtype"] == str(torch.float32)
        expected = [0 if f32 else k1, k2, k2, k1 if f32 else 0]
        by_dtype = {"float32" if f32 else "bfloat16": k2} if k2 else {}
        if r["launches"] != expected or r.get("k2_by_dtype", by_dtype) != by_dtype:
            raise AssertionError(f"legacy_precision {name}: launches (K1, K2, quantizer, K1-f32) {r['launches']}, "
                                 f"K2 by V's dtype {r.get('k2_by_dtype')}, expected {expected}, {by_dtype}")


def report(artifact: dict, card: str, log=common.log) -> None:
    fl = artifact["chaos_floor"]
    head = f"{artifact['steps']} steps, batch {artifact['batch']}, {artifact['image_size']} px"
    log(f"  f32 CPU chain ({head}): output std {artifact['f32_std']:.4g}; chaos floor over {len(fl['values'])} "
        f"perturbations ({PERT_SCALE} N(0,1) on x_T): pearson {fl['mean']:.7f} +- {fl['std']:.2e}, threshold "
        f"{artifact['threshold']:.7f}; values {[round(x, 7) for x in fl['values']]}; the {len(fl['values']) + 1} "
        f"f32 chains {artifact['cpu_chains_s']:.1f} s on the CPU")
    for name, r in artifact["runs"].items():
        log(f"  {name} card chain vs the f32 CPU chain: pearson {r['pearson']:.7f}, max|diff| {r['max_abs_diff']:.4g}, "
            f"mean|diff| {r['mean_abs_diff']:.4g}; launches (K1, K2, quantizer, K1-f32) {r['launches']}, "
            f"{r['seconds']:.1f} s: {'PASS' if r['passes'] else 'FAIL'} (pearson >= the floor's mean - "
            f"{N_SIGMA:g} sigma) [{card}]")


def save(artifact: dict, path: str | None = None) -> str:
    path = path or os.path.join(REPO, "chiprun_out",
                                f"legacy_precision_{artifact['steps']}_b{artifact['batch']}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--floor", type=int, default=5, help="perturbation runs of the chaos floor (at least 2)")
    p.add_argument("--out", default=None, help="default: chiprun_out/legacy_precision_<steps>_b<batch>.json")
    args = p.parse_args(argv)
    if args.floor < 2:
        p.error("--floor: the floor's std needs at least 2 runs")
    if not common.require_cuda("legacy_precision"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup() + "; the card chains run under bf16 autocast and in f32, the reference chains on "
               "the CPU")
    artifact = run(build(), (args.batch, 128, 128, 3), args.steps, args.floor, torch.device("cuda"))
    artifact["card"] = card
    check_launches(artifact)
    report(artifact, card)
    common.log(f"wrote {save(artifact, args.out)}")
    verdicts = (f"{name} {'PASS' if r['passes'] else 'FAIL'}" for name, r in artifact["runs"].items())
    common.log("verdicts: " + ", ".join(verdicts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
