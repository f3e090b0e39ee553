"""The int8-QK^T quality check on the guided chain (port of
scripts/int8_quality_check.py): does K2, the int8-QK^T flash forward with its
quantizer, translate as K1 does?

The full-width guided chain runs with the same weights, labels and draws
through `Unet(qk_int8=False)` (K1) and a `Unet(qk_int8=True)` holding the
same parameters (the quantizer and K2). A chain of this length is chaotic:
any change of the size of int8's rounding moves single pixels. So the int8
run is held against a chaos floor, N runs (5 by default) whose input gets
1e-3 * N(0, 1) added, each compared with the unperturbed run by

  - the Pearson correlation of the 256 px outputs, and
  - the agreement of the seg model's argmax predictions on them,

and the verdict is the script's (:159-161): agreement > 0.97, and both
statistics at least the floor's mean - 2 sigma (ddof 1). A second
unperturbed run gives the card's own spread (cuDNN may pick nondeterministic
algorithms); it is reported, not part of the verdict.

    python -m weatherconverter_tpu_torch.probes.int8_quality                  # sample_with_sgg, 1000 steps
    python -m weatherconverter_tpu_torch.probes.int8_quality --sampler ddim   # sample_with_sgg_ddim, 50 steps
    python -m weatherconverter_tpu_torch.probes.int8_quality --sampler dpm    # sample_with_sgg_dpm, 20 steps

Settings are the script's: GSG, lam 60, mode 'fixed', batch 8, the
production 128 px UNet, DeepLabV3+/ResNet-101 (19 classes, output stride
16) and a 2x Swift-SRGAN with random weights from seeds, random labels;
`sample_with_sgg` starts at t = K - 1. Under bf16 autocast on the card (K1
against K2), or with `--dtype float32` in f32 as the CLI's inference runs
(K1-f32 against K2-f32, TF32 off; the runs keep their names, "bf16" standing
for the exact kernel, and the file's name ends in _f32);
without a card it exits with code 2. The result goes to
chiprun_out/int8_quality_<sampler>_<steps>.json under the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from weatherconverter_tpu_torch.core.precision import f32_arithmetic
from weatherconverter_tpu_torch.diffusion.sampling import nchw
from weatherconverter_tpu_torch.guidance.translate import sample_with_sgg, sample_with_sgg_ddim, sample_with_sgg_dpm
from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.probes import common

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# sampler -> (chain, its default number of steps: the JAX bench's and CLI's)
SAMPLERS = {"ddpm": (sample_with_sgg, 1000), "ddim": (sample_with_sgg_ddim, 50), "dpm": (sample_with_sgg_dpm, 20)}
LAM = 60.0
PERT_SCALE = 1e-3
AGREE_MIN = 0.97
N_SIGMA = 2.0
FLASH_CALLS_PER_UNET = 8  # the production UNet's flash-length attention layers


def chain_kwargs(sampler: str, steps: int, lam: float = LAM) -> dict:
    kw = dict(lam=lam, num_steps=steps, num_classes=19, mode="fixed", guidance_style="gsg")
    if sampler == "ddpm":
        kw["start_t"] = steps - 1
    return kw


def run_chains(models, sched, inp: torch.Tensor, gt: torch.Tensor, sampler: str, steps: int, n_floor: int,
               dtype=None, seed: int = 42, lam: float = LAM) -> dict:
    """{run name: (output (B, HR, HR, 3) f32 on the CPU, seg prediction (B, HR, HR), launches (K1, K2,
    quantizer))} for the runs 'bf16', 'bf16-repeat' and 'int8' on `inp`, and 'bf16-pert1'..'bf16-pert<n_floor>'
    on `inp` plus PERT_SCALE * N(0, 1) from seed (seed, s). Every chain draws from a generator seeded with
    `seed`, so all take the same draws. `models` = (unet, unet_qk_int8, seg, sr); `dtype` runs them under
    autocast, None in f32 (`f32_arithmetic`); `lam` is the guidance weight. Launches: the exact kernel's (K1,
    K1-f32 in f32), and K2's and its quantizer's on inputs of the chain's dtype."""
    unet, unet_i8, seg, sr = models
    chain = SAMPLERS[sampler][0]
    device = inp.device
    runs = [("bf16", unet, 0), ("bf16-repeat", unet, 0), ("int8", unet_i8, 0)]
    runs += [(f"bf16-pert{s}", unet, s) for s in range(1, n_floor + 1)]
    outs = {}
    for name, model, pert in runs:
        x = inp
        if pert:
            g = torch.Generator(device=device).manual_seed(seed * 1000 + pert)
            x = inp + PERT_SCALE * torch.randn(inp.shape, generator=g, device=device)
        exact = A.flash_attention if dtype is not None else A.flash_attention_f32
        exact.launches = 0
        A.flash_attention_qk_i8.launches_by_dtype, A.quantize_qk_i8.launches_by_dtype = {}, {}
        with torch.autocast(device.type, dtype=dtype) if dtype is not None else f32_arithmetic(device):
            out = chain(model, sched, seg, sr, x, gt, torch.Generator(device=device).manual_seed(seed),
                        **chain_kwargs(sampler, steps, lam))
            with torch.no_grad():
                pred = seg(nchw(out)).argmax(1)
        name_of = str(dtype or torch.float32).removeprefix("torch.")
        launches = (exact.launches, A.flash_attention_qk_i8.launches_by_dtype.get(name_of, 0),
                    A.quantize_qk_i8.launches_by_dtype.get(name_of, 0))
        out = out.float().cpu()
        if out.shape != (inp.shape[0], *gt.shape[1:], 3) or not torch.isfinite(out).all():
            raise AssertionError(f"int8_quality {sampler} {name}: output {tuple(out.shape)} or not finite")
        outs[name] = (out, pred.cpu(), launches)
    return outs


def check_launches(outs: dict, steps: int) -> None:
    """On the card: the exact kernel (K1, or K1-f32) 8 times a UNet forward in every exact run, the quantizer
    and K2 (K2-f32) 8 times a forward (and the exact kernel never) in the int8 run."""
    calls = FLASH_CALLS_PER_UNET * steps
    for name, (_, _, launches) in outs.items():
        expected = (0, calls, calls) if name == "int8" else (calls, 0, 0)
        if launches != expected:
            raise AssertionError(f"int8_quality {name}: launches (K1, K2, quantizer) {launches}, expected {expected}")


def statistics(outs: dict, n_floor: int) -> dict:
    """Each run against 'bf16': Pearson correlation, seg agreement and the output's max and mean |difference|;
    the chaos floor's mean and std (ddof 1) of the first two and of the mean |difference| over the perturbed runs;
    the verdict (on the first two)."""
    a, pa, _ = outs["bf16"]

    def against(name):
        b, pb, _ = outs[name]
        return dict(pearson=common.pearson(a, b), seg_agree=float((pa == pb).double().mean()),
                    max_abs_diff=float((a - b).abs().max()), mean_abs_diff=float((a - b).abs().mean()))

    i8, repeat = against("int8"), against("bf16-repeat")
    floor = [against(f"bf16-pert{s}") for s in range(1, n_floor + 1)]
    spread = {}
    for key in ("pearson", "seg_agree", "mean_abs_diff"):
        v = torch.tensor([f[key] for f in floor], dtype=torch.float64)
        spread[key] = dict(mean=float(v.mean()), std=float(v.std(correction=1)), values=v.tolist())
    within = all(i8[key] >= spread[key]["mean"] - N_SIGMA * spread[key]["std"] for key in ("pearson", "seg_agree"))
    return {"int8": i8, "bf16_repeat": repeat, "chaos_floor": spread,
            "criteria": {"seg_agree_abs_min": AGREE_MIN, "within_2sigma_of_floor": within},
            "pass": bool(i8["seg_agree"] > AGREE_MIN and within)}


def report(artifact: dict, log=common.log) -> None:
    i8, rep, fl = artifact["int8"], artifact["bf16_repeat"], artifact["chaos_floor"]
    f32 = artifact.get("dtype") == "float32"
    head = f"{artifact['sampler']} {artifact['steps']} steps, batch {artifact['batch']}" + (", f32" if f32 else "")
    log(f"  int8 vs {'f32 (K2-f32 against K1-f32)' if f32 else 'bf16'} ({head}): pearson {i8['pearson']:.6f}, seg-agree {i8['seg_agree']:.5f}, max|diff| "
        f"{i8['max_abs_diff']:.5f}, mean|diff| {i8['mean_abs_diff']:.6f}")
    log(f"  chaos floor over {len(fl['pearson']['values'])} perturbations ({PERT_SCALE} N(0,1) on the input): pearson "
        f"{fl['pearson']['mean']:.6f} +- {fl['pearson']['std']:.6f}, seg-agree {fl['seg_agree']['mean']:.5f} +- "
        f"{fl['seg_agree']['std']:.5f}, mean|diff| {fl['mean_abs_diff']['mean']:.6f}; values {[round(v, 6) for v in fl['pearson']['values']]} / "
        f"{[round(v, 5) for v in fl['seg_agree']['values']]}")
    log(f"  two identical {'f32' if f32 else 'bf16'} runs: pearson {rep['pearson']:.6f}, seg-agree {rep['seg_agree']:.5f}, max|diff| "
        f"{rep['max_abs_diff']:.3e}, mean|diff| {rep['mean_abs_diff']:.6f}")
    log(f"  verdict ({head}): {'PASS' if artifact['pass'] else 'FAIL'} (seg-agree > {AGREE_MIN}: "
        f"{i8['seg_agree'] > AGREE_MIN}; both within {N_SIGMA:g} sigma of the floor: "
        f"{artifact['criteria']['within_2sigma_of_floor']}) [{artifact['card']}]")


def run(models, sched, inp, gt, sampler: str, steps: int, n_floor: int, dtype=None, card: str = "cpu",
        lam: float = LAM) -> tuple[dict, dict]:
    """The check on given models and inputs: (the artifact (the run's settings and `statistics`), the
    chains' outputs)."""
    outs = run_chains(models, sched, inp, gt, sampler, steps, n_floor, dtype, lam=lam)
    artifact = dict(sampler=sampler, steps=steps, batch=inp.shape[0], n_floor_seeds=n_floor, lam=lam, card=card,
                    dtype=str(dtype or torch.float32).removeprefix("torch."),
                    launches={name: list(o[2]) for name, o in outs.items()}, **statistics(outs, n_floor))
    return artifact, outs


def full_width(batch: int, device, seed: int = 0):
    """The production models with random weights from `seed` (the K2 UNet holds the K1 UNet's parameters), the
    1000-step linear schedule, an input (B, 128, 128, 3) of N(0, 0.2^2) and labels (B, 256, 256) in 0..18."""
    from weatherconverter_tpu_torch.core.config import UnetModelConfig
    from weatherconverter_tpu_torch.diffusion.schedule import linear_schedule
    from weatherconverter_tpu_torch.models.factory import make_seg_model
    from weatherconverter_tpu_torch.models.srgan import Generator
    from weatherconverter_tpu_torch.models.unet import Unet

    torch.manual_seed(seed)
    unet = Unet(UnetModelConfig()).to(device)
    seg = make_seg_model("deeplabv3plus_resnet101", num_classes=19, output_stride=16).to(device)
    sr = Generator(upscale_factor=2).to(device)
    unet_i8 = Unet(UnetModelConfig(), qk_int8=True).to(device)
    unet_i8.load_state_dict(unet.state_dict())
    for m in (unet, unet_i8, seg, sr):
        m.eval()
    seg.requires_grad_(False)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    inp = torch.randn((batch, 128, 128, 3), generator=g, device=device) * 0.2
    gt = torch.randint(0, 19, (batch, 256, 256), generator=g, device=device)
    return (unet, unet_i8, seg, sr), linear_schedule(1000, device=device), inp, gt


def save(artifact: dict, path: str | None = None) -> str:
    default = path is None
    path = path or os.path.join(REPO, "chiprun_out", f"int8_quality_{artifact['sampler']}_{artifact['steps']}.json")
    if default and artifact.get("dtype") == "float32":  # beside the bf16 check of the same sampler and steps
        path = path.removesuffix(".json") + "_f32.json"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sampler", choices=sorted(SAMPLERS), default="ddpm")
    p.add_argument("--steps", type=int, default=None, help="default: 1000 (ddpm), 50 (ddim), 20 (dpm)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--floor", type=int, default=5, help="perturbation runs of the chaos floor (at least 2)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="bfloat16: the chains under autocast (K1, K2); float32: in f32 as the CLI (K1-f32, K2-f32)")
    p.add_argument("--out", default=None, help="default: chiprun_out/int8_quality_<sampler>_<steps>.json")
    args = p.parse_args(argv)
    if args.floor < 2:
        p.error("--floor: the floor's std needs at least 2 runs")
    if not common.require_cuda("int8_quality"):
        return 2
    card = common.card_line()
    common.log(card)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    common.log(common.setup() + f"; the chains run {'under bf16 autocast' if dtype else 'in f32, TF32 off'}")
    steps = args.steps or SAMPLERS[args.sampler][1]
    models, sched, inp, gt = full_width(args.batch, torch.device("cuda"))
    artifact, outs = run(models, sched, inp, gt, args.sampler, steps, args.floor, dtype, card)
    check_launches(outs, steps)
    report(artifact)
    common.log(f"wrote {save(artifact, args.out)}")
    common.log("INT8 QUALITY OK" if artifact["pass"] else "INT8 QUALITY FAIL")
    return 0


if __name__ == "__main__":
    sys.exit(main())
