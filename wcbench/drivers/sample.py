"""Unconditional sampling: the port's `diffusion/sampling.dpm_solver_pp_2m_sample`
(DPM-Solver++(2M), `steps` steps) on the UNet with K2-f32 at its
flash-length layers, in f32 under the port's `f32_arithmetic`: the CLI's
`sample --sampler dpm` on the card. A unit of work is one whole call:
`batch` samples; a per-layer step is one sampler step (one UNet forward).

The check draws a sample of the window's calls from the seed (the last
always in it), restores the generator to the state each call began with,
draws the same initial noise and runs the reference's sampler over the same
steps; the gap is the largest difference of the final samples over the
reference's largest value. The path is checked by the port's launch
counters (K2-f32 and its quantizer in every flash-length layer, no K1-f32).
"""

from __future__ import annotations

import torch

from wcbench import feed, reference, weights, yardstick
from wcbench.compare import rel_max
from wcbench.reference import diffusion as rdiff
from wcbench.reference import unet as runet


def _spec(cfg):
    with torch.device("meta"):
        return runet.Unet(cfg["unet"], qk_int8=cfg["qk_int8"])


class Cell:
    kind = "sample"

    def __init__(self, ctx):
        from weatherconverter_tpu_torch.core.config import UnetModelConfig
        from weatherconverter_tpu_torch.core.precision import f32_arithmetic
        from weatherconverter_tpu_torch.diffusion.sampling import dpm_solver_pp_2m_sample
        from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
        from weatherconverter_tpu_torch.models.unet import Unet
        from weatherconverter_tpu_torch.ops import attention

        self.ctx, cfg, tr, dev, seed = ctx, ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.cfg, self.tr, self.dev, self.attention = cfg, tr, dev, attention
        self.batch, self.num_steps = tr["batch"], tr["steps"]
        self.steps_per_call = self.num_steps
        size = cfg["unet"]["im_size"]
        self.shape = (self.batch, size, size, cfg["unet"]["im_channels"])
        self.f32 = f32_arithmetic(dev)
        self.f32.__enter__()
        w = weights.make_weights(_spec(cfg), seed, dev, tag="unet")
        self.unet = weights.build(lambda: Unet(UnetModelConfig(**cfg["unet"]), qk_int8=cfg["qk_int8"]), w, dev).eval()
        del w
        d = cfg["diffusion"]
        self.sched = make_schedule("linear", d["num_timesteps"], d["beta_start"], d["beta_end"], device=dev)
        self.sample = dpm_solver_pp_2m_sample
        # warm-up: a 3-step call has the window's shapes and both of the solver's updates (first and second
        # order), from a generator of its own
        self.sample(self.unet, self.sched, self.shape, feed.generator(dev, weights.derive(seed, "warm-up")),
                    num_steps=3)
        self.gen = feed.generator(dev, weights.derive(seed, "sampler"))
        self.records = []
        self.counts0 = self._counts()

    def _counts(self) -> dict:
        a = self.attention
        return {"K2-f32": a.flash_attention_qk_i8.launches_by_dtype.get("float32", 0),
                "quantizer": a.quantize_qk_i8.launches, "K1-f32": a.flash_attention_f32.launches}

    def step(self, spans: bool = False) -> dict:
        state = self.gen.get_state()
        out = self.sample(self.unet, self.sched, self.shape, self.gen, num_steps=self.num_steps)
        self.records.append((state, out))
        return {"samples": self.batch}

    def spans(self) -> dict:
        return {}

    def flops_per_step(self) -> float:
        """One UNet forward at the cell's batch, counted on the reference on the meta device."""
        b, size = self.batch, self.cfg["unet"]["im_size"]
        with torch.device("meta"), torch.no_grad():
            unet = runet.Unet(self.cfg["unet"], qk_int8=self.cfg["qk_int8"])
            x, t = torch.zeros((b, 3, size, size)), torch.zeros((b,), dtype=torch.long)
            return yardstick.count_flops(lambda: unet(x, t))

    def flash_bound_per_step(self, peak: dict) -> float:
        return sum(yardstick.quantizer_bound_s(*s, peak) + yardstick.k2_f32_bound_s(*s, peak)
                   for s in runet.flash_layers(self.cfg["unet"], self.batch))

    def free_program(self) -> None:
        self.counts1 = self._counts()
        self.unet = None
        self.f32.__exit__(None, None, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        cfg, tr, dev = self.cfg, self.tr, self.dev
        limits, d = tr["check"]["limits"], cfg["diffusion"]
        w = weights.make_weights(_spec(cfg), self.ctx.seed, dev, tag="unet")
        unet = weights.build(lambda: runet.Unet(cfg["unet"], qk_int8=cfg["qk_int8"]), w, dev).eval()
        del w
        s = rdiff.Schedule(d["num_timesteps"], d["beta_start"], d["beta_end"], dev)
        b, h, w_, c = self.shape

        def reference_sample(state, tf32: bool):
            gen = torch.Generator(device=dev)
            gen.set_state(state)
            x = torch.randn((b, c, h, w_), generator=gen, device=dev)
            with reference.arithmetic(tf32=tf32):
                return rdiff.dpm_sample(unet, s, x, self.num_steps)

        gaps = []
        for state, out in self._sample():
            ref = reference_sample(state, False)
            prog = reference_sample(state, True) if control else out.permute(0, 3, 1, 2)
            gaps.append(rel_max(prog, ref))
        checks = [("sample", max(gaps), limits["sample"])]
        if dev.type == "cuda" and not control:
            calls = len(runet.flash_layers(cfg["unet"], 1)) * self.num_steps * len(self.records)
            want = {"K2-f32": calls, "quantizer": calls, "K1-f32": 0}
            off = sum(abs(self.counts1[k] - self.counts0[k] - v) for k, v in want.items())
            checks.append(("path", float(off), limits["path"]))
        return checks

    def _sample(self) -> list:
        n = min(len(self.records), int(self.tr["check"]["sample"]))
        gen = torch.Generator().manual_seed(weights.derive(self.ctx.seed, "check"))
        pick = torch.randperm(len(self.records) - 1, generator=gen)[: n - 1].tolist() if n > 1 else []
        return [self.records[i] for i in sorted(pick)] + [self.records[-1]]
