"""Guided translation: the port's `guidance/translate.make_translate_fn`
chain (DDPM, the 'alternate' schedule in 'sr' space, f32 under the port's
`f32_arithmetic`, the UNet on K2-f32), called in segments of
`segment_steps` steps (xt_init, t_offset, num_steps, final_sr=False), which
together are the whole chain bit for bit. A chain starts at the
configuration's `start_t` from `translate_entry`; one that reaches t = 0 ends
with its final_sr call and a fresh batch starts. A unit of work is one
chain step of the batch: batch / num_steps translations.

The check follows the program step by step from its own state: for a
sample of the window's segments (drawn from the seed, with the last one
always in it) the reference runs the same steps from the latent the segment
was handed, with the generator restored to the state it had, and the gap
of the two outputs is taken over the size of the guidance term, the part of
the update that the seg model, LCG and GSG make. The chain's entry (the
q-sample to start_t) is checked by itself, and the path by the port's
launch counters (K2-f32 and its quantizer in every flash-length layer, no
K1-f32).
"""

from __future__ import annotations

import torch

from wcbench import feed, reference, weights, yardstick
from wcbench.compare import rel_max
from wcbench.reference import diffusion as rdiff
from wcbench.reference import guidance as rguide
from wcbench.reference import seg as rseg
from wcbench.reference import unet as runet


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def reference_models(cfg: dict, tr: dict):
    """Factories of the reference's UNet, seg model and SRGAN."""
    return (lambda: runet.Unet(cfg["unet"], qk_int8=cfg["qk_int8"]),
            lambda: rseg.DeepLabV3Plus(cfg["seg"]["num_classes"], cfg["seg"]["output_stride"]),
            lambda: rseg.SRGenerator(**cfg["srgan"]))


def model_weights(cfg: dict, tr: dict, seed: int, device) -> list[dict]:
    """The UNet's, the seg model's and the SRGAN's weights from the seed.
    Random weights at PyTorch's default scales make a seg model whose input
    gradient is ~1e-7 a pixel, below f32's rounding of x_t: the guidance
    would be invisible, to the chain and to the check. So the weights are
    made as `cfg["weights"]` says: every BatchNorm's running statistics set
    from one train-mode forward of the reference on seeded inputs (the
    SRGAN's on 128 px images, the seg model's on their upscales), as a
    trained model's are of its activations, and the seg classifier's last
    convolution scaled so that lam * sigma * |grad| is of the size lambda =
    60 was tuned for."""
    out = []
    for tag, factory in zip(("unet", "seg", "srgan"), reference_models(cfg, tr)):
        with torch.device("meta"):
            spec = factory()
        out.append(weights.make_weights(spec, seed, device, tag=tag))
    w = cfg.get("weights", {})
    if w.get("calibrate_bn"):
        f_unet, f_seg, f_sr = reference_models(cfg, tr)
        seg, sr = weights.build(f_seg, out[1], device), weights.build(f_sr, out[2], device)
        x = feed.images({"batch": tr["batch"], "image_size": cfg["unet"]["im_size"]},
                        feed.generator(device, weights.derive(seed, "calibration")), device)
        with reference.arithmetic(tf32=False):
            rseg.calibrate_bn(seg, rseg.calibrate_bn(sr, x.permute(0, 3, 1, 2)))
        out[1], out[2] = seg.state_dict(), sr.state_dict()
    scale = w.get("seg_classifier_scale", 1.0)
    if scale != 1.0:
        for key in ("classifier.classifier.3.weight", "classifier.classifier.3.bias"):
            out[1][key] = out[1][key] * scale
    return out


class Cell:
    kind = "translate"

    def __init__(self, ctx):
        from weatherconverter_tpu_torch.core.config import UnetModelConfig
        from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
        from weatherconverter_tpu_torch.guidance.translate import make_translate_fn, translate_entry
        from weatherconverter_tpu_torch.models.factory import make_seg_model
        from weatherconverter_tpu_torch.models.srgan import Generator
        from weatherconverter_tpu_torch.models.unet import Unet
        from weatherconverter_tpu_torch.ops import attention

        self.ctx, cfg, tr, dev, seed = ctx, ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.attention, self.translate_entry = attention, translate_entry
        self.batch, self.seg_steps = tr["batch"], tr["segment_steps"]
        self.num_steps, self.start_t = cfg["guidance"]["num_steps"], tr["start_t"]
        self.steps_per_call = self.seg_steps
        w_unet, w_seg, w_sr = model_weights(cfg, tr, seed, dev)
        sc = cfg["seg"]
        unet = weights.build(lambda: Unet(UnetModelConfig(**cfg["unet"]), qk_int8=cfg["qk_int8"]), w_unet, dev)
        seg = weights.build(lambda: make_seg_model(sc["name"], sc["num_classes"], sc["output_stride"]), w_seg, dev)
        sr = weights.build(lambda: Generator(**cfg["srgan"]), w_sr, dev)
        del w_unet, w_seg, w_sr
        d = cfg["diffusion"]
        self.sched = make_schedule("linear", d["num_timesteps"], d["beta_start"], d["beta_end"], device=dev)
        self.translate = make_translate_fn(
            unet, self.sched, seg, sr, lam=cfg["guidance"]["lambda"], num_steps=self.num_steps,
            mode=cfg["guidance"]["mode"], num_classes=sc["num_classes"], lcg_class_chunk=tr["lcg_class_chunk"],
            lcg_present_k=tr["lcg_present_k"], guidance_style=tr["guidance_style"], guidance_space="sr")
        self.feed_gen = feed.generator(dev, weights.derive(seed, "feed"))
        self.gen = feed.generator(dev, weights.derive(seed, "chain"))
        self.chains, self.entries, self.records = [], [], []
        self.xt, self.top, self.unet_calls = None, None, 0
        self._events = []
        self.diag = {}
        # warm-up: one segment (a GSG and an LCG step: every shape the window runs), on a chain of its own
        warm = feed.generator(dev, weights.derive(seed, "warm-up"))
        x, g = self._inputs()
        xt = translate_entry(self.sched, x, self.num_steps, warm, start_t=self.start_t)
        self.translate(x, g, warm, xt_init=xt, t_offset=self.start_t - 1, num_steps=2, final_sr=False)
        self.chains = []
        self.counts0 = self._counts()

    def _inputs(self):
        x = feed.images(self.tr, self.feed_gen, self.dev)
        g = feed.labels({**self.tr, "num_classes": self.cfg["seg"]["num_classes"]}, self.feed_gen, self.dev)
        self.chains.append((x, g))
        return x, g

    def _counts(self) -> dict:
        a = self.attention
        return {"K2-f32": a.flash_attention_qk_i8.launches_by_dtype.get("float32", 0),
                "quantizer": a.quantize_qk_i8.launches, "K1-f32": a.flash_attention_f32.launches}

    def _segment(self, lo: int, n: int, spans: bool):
        x, g = self.chains[-1]
        state = self.gen.get_state()
        ev = None
        if spans and self.dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = self.translate(x, g, self.gen, xt_init=self.xt, t_offset=lo, num_steps=n, final_sr=lo == 0)
        self.unet_calls += n
        if ev is not None:
            ev[1].record()
            self._events.append(("lcg" if lo % 2 == 0 and lo != 0 else "gsg", ev))
        if lo == 0:  # the chain's end: its final_sr output; a fresh batch starts
            self.xt = None
        else:
            self.records.append(dict(chain=len(self.chains) - 1, lo=lo, n=n, state=state, xt_in=self.xt, xt_out=out))
            self.xt = out

    def step(self, spans: bool = False) -> dict:
        if self.xt is None:
            x, _ = self._inputs()
            self.entries.append((len(self.chains) - 1, self.gen.get_state()))
            self.xt = self.translate_entry(self.sched, x, self.num_steps, self.gen, start_t=self.start_t)
            self.entries[-1] += (self.xt,)
            self.top = self.start_t
        n = min(self.seg_steps, self.top + 1)
        if spans:
            for i in range(self.top, self.top - n, -1):
                self._segment(i, 1, True)
        else:
            self._segment(self.top + 1 - n, n, False)
        self.top -= n
        return {"translations": self.batch * n / self.num_steps}

    def spans(self) -> dict:
        out = {}
        for kind, (a, b) in self._events:
            out.setdefault(kind, []).append(a.elapsed_time(b))
        return out

    def flops_per_step(self) -> float:
        """The mean FLOPs of a chain step of 'alternate' (one GSG and one LCG
        step), counted on the reference on the meta device at the cell's shapes."""
        cfg, tr, b = self.cfg, self.tr, self.batch
        f_unet, f_seg, f_sr = reference_models(cfg, tr)
        with torch.device("meta"):
            unet, seg, sr = f_unet(), f_seg().eval(), f_sr()
            xt = torch.zeros((b, 3, cfg["unet"]["im_size"], cfg["unet"]["im_size"]))
            t = torch.zeros((b,), dtype=torch.long)
            hr = tr["label_size"]
            chunk = min(tr["lcg_class_chunk"], tr["lcg_present_k"])
            calls = -(-tr["lcg_present_k"] // chunk)
            with torch.no_grad():
                common = yardstick.count_flops(lambda: (unet(xt, t), sr(xt)))
            seg.requires_grad_(False)

            def field(n):  # a seg forward and its input gradient at n images
                x = torch.zeros((n, 3, hr, hr), requires_grad=True)
                rguide.seg_ce(seg, x, torch.zeros((n, hr, hr), dtype=torch.long)).backward()

            gsg = yardstick.count_flops(lambda: field(b))
            lcg = calls * yardstick.count_flops(lambda: field(chunk * b))
        return common + (gsg + lcg) / 2

    def flash_bound_per_step(self, peak: dict) -> float:
        return sum(yardstick.quantizer_bound_s(*s, peak) + yardstick.k2_f32_bound_s(*s, peak)
                   for s in runet.flash_layers(self.cfg["unet"], self.batch))

    def free_program(self) -> None:
        self.counts1 = self._counts()
        self.translate = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        cfg, tr, dev = self.cfg, self.tr, self.dev
        limits = tr["check"]["limits"]
        w = model_weights(cfg, tr, self.ctx.seed, dev)
        unet, seg, sr = (weights.build(f, wi, dev).eval() for f, wi in zip(reference_models(cfg, tr), w))
        del w
        d = cfg["diffusion"]
        s = rdiff.Schedule(d["num_timesteps"], d["beta_start"], d["beta_end"], dev)
        out = []
        with reference.arithmetic(tf32=False):
            gaps = []
            for chain, state, xt0 in self.entries:
                gen = torch.Generator(device=dev)
                gen.set_state(state)
                x = _nchw(self.chains[chain][0])
                ref0 = rdiff.q_sample(s, x, torch.randn(x.shape, generator=gen, device=dev), self.start_t)
                gaps.append(rel_max(_nchw(xt0), ref0))
            out.append(("entry", max(gaps), limits["entry"]))
            gaps = []
            for rec in self._sample():
                ref, gmax = self._reference_steps(unet, seg, sr, s, rec, tf32=False)
                prog = _nchw(rec["xt_out"])
                if control:
                    prog, _ = self._reference_steps(unet, seg, sr, s, rec, tf32=True)
                gaps.append(rel_max(prog, ref, gmax))
                self.diag.setdefault("guidance_max", []).append(float(gmax))
            out.append(("step", max(gaps), limits["step"]))
        if dev.type == "cuda" and not control:
            calls = len(runet.flash_layers(cfg["unet"], 1)) * self.unet_calls
            want = {"K2-f32": calls, "quantizer": calls, "K1-f32": 0}
            off = sum(abs(self.counts1[k] - self.counts0[k] - v) for k, v in want.items())
            out.append(("path", float(off), limits["path"]))
        return out

    def _sample(self) -> list[dict]:
        recs = [r for r in self.records if r["lo"] > 0]
        n = min(len(recs), int(self.tr["check"]["sample"]))
        gen = torch.Generator().manual_seed(weights.derive(self.ctx.seed, "check"))
        pick = torch.randperm(len(recs) - 1, generator=gen)[: n - 1].tolist() if n > 1 else []
        return [recs[i] for i in sorted(pick)] + [recs[-1]]

    def _reference_steps(self, unet, seg, sr, s, rec, tf32: bool):
        cfg, tr = self.cfg, self.tr
        _, g = self.chains[rec["chain"]]
        gen = torch.Generator(device=self.dev)
        gen.set_state(rec["state"])
        ids = rguide.present_class_ids(g, tr["lcg_present_k"], cfg["seg"]["num_classes"])
        with reference.arithmetic(tf32=tf32):
            return rguide.guided_steps(unet, seg, sr, s, _nchw(rec["xt_in"]), g, gen, rec["lo"],
                                       rec["n"], cfg["guidance"]["lambda"], ids, tr["lcg_class_chunk"],
                                       cfg["seg"]["num_classes"])
