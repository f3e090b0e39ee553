"""DDPM training: the port's `training/loop_diffusion.make_augmented_train_step`
on `training/diffusion.create_ddpm_state` (Adam, EMA), in f32 under the
port's `f32_arithmetic` (as `train` runs `training.dtype` float32: K1-f32
forward and K3-f32 backward at the flash-length layers), on raw uint8
batches drawn on the device from the seed each step. A unit of work is one
train step: `batch` images.

Set-up builds the one train state and drives it through the first
`check.steps` steps by the window's own call and feed, keeping what the
check needs: the weights before, Adam's first moment after the first step
(the first gradient as the optimizer got it: m / (1 - beta1)), the
parameters and the EMA after the last. The window then goes on with the
same state. The check runs the reference from the same weights over the
same batches and draws, and compares each step's loss and, by the worst
leaf, the norms of the first gradient and of the parameters' change, and by
the median leaf the norm of the EMA's change (a thousandth of the
parameters' change, so one small leaf's reading is f32 rounding of the
shadow; leaves whose reference gradient is under a thousandth of the
median leaf's, such as a key's bias under softmax, are left out: they move
by round-off). The path is checked by the port's launch counters.
"""

from __future__ import annotations

import torch

from wcbench import feed, reference, weights, yardstick
from wcbench.compare import kept_leaves, median_leaf_gap, worst_leaf_gap
from wcbench.reference import diffusion as rdiff
from wcbench.reference import train as rtrain
from wcbench.reference import unet as runet


def _spec(cfg):
    with torch.device("meta"):
        return runet.Unet(cfg["unet"], qk_int8=False)


class Cell:
    kind = "train"
    steps_per_call = 1

    def __init__(self, ctx):
        from weatherconverter_tpu_torch.core.config import UnetModelConfig
        from weatherconverter_tpu_torch.core.precision import f32_arithmetic
        from weatherconverter_tpu_torch.diffusion.schedule import make_schedule
        from weatherconverter_tpu_torch.models.unet import Unet
        from weatherconverter_tpu_torch.ops import attention
        from weatherconverter_tpu_torch.training.diffusion import create_ddpm_state
        from weatherconverter_tpu_torch.training.loop_diffusion import make_augmented_train_step

        self.ctx, cfg, tr, dev, seed = ctx, ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.cfg, self.tr, self.dev, self.attention = cfg, tr, dev, attention
        self.batch = tr["batch"]
        self.f32 = f32_arithmetic(dev)
        self.f32.__enter__()
        w = weights.make_weights(_spec(cfg), seed, dev, tag="unet")
        unet = weights.build(lambda: Unet(UnetModelConfig(**cfg["unet"])), w, dev)
        del w
        t = cfg["training"]
        self.state = create_ddpm_state(unet, lr=t["lr"], ema_decay=t["ema_decay"])
        d = cfg["diffusion"]
        sched = make_schedule("linear", d["num_timesteps"], d["beta_start"], d["beta_end"], device=dev)
        self.step_fn = make_augmented_train_step(sched, tr["crop"], dtype=None)
        self.feed_gen = feed.generator(dev, weights.derive(seed, "feed"))
        self.gen = feed.generator(dev, weights.derive(seed, "draws"))
        params = dict(unet.named_parameters())
        self.p0 = {n: p.detach().clone() for n, p in params.items()}
        self.draws0 = self.gen.get_state()
        self.batches, self.losses = [], []
        self._events = []
        for k in range(int(tr["check"]["steps"])):
            raw = feed.raw_images(tr, self.feed_gen, dev)
            _, loss = self.step_fn(self.state, raw, self.gen)
            self.batches.append(raw)
            self.losses.append(loss.detach().clone())
            if k == 0:
                opt = self.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                self.g1 = {n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach() / (1.0 - beta1)
                           for n, p in params.items()}
        self.p3 = {n: p.detach().clone() for n, p in params.items()}
        self.e3 = {n: self.state.ema.params[n].detach().clone() for n in params}
        self.counts0 = self._counts()
        self.steps = 0

    def _counts(self) -> dict:
        a = self.attention
        return {"K1-f32": a.flash_attention_f32.launches, "K3-f32": a.flash_attention_bwd_f32.launches,
                "K2": a.flash_attention_qk_i8.launches}

    def step(self, spans: bool = False) -> dict:
        raw = feed.raw_images(self.tr, self.feed_gen, self.dev)
        self.step_fn(self.state, raw, self.gen)
        self.steps += 1
        return {"images": self.batch}

    def spans(self) -> dict:
        return {}

    def flops_per_step(self) -> float:
        """A train step's forward and backward, counted on the reference on
        the meta device at the cell's shapes (Adam and the EMA are elementwise)."""
        cfg, b = self.cfg, self.batch
        size = cfg["unet"]["im_size"]
        with torch.device("meta"):
            unet = runet.Unet(cfg["unet"], qk_int8=False)
            x = torch.zeros((b, 3, size, size))
            t = torch.zeros((b,), dtype=torch.long)

            def fwd_bwd():
                loss = torch.mean(torch.square(unet(x, t) - x))
                loss.backward()

            return yardstick.count_flops(fwd_bwd)

    def flash_bound_per_step(self, peak: dict) -> float:
        return sum(yardstick.k1_f32_bound_s(*s, peak) + yardstick.k3_f32_bound_s(*s, peak)
                   for s in runet.flash_layers(self.cfg["unet"], self.batch))

    def free_program(self) -> None:
        self.counts1 = self._counts()
        self.state = self.step_fn = None
        self.f32.__exit__(None, None, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> list[tuple[str, float, float]]:
        cfg, tr, dev = self.cfg, self.tr, self.dev
        limits, t, d = tr["check"]["limits"], cfg["training"], cfg["diffusion"]
        s = rdiff.Schedule(d["num_timesteps"], d["beta_start"], d["beta_end"], dev)

        def run(tf32: bool):
            w = weights.make_weights(_spec(cfg), self.ctx.seed, dev, tag="unet")
            unet = weights.build(lambda: runet.Unet(cfg["unet"], qk_int8=False), w, dev)
            gen = torch.Generator(device=dev)
            gen.set_state(self.draws0)
            with reference.arithmetic(tf32=tf32):
                losses, g1, ema = rtrain.train_steps(unet, s, self.batches, gen, tr["crop"], t["lr"], t["ema_decay"])
            return losses, g1, {n: p.detach() for n, p in unet.named_parameters()}, ema

        r_loss, r_g1, r_p3, r_e3 = run(False)
        if control:
            loss, g1, p3, e3 = run(True)
        else:
            loss, g1, p3, e3 = self.losses, self.g1, self.p3, self.e3
        keep = kept_leaves(r_g1)

        def moved(tree):
            return {n: tree[n] - self.p0[n] for n in keep}

        out = [("loss", max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(loss, r_loss)), limits["loss"]),
               ("grad", worst_leaf_gap(g1, r_g1, keep), limits["grad"]),
               ("update", worst_leaf_gap(moved(p3), moved(r_p3), keep), limits["update"]),
               ("ema", median_leaf_gap(moved(e3), moved(r_e3), keep), limits["ema"])]
        if dev.type == "cuda" and not control:
            calls = len(runet.flash_layers(cfg["unet"], 1)) * self.steps
            want = {"K1-f32": calls, "K3-f32": calls, "K2": 0}
            off = sum(abs(self.counts1[k] - self.counts0[k] - v) for k, v in want.items())
            out.append(("path", float(off), limits["path"]))
        return out
