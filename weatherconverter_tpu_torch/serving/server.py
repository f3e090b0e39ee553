"""HTTP inference server for translation and sampling (port of
weatherconverter_tpu/serving/server.py), on the CUDA card unless the caller
passes `device="cpu"`.

Endpoints (JSON over the standard library's http.server):
  GET  /healthz            -> {"status": "ok"}
  GET  /stats              -> request and batch counts, mean occupancy (and
                              the requests of each LCG bucket under 'auto')
  POST /v1/sample          {"steps": int?, "seed": int?} -> {"image": b64 PNG}
  POST /v1/translate       {"image": b64 PNG (any size), "label": b64 PNG
                            (labelIds), "seed": int?} -> {"image": b64 PNG}
A request without a required field gets a 400, a failure a 500; neither
stops the server.

    python -m weatherconverter_tpu_torch.cli.main serve --config configs/translation.yaml --sampler dpm

Models load once. Concurrent requests are grouped into micro-batches
(serving/batcher.py) that run as ONE batched chain. Each request keeps its
own seed: row i of a batch draws from its own torch.Generator
(`diffusion/sampling.Generators`), the draws a batch-1 run under that seed
makes, and every other step of the chain is per image (GroupNorm, the frozen
seg model's BatchNorm, the per-image CE whose input gradient guides), so a
request's image does not depend on what shares its batch: bit for bit at
one batch width, on the CPU and (phase 14 of chip_smoke.py) on the card.
That is why the server runs K1, the exact flash attention, and not K2 as
the CLI's one-request commands do on the card: K2 quantizes Q and K with
one scale per tensor, here the whole micro-batch's, where the JAX service's
vmap takes one scale per request, so under K2 a request's image moved with
its batch-mates (by one uint8 level on the H100, where two solo runs were
bit-equal; PERF.md section 6), and K2 buys no wall time while the host
binds (PERF.md section 5). Per-request int8 scales in the quantizer would
lift this (ROADMAP Queue 1 item 10).

What the JAX service's "compile once per variant" becomes: there is no jit,
and the cost of a new shape is cuDNN's autotuner (`cudnn.benchmark`, when the
caller turns it on) trying its algorithms for every convolution the first
time a shape runs, with a transient peak of 13-20 GiB on the production
models (PERF.md section 5). So the shapes are bounded, as in JAX: the full
sweep and a static K run at the one width `batch`; under 'auto' a group runs
at the next power of two, at most `batch`, for each of the few K buckets;
samples likewise. And on the card the service runs each of those (width,
K) shapes once at start-up, on a three-step chain (an LCG
step, a GSG step and the last, unguided one), so the autotuner's trials and
the allocator's growth are paid before the first request, not by it.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from weatherconverter_tpu_torch.serving.batcher import MicroBatcher


def _png_bytes(arr01: np.ndarray) -> bytes:
    from PIL import Image

    img = Image.fromarray((np.clip(arr01, 0.0, 1.0) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _decode_png(b64: str, size: int, nearest: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    if not nearest:
        # images land as (H, W, 3) whatever their mode; labels keep theirs for exact ids
        img = img.convert("RGB")
    img = img.resize((size, size), Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(img)


def _n_present(gt: np.ndarray, num_classes: int) -> int:
    """The number of train classes in a label (255 and ids past the classes not counted), at least 1."""
    ids = np.unique(gt)
    return max(1, int(np.sum(ids < num_classes)))


def _bucket_for(n: int, buckets: tuple, num_classes: int) -> int:
    """The smallest K bucket that covers n classes."""
    for b in buckets:
        if n <= b:
            return b
    return num_classes


def _width(n: int, batch: int) -> int:
    """A group of n requests runs at the next power of two, at most `batch`."""
    return min(batch, 1 << (n - 1).bit_length())


class TranslationService:
    """Owns the models and the batched chains; thread-safe through its batchers."""

    WARMUP_STEPS = 3  # an LCG step, a GSG step and the unguided last one

    def __init__(
        self,
        cfg,
        ddpm_checkpoint: Optional[str] = None,
        seg_checkpoint: Optional[str] = None,
        srgan_checkpoint: Optional[str] = None,
        batch: int = 4,
        steps: Optional[int] = None,
        max_wait_ms: float = 25.0,
        sampler: str = "ddpm",
        lcg_present_k=None,
        lcg_k_buckets: tuple = (4, 8, 12),
        device=None,
    ):
        """lcg_present_k: None runs LCG's full class sweep; an int packs it
        into K slots an image for every request (bit-exact for labels with at
        most K classes, the K largest otherwise); "auto" counts each
        request's classes on the host and routes it to the smallest bucket of
        `lcg_k_buckets` (num_classes tops the ladder) that covers them, so a
        batch mixing 6- and 14-class scenes does not pay the largest K for
        every image, and every image is bit-exact against the full sweep.
        `device`: the CUDA card by default (raises without one), or "cpu"."""
        from weatherconverter_tpu_torch.cli.commands import build_translation
        from weatherconverter_tpu_torch.data.labels import encode_target

        if sampler in ("ddim", "dpm") and cfg.guidance.mode == "reference":
            # the fast chains have no analog of the reference's x_t overwrite: every
            # /v1/translate would be served unguided
            raise ValueError(f"sampler='{sampler}' with guidance.mode='reference' disables guidance entirely; use "
                             "mode='fixed' for guided fast serving or sampler='ddpm' for the reference's behaviour")
        num_classes = cfg.seg.model.num_classes
        if isinstance(lcg_present_k, str) and lcg_present_k != "auto":
            raise ValueError(f"lcg_present_k must be an int, 'auto', or None; got {lcg_present_k!r}")
        if isinstance(lcg_present_k, int) and not 1 <= lcg_present_k <= num_classes:
            raise ValueError(f"lcg_present_k out of range 1..{num_classes}: {lcg_present_k}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TranslationService runs on the CUDA card by default and found none; pass "
                               "device='cpu' to serve from the CPU")
        self._encode_target = encode_target
        self.cfg, self.sampler, self.batch = cfg, sampler, batch
        self.size = cfg.diffusion.model.im_size
        self.hr = self.size * cfg.srgan.upscale_factor
        self.num_classes = num_classes
        self.unet, self.seg, self.sr, self.sched = build_translation(
            cfg, self.device, ddpm_checkpoint, seg_checkpoint, srgan_checkpoint, False, 0)
        # translate and sample defaults are separate: the fast samplers' short default must not shorten /v1/sample
        self.sample_steps = steps or cfg.guidance.num_steps
        self.steps = steps or {"ddim": 50, "dpm": 20}.get(sampler, cfg.guidance.num_steps)
        self.lcg_present_k = lcg_present_k
        self._lcg_auto = lcg_present_k == "auto"
        self._k_buckets = tuple(sorted({int(b) for b in lcg_k_buckets if 1 <= int(b) < num_classes} | {num_classes}))
        self.bucket_counts: dict = {}
        if self.device.type == "cuda":
            self.warmup()
        self._translate_batcher = MicroBatcher(self._translate_batch, max_batch=batch, max_wait_ms=max_wait_ms)
        self._sample_batcher = MicroBatcher(self._sample_batch, max_batch=batch, max_wait_ms=max_wait_ms)

    # ---- the batched chains ----

    def _autocast(self):
        from weatherconverter_tpu_torch.cli.commands import autocast

        return autocast(self.device)

    def _generators(self, seeds) -> list:
        return [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def translate_rows(self, imgs: np.ndarray, gts: np.ndarray, seeds=None, present_k=None, steps=None,
                       noise=None) -> torch.Tensor:
        """One batched chain: imgs (W, h, w, 3) in [-1, 1], gts (W, HR, HR)
        train-ids, row i drawing from seed i (or `noise` replaying the draws,
        as the chains take it) -> (W, HR, HR, 3) in [0, 1]."""
        from weatherconverter_tpu_torch.guidance.translate import (sample_with_sgg, sample_with_sgg_ddim,
                                                                   sample_with_sgg_dpm)

        g = self.cfg.guidance
        kw = dict(lam=g.lambda_, num_steps=steps or self.steps, num_classes=self.num_classes, mode=g.mode,
                  lcg_present_k=present_k)
        if self.sampler in ("ddim", "dpm"):
            kw["span_t"] = g.num_steps  # the translate span, not the full T: noising to T - 1 erases the source
        chain = {"ddim": sample_with_sgg_ddim, "dpm": sample_with_sgg_dpm}.get(self.sampler, sample_with_sgg)
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32)).to(self.device)
        gt = torch.from_numpy(np.asarray(gts, dtype=np.int64)).to(self.device)
        gens = None if noise is not None else self._generators(seeds)
        with self._autocast():
            return chain(self.unet, self.sched, self.seg, self.sr, x, gt, gens, noise=noise, **kw)

    def _run_group(self, members, present_k, width):
        """members: (index, (image01, train-ids, seed)) each; one chain at `width` rows, padded with zeros."""
        imgs = np.zeros((width, self.size, self.size, 3), np.float32)
        gts = np.zeros((width, self.hr, self.hr), np.int64)
        seeds = [0] * width
        for i, (_, (im, lb, seed)) in enumerate(members):
            imgs[i], gts[i], seeds[i] = im * 2.0 - 1.0, lb, int(seed)
        out = self.translate_rows(imgs, gts, seeds, present_k).float().cpu().numpy()
        return [out[i] for i in range(len(members))]

    def _translate_batch(self, items):
        """items: (image01 (h, w, 3), train-ids (HR, HR), seed) each."""
        if not self._lcg_auto:
            # the full sweep or a static K: one width
            return self._run_group(list(enumerate(items)), self.lcg_present_k, self.batch)
        outputs = [None] * len(items)
        groups: dict = {}
        for idx, it in enumerate(items):
            groups.setdefault(_bucket_for(_n_present(it[1], self.num_classes), self._k_buckets, self.num_classes),
                              []).append((idx, it))
        for k, members in groups.items():
            self.bucket_counts[k] = self.bucket_counts.get(k, 0) + len(members)
            for (idx, _), o in zip(members, self._run_group(members, k, _width(len(members), self.batch))):
                outputs[idx] = o
        return outputs

    def sample_rows(self, seeds, steps: int) -> torch.Tensor:
        """One batched ddpm_sample, row i from seed i -> (W, size, size, 3) in [0, 1]."""
        from weatherconverter_tpu_torch.diffusion.sampling import ddpm_sample

        with self._autocast():
            out = ddpm_sample(self.unet, self.sched, (len(seeds), self.size, self.size, 3), self._generators(seeds),
                              num_steps=steps)
        return (out + 1.0) / 2.0

    def _sample_batch(self, items):
        """items: (steps, seed) each; one chain for each distinct step count, at a power-of-two width."""
        outputs = [None] * len(items)
        groups: dict = {}
        for idx, (st, seed) in enumerate(items):
            groups.setdefault(int(st), []).append((idx, int(seed)))
        for st, members in groups.items():
            seeds = [s for _, s in members] + [0] * (_width(len(members), self.batch) - len(members))
            out = self.sample_rows(seeds, st).float().cpu().numpy()
            for (idx, _), o in zip(members, out):
                outputs[idx] = o
        return outputs

    def shapes(self) -> list[tuple[int, Optional[int]]]:
        """Every (width, K) a translation can run at."""
        if not self._lcg_auto:
            return [(self.batch, self.lcg_present_k)]
        widths = sorted({_width(n, self.batch) for n in range(1, self.batch + 1)})
        return [(w, k) for w in widths for k in self._k_buckets]

    def warmup(self) -> None:
        """Run each translation shape and each sample width once, on a short chain."""
        for width, k in self.shapes():
            self.translate_rows(np.zeros((width, self.size, self.size, 3), np.float32),
                                np.zeros((width, self.hr, self.hr), np.int64), [0] * width, k,
                                steps=self.WARMUP_STEPS)
        for width in sorted({_width(n, self.batch) for n in range(1, self.batch + 1)}):
            self.sample_rows([0] * width, 2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the request threads' API ----

    def translate(self, image_b64: str, label_b64: str, seed: int = 0) -> bytes:
        img = _decode_png(image_b64, self.size).astype(np.float32)[..., :3] / 255.0
        lbl_ids = _decode_png(label_b64, self.hr, nearest=True)
        if lbl_ids.ndim == 3:
            lbl_ids = lbl_ids[..., 0]
        gt = np.asarray(self._encode_target(lbl_ids.astype(np.uint8)))
        return _png_bytes(self._translate_batcher.submit(img, gt, seed))

    def sample(self, steps: Optional[int] = None, seed: int = 0) -> bytes:
        return _png_bytes(self._sample_batcher.submit(steps or self.sample_steps, seed))

    def stats(self) -> dict:
        def fmt(b: MicroBatcher):
            n = max(b.stats["batches"], 1)
            return {"requests": b.stats["requests"], "batches": b.stats["batches"],
                    "mean_occupancy": b.stats["batch_occupancy_sum"] / n}

        out = {"translate": fmt(self._translate_batcher), "sample": fmt(self._sample_batcher)}
        if self._lcg_auto:
            out["lcg_k_buckets"] = {str(k): v for k, v in sorted(self.bucket_counts.items())}
        return out

    def close(self) -> None:
        self._translate_batcher.close()
        self._sample_batcher.close()


def make_handler(service: TranslationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"status": "ok"})
            if self.path == "/stats":
                return self._reply(200, service.stats())
            return self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/sample":
                    png = service.sample(req.get("steps"), req.get("seed", 0))
                elif self.path == "/v1/translate":
                    png = service.translate(req["image"], req["label"], req.get("seed", 0))
                else:
                    return self._reply(404, {"error": "not found"})
                return self._reply(200, {"image": base64.b64encode(png).decode()})
            except KeyError as e:
                return self._reply(400, {"error": f"missing field {e}"})
            except Exception as e:  # answer, and keep serving
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: TranslationService, port: int = 8700, block: bool = True, host: str = "0.0.0.0"):
    """Serve `service` on `port` (0: any free port); with block=False in a daemon thread, returning the server."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if block:
        httpd.serve_forever()
        return httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
