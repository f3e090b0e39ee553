"""The port's CLI: `python -m weatherconverter_tpu_torch.cli.main <command> ...`
(console script `weatherconverter-tpu-torch`), the counterpart of
weatherconverter_tpu/cli/main.py with the same subcommands, flags, defaults
and choices, and one addition: `--device {cuda,cpu}`.

Every command runs on the CUDA card unless `--device cpu` is given; without
a card it stops with a message and a non-zero exit, and never goes on
quietly on the CPU. Under torchrun (`torchrun --nproc-per-node N -m
weatherconverter_tpu_torch.cli.main train-ddpm|train-seg|train-srgan ...`)
main joins the process group first, as the JAX CLI initializes its
multi-process runtime, and the trainers run data parallel over the
processes (NCCL on the cards, gloo with --device cpu). Every subcommand is ported: train-ddpm, train-seg,
train-srgan, sample (with --sampler legacy), translate (with --debug-dir),
super-resolve, infer-seg, quality, visualize, serve and export-hlo (a
torch.export archive in place of StableHLO text: `--out`'s default ends in
.pt2, the one default that differs from the JAX CLI's).
"""

from __future__ import annotations

import argparse
import json
import sys

INT8_HELP = ("keep K1, the exact bf16 flash attention. On the card inference defaults to K2 (int8 Q K^T and its "
             "quantizer, one int8 scale for the batch, as JAX's CLI runs its kernel over the batch; the server "
             "takes one a request) in every flash-length attention layer (head dims 16-192), which "
             "passed the int8 quality check at 20, 50 and 1000 steps; the gain is small, 0.1-0.3 ms of a 14-25 ms "
             "device step, and no wall-time change while the host binds (PERF.md)")


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the command runs: the CUDA card (default; exits non-zero without one) or the CPU")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="weatherconverter-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    for name, what, cfg_help in (("train-ddpm", "train the DDPM UNet", "diffusion config YAML"),
                                 ("train-seg", "train DeepLabV3(+) segmentation", "seg config YAML"),
                                 ("train-srgan", "train Swift-SRGAN (pretrain + adversarial)", "srgan train config YAML")):
        t = sub.add_parser(name, help=what)
        t.add_argument("--config", default=None, help=cfg_help)
        t.add_argument("--max-steps", type=int, default=None)
        t.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
        _device_flag(t)

    sr = sub.add_parser("super-resolve", help="SRGAN upscale of an image")
    sr.add_argument("--config", default=None, help="translation config YAML (srgan section)")
    sr.add_argument("--image", required=True)
    sr.add_argument("--checkpoint", default=None, help="torch .pth.tar / .npz / a run directory of this package")
    sr.add_argument("--out", default="outputs/super_resolved.png")
    _device_flag(sr)

    sa = sub.add_parser("sample", help="unconditional DDPM sampling")
    sa.add_argument("--config", default=None)
    sa.add_argument("--checkpoint", default=None,
                    help=".npz / torch .ckpt / a run directory of this package; with --sampler legacy a reference "
                         "torch file (old_model/1000-checkpoint.ckpt)")
    sa.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpm", "legacy"],
                    help="dpm = DPM-Solver++(2M), 10-25 steps; legacy = the reference's legacy UNet (its shipped "
                         "checkpoint's architecture) and its beta-variance loop, conditioned on 1 - alpha_bar, in f32 "
                         "(--no-int8-attn changes nothing there)")
    sa.add_argument("--steps", type=int, default=None)
    sa.add_argument("--batch", type=int, default=8)
    sa.add_argument("--out", default="outputs/samples/sample.png")
    sa.add_argument("--seed", type=int, default=0)
    sa.add_argument("--no-int8-attn", action="store_true", help=INT8_HELP)
    _device_flag(sa)

    tr = sub.add_parser("translate", help="guided weather translation")
    tr.add_argument("--config", default=None, help="translation config YAML")
    tr.add_argument("--image", required=True, help="input image path")
    tr.add_argument("--label", required=True, help="gt labelIds path")
    tr.add_argument("--ddpm-checkpoint", default=None)
    tr.add_argument("--seg-checkpoint", default=None)
    tr.add_argument("--srgan-checkpoint", default=None)
    tr.add_argument("--out", default="outputs/translated.png")
    tr.add_argument("--mode", default="fixed", choices=["fixed", "reference"])
    tr.add_argument("--lambda", dest="lam", type=float, default=60.0)
    tr.add_argument("--steps", type=int, default=None, help="default: 500 for ddpm, 50 for ddim, 20 for dpm")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpm"],
                    help="ddim / dpm = few-step guided translation (dpm = DPM-Solver++(2M))")
    tr.add_argument("--eta", type=float, default=0.0, help="DDIM noise scale")
    tr.add_argument("--span-t", type=int, default=None,
                    help="diffusion span the fast samplers' taus stride (default: cfg.guidance.num_steps, which "
                         "keeps the source's content)")
    tr.add_argument("--no-int8-attn", action="store_true", help=INT8_HELP)
    tr.add_argument("--lcg-present-k", default="auto",
                    help="pack LCG's class sweep into K per-image slots holding the classes present in the label: "
                         "'auto' (default) counts them (bit-exact against the full sweep), an integer truncates to "
                         "the K largest, 'off' is the full sweep")
    tr.add_argument("--debug-dir", default=None,
                    help="dump the chain's intermediates here (input, gt, the noised and every --debug-every-th "
                         "latent, the SR output and its seg prediction); --sampler ddpm only")
    tr.add_argument("--debug-every", type=int, default=100)
    _device_flag(tr)

    iv = sub.add_parser("infer-seg", help="segmentation inference + gradient probe")
    iv.add_argument("--config", default=None)
    iv.add_argument("--checkpoint", default=None)
    iv.add_argument("--image", required=True)
    iv.add_argument("--label", default=None)
    iv.add_argument("--out", default="outputs/seg")
    _device_flag(iv)

    q = sub.add_parser("quality", help="translation quality gates: FID and mIoU-consistency")
    q.add_argument("--config", default=None, help="translation config YAML")
    q.add_argument("--images", default=None)
    q.add_argument("--synthetic", type=int, default=8)
    q.add_argument("--ddpm-checkpoint", default=None)
    q.add_argument("--seg-checkpoint", default=None)
    q.add_argument("--inception-checkpoint", default=None,
                   help="a torchvision-layout InceptionV3 .pth: FID on its pool3 features (default: the seg "
                        "backbone's pooled features, for relative tracking only)")
    q.add_argument("--guidance", default="gsg", choices=["gsg", "lcg", "alternate", "none"])
    q.add_argument("--lambda", dest="lam", type=float, default=60.0)
    q.add_argument("--steps", type=int, default=100)
    q.add_argument("--batch", type=int, default=4)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--out", default=None)
    _device_flag(q)

    sv = sub.add_parser("serve", help="micro-batched HTTP inference server")
    sv.add_argument("--config", default=None, help="translation config YAML")
    sv.add_argument("--port", type=int, default=8700)
    sv.add_argument("--batch", type=int, default=4, help="largest micro-batch")
    sv.add_argument("--steps", type=int, default=None)
    sv.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpm"],
                    help="ddim / dpm = few-step translation for serving latency (dpm: ~20 steps)")
    sv.add_argument("--max-wait-ms", type=float, default=25.0)
    sv.add_argument("--lcg-present-k", default=None,
                    help="LCG class slots: an int = one K for every request (truncates labels with more "
                         "classes); 'auto' = each request goes to the smallest K bucket covering its label's "
                         "classes (bit-exact); default: the full sweep")
    sv.add_argument("--lcg-k-buckets", default="4,8,12",
                    help="the K ladder of --lcg-present-k auto (num_classes always tops it)")
    sv.add_argument("--ddpm-checkpoint", default=None)
    sv.add_argument("--seg-checkpoint", default=None)
    sv.add_argument("--srgan-checkpoint", default=None)
    sv.add_argument("--no-int8-attn", action="store_true",
                    help="keep K1, the exact bf16 flash attention. On the card the server defaults to K2 (int8 Q K^T) "
                         "with one int8 scale per request, as the JAX service's vmap takes it, so a request's image "
                         "does not depend on its batch-mates (PERF.md)")
    _device_flag(sv)

    eh = sub.add_parser("export-hlo", help="export the inference program with torch.export (deployment artifact)")
    eh.add_argument("--config", default=None, help="translation config YAML")
    eh.add_argument("--program", default="translate", choices=["translate", "sample"])
    eh.add_argument("--steps", type=int, default=None,
                    help="reverse steps traced into the program (default: cfg.guidance.num_steps)")
    eh.add_argument("--batch", type=int, default=8)
    eh.add_argument("--out", default="outputs/translate.pt2",
                    help="the archive (torch.export.save); its argument list goes beside it, <out>.json")
    eh.add_argument("--attn", default="bf16", choices=["bf16", "int8"],
                    help="attention traced into the program: 'bf16' is plain softmax attention (JAX's fused=False), "
                         "loadable by any PyTorch runtime; 'int8' holds K2 and its quantizer as custom ops, traced "
                         "on CUDA only, loaded where weatherconverter_tpu_torch.ops.attention imports")
    _device_flag(eh)

    vz = sub.add_parser("visualize", help="forward/backward process strips and augmentation galleries")
    vz.add_argument("--config", default=None)
    vz.add_argument("--image", required=True)
    vz.add_argument("--checkpoint", default=None)
    vz.add_argument("--out", default="outputs/strips")
    vz.add_argument("--every", type=int, default=100)
    _device_flag(vz)
    return p


def parse_overrides(pairs):
    """["a.b=1", "c=x"] -> {"a": {"b": 1}, "c": "x"}: values as JSON where they parse, else strings."""
    out = {}
    for pair in pairs:
        k, _, v = pair.partition("=")
        cur = out
        parts = k.split(".")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        try:
            cur[parts[-1]] = json.loads(v)
        except ValueError:
            cur[parts[-1]] = v
    return out


def run_serve(args) -> int:
    from weatherconverter_tpu_torch.cli.commands import resolve_device, use_qk_int8
    from weatherconverter_tpu_torch.core.config import load_translation_config
    from weatherconverter_tpu_torch.serving.server import TranslationService, serve

    device = resolve_device(args.device)
    k = args.lcg_present_k
    if k is not None and k != "auto":
        try:
            k = int(k)
        except ValueError:
            raise SystemExit(f"--lcg-present-k must be an int or 'auto'; got {k!r}")
    try:
        buckets = tuple(int(b) for b in str(args.lcg_k_buckets).split(",") if b)
    except ValueError:
        raise SystemExit(f"--lcg-k-buckets must be comma-separated ints; got {args.lcg_k_buckets!r}")
    service = TranslationService(
        load_translation_config(args.config), args.ddpm_checkpoint, args.seg_checkpoint, args.srgan_checkpoint,
        batch=args.batch, steps=args.steps, max_wait_ms=args.max_wait_ms, sampler=args.sampler, lcg_present_k=k,
        lcg_k_buckets=buckets, device=device, qk_int8=use_qk_int8(args, device),
    )
    print(f"serving on :{args.port} (batch={args.batch}, steps={service.steps}, sampler={args.sampler}, "
          f"device={device}, attention={'K2, one int8 scale a request' if service.qk_int8 else 'K1'})", flush=True)
    serve(service, args.port)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from weatherconverter_tpu_torch.cli import commands
    from weatherconverter_tpu_torch.parallel.distributed import maybe_initialize_distributed

    # under torchrun, one process per card (gloo for --device cpu); without its variables, nothing
    ours = not dist.is_initialized() and maybe_initialize_distributed(getattr(args, "device", "cuda"))
    try:
        return {"train-ddpm": commands.run_train_ddpm, "train-seg": commands.run_train_seg,
                "train-srgan": commands.run_train_srgan, "sample": commands.run_sample,
                "translate": commands.run_translate, "super-resolve": commands.run_super_resolve,
                "infer-seg": commands.run_infer_seg, "quality": commands.run_quality,
                "visualize": commands.run_visualize, "export-hlo": commands.run_export_hlo,
                "serve": run_serve}[args.command](args)
    finally:
        if ours:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
