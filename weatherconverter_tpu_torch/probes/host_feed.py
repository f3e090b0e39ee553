"""Images per second through the port's host feed, by decoder path:

    python -m weatherconverter_tpu_torch.probes.host_feed [--files 128] [--epochs 3]
        [--size 1920x1080] [--workers 8] [--torch-dataloader] [--out FILE.json]

Writes `--files` synthetic PNG and as many JPEG files of `--size` (ACDC's
1920x1080 by default; ACDC's images are PNG) into a temporary directory,
reads each format as a `DiffusionImageDataset` at 128 px through
`data.loader.DataLoader`, and for each format and path runs one epoch
untimed (thread pools, the library's first load, the page cache) and then
`--epochs` timed epochs:
  * the native batch decoder (`get_batch`, C++ threads), when the library
    builds and loads; `native.describe()` says why not otherwise;
  * PIL (`load_image_resized`, the native decoder's fallback) on the
    loader's `--workers` threads;
  * with `--torch-dataloader`, PIL through
    `torch.utils.data.DataLoader(num_workers=--workers)` with a shuffling
    batch sampler, as the port's loops fed before they took
    `data.loader`: its worker processes start anew every epoch, so every
    timed epoch pays their start, as the loops did.
Each path's per-epoch rates, their median and spread, the host's CPU
count and, with the native decoder, its largest difference from PIL (at
most one level) are printed and, with `--out`, written as JSON. Runs on the
CPU alone: no card is needed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BATCH = 8  # images a batch, as the training configs' batch_size

class PILFeed:
    """A DiffusionImageDataset read through PIL only: what its `__getitem__`
    does when the native decoder is unavailable."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        from weatherconverter_tpu_torch.data.datasets import load_image_resized

        return np.array(load_image_resized(self.ds.img_paths[i], self.ds.resize_to, self.ds.out_wh))


FORMATS = ("png", "jpg")


def write_files(root: str, files: int, size: tuple[int, int], workers: int) -> float:
    """`files` PNG files into <root>/png/train and as many JPEG files into
    <root>/jpg/train, of `size` (W, H), each a smooth pattern shifted by its
    index plus a seeded grain, written on `workers` threads; returns the
    seconds taken."""
    from PIL import Image

    for fmt in FORMATS:
        os.makedirs(os.path.join(root, fmt, "train"), exist_ok=True)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([127 + 90 * np.sin(yy / 31 + c) * np.cos(xx / (41 + 2 * c)) for c in range(3)], -1)
    base = base.astype(np.int16)

    def one(i):
        grain = np.random.default_rng(i).integers(-6, 7, (h, w, 1), dtype=np.int16)
        img = Image.fromarray((np.roll(base, 37 * i, axis=1) + grain).clip(0, 255).astype(np.uint8))
        img.save(os.path.join(root, "png", "train", f"{i:04d}.png"), compress_level=1)
        img.save(os.path.join(root, "jpg", "train", f"{i:04d}.jpg"), quality=90)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(one, range(files)))
    return time.perf_counter() - t0


def epoch_rates(loader, n: int, epochs: int) -> list[float]:
    """One untimed epoch, then `epochs` timed ones: images per second each."""
    rates = []
    for e in range(epochs + 1):
        t0 = time.perf_counter()
        seen = sum(b.shape[0] for b in loader)
        dt = time.perf_counter() - t0
        if seen != n:
            raise AssertionError(f"host feed: {seen} images through the loader in an epoch, expected {n}")
        if e:
            rates.append(n / dt)
    return rates


def torch_dataloader(ds, workers: int):
    """PIL through torch.utils.data.DataLoader, as the loops fed before data.loader."""
    import torch

    order = torch.utils.data.RandomSampler(range(len(ds)), generator=torch.Generator().manual_seed(0))
    batches = torch.utils.data.BatchSampler(order, BATCH, drop_last=True)
    return torch.utils.data.DataLoader(PILFeed(ds), batch_sampler=batches, num_workers=workers)


def measure(root: str, files: int, size: tuple[int, int], epochs: int, workers: int, with_torch: bool = False) -> dict:
    """The probe's readings (module docstring) for files written under `root`."""
    from weatherconverter_tpu_torch.data import native
    from weatherconverter_tpu_torch.data.datasets import DiffusionImageDataset
    from weatherconverter_tpu_torch.data.loader import DataLoader

    write_s = write_files(root, files, size, workers)
    rates, levels = {}, []
    for fmt in FORMATS:
        ds = DiffusionImageDataset(root, (fmt,), splits=("train",), resize_to=128)
        n = len(ds) // BATCH * BATCH
        paths = {}
        if native.available():
            paths["native batch decode (get_batch)"] = DataLoader(ds, BATCH, seed=0, num_workers=workers)
        paths[f"PIL on the loader's {workers} threads"] = DataLoader(PILFeed(ds), BATCH, seed=0, num_workers=workers)
        if with_torch:
            paths[f"PIL through torch.utils.data.DataLoader(num_workers={workers})"] = torch_dataloader(ds, workers)
        for what, loader in paths.items():
            rates[f"{what}, {fmt.upper()}"] = epoch_rates(loader, n, epochs)
        if native.available():
            levels += [int(np.abs(native.decode_box(p, ds.resize_to, ds.out_wh).astype(np.int16)
                                  - PILFeed(ds)[i].astype(np.int16)).max()) for i, p in enumerate(ds.img_paths)]
    return dict(decoder=native.describe(), files=files, size=list(size), images_an_epoch=n, batch=BATCH,
                workers=workers, epochs=epochs, cpus=os.cpu_count(), write_s=write_s, rates=rates,
                native_vs_pil_levels=max(levels) if levels else None)


def report(r: dict) -> list[str]:
    lines = [f"{r['decoder']}",
             f"{r['files']} PNG and {r['files']} JPEG files of {r['size'][0]}x{r['size'][1]} (written in "
             f"{r['write_s']:.1f} s), DiffusionImageDataset at 128 px a format, batches of {r['batch']}, "
             f"{r['images_an_epoch']} images an epoch, one epoch untimed then {r['epochs']} timed, {r['cpus']} CPUs "
             f"on this host:"]
    for what, rates in r["rates"].items():
        lines.append(f"  {what}: median {statistics.median(rates):.1f} images/s (epochs: "
                     f"{', '.join(f'{x:.1f}' for x in rates)})")
    if r["native_vs_pil_levels"] is not None:
        lines.append(f"native against PIL over the {2 * r['files']} files: at most {r['native_vs_pil_levels']} "
                     f"level(s) apart")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=128, help="PNG files, and as many JPEG files")
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs after the untimed one")
    ap.add_argument("--size", default="1920x1080", help="WxH of the files")
    ap.add_argument("--workers", type=int, default=8, help="the loader's threads (torch's worker processes)")
    ap.add_argument("--torch-dataloader", action="store_true", help="also time torch.utils.data.DataLoader")
    ap.add_argument("--out", help="write the readings as JSON here")
    args = ap.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x"))
    with tempfile.TemporaryDirectory() as root:
        r = measure(root, args.files, size, args.epochs, args.workers, args.torch_dataloader)
    for ln in report(r):
        print(ln, flush=True)
    if r["native_vs_pil_levels"] is not None and r["native_vs_pil_levels"] > 1:
        print(f"host_feed: the native decoder is {r['native_vs_pil_levels']} levels from PIL (limit 1)",
              file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
