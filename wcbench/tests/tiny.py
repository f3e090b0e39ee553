"""A copy of the benchmark at sizes a CPU test can hold: the same manifest,
drivers and readers, the configurations' UNet cut to a 32 px ladder whose
flash-length layer (N = 1024) has head dims the int8 path takes, the SRGAN
to 2 blocks, the traffic to batch 2 and 128 px labels. The seg model keeps
its published widths (ResNet-101, DeepLabV3+)."""

from __future__ import annotations

import json
import os
import shutil

from wcbench.harness import BENCH_DIR, ROOT, Bench

TINY_UNET = {"im_channels": 3, "im_size": 32, "down_channels": [16, 32, 32], "mid_channels": [32, 32, 32],
             "down_sample": [True, False], "time_emb_dim": 16, "num_down_layers": 1, "num_mid_layers": 1,
             "num_up_layers": 1, "num_heads": 1, "attn_resolutions": [32]}
TINY_TRAFFIC = {"translate": dict(image_size=32, label_size=128, batch=2, present=3, lcg_present_k=3,
                                  lcg_class_chunk=2, regions=6),
                "train": dict(batch=2, raw_height=32, raw_width=57, crop=32),
                "sample": dict(batch=2, steps=4)}


def tiny_bench(tmp: str) -> Bench:
    bench = os.path.join(tmp, "bench")
    for d in ("drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, d), os.path.join(bench, d))
    os.makedirs(os.path.join(bench, "traffic"))
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        cfg["unet"] = dict(TINY_UNET)
        if "srgan" in cfg:
            cfg["srgan"]["num_blocks"] = 2
        c["file"] = f"bench/configs/{c['name']}.json"
        with open(os.path.join(tmp, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in manifest["workloads"]:
        with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")) as fh:
            tr = json.load(fh)
        tr.update(TINY_TRAFFIC[tr["driver"]])
        with open(os.path.join(bench, "traffic", f"{w['traffic']}.json"), "w") as fh:
            json.dump(tr, fh)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh)
    return Bench(root=tmp, bench_dir=bench)
