"""BENCHMARK.json against the benchmark's contract, and each cell's files found by name."""

from __future__ import annotations

import json
import os
import re

import pytest
import yaml

from wcbench.harness import BENCH_DIR, ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench() -> Bench:
    return Bench()


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_names_and_units(bench):
    m = bench.manifest
    assert set(m) == KEYS
    assert m["paths"] == ["wcbench"] and all(not p.startswith("/") and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(_one_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 2 + 14 * 24 * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for section in ("configs", "workloads", "end_to_end", "per_layer") for e in m[section]]
    assert all(NAME.match(n) for n in names)
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in m[section]}) == len(m[section])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(json.dumps(m)) <= 64 * 1024


def test_configs_are_files_under_paths_at_the_published_widths(bench):
    for c in bench.manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wcbench/configs/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == [] and _one_line(c["source"]) and _one_line(c["why"])
    with open(os.path.join(ROOT, "configs", "diffusion.yaml")) as fh:
        diffusion = yaml.safe_load(fh)
    with open(os.path.join(ROOT, "configs", "translation.yaml")) as fh:
        translation = yaml.safe_load(fh)
    for name in ("ddpm-unet128", "sgg-translate512"):
        cfg = bench.config(name)
        for key, value in cfg["unet"].items():
            assert diffusion["model"][key] == value, key
        for key, value in cfg["diffusion"].items():
            assert diffusion["diffusion"][key] == value, key
    cfg = bench.config("sgg-translate512")
    assert cfg["srgan"] == {k: v for k, v in translation["srgan"].items()}
    assert {k: cfg["seg"][k] for k in ("num_classes", "output_stride")} == \
        {k: translation["seg"]["model"][k] for k in ("num_classes", "output_stride")}
    assert cfg["seg"]["name"] == translation["seg"]["model"]["name"]
    g = translation["guidance"]
    assert cfg["guidance"] == {"lambda": g["lambda"], "num_steps": g["num_steps"], "mode": g["mode"]}


def test_each_cell_finds_its_files_by_name_and_reports_what_the_contract_asks(bench):
    m = bench.manifest
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace") for e in e2e.values())
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _one_line(w["why"])
        assert w["chips"] in (1, 4)
        tr = bench.traffic(w["traffic"])
        assert os.path.isfile(os.path.join(BENCH_DIR, "drivers", f"{tr['driver']}.py"))
        assert bench.driver(tr["driver"]).Cell.kind
        reported = [e["name"] for e in bench.metrics("end_to_end", w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics("per_layer", w["name"])
    layers = {}
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["moves"] in e2e and _one_line(e["layer"])
        for cell in e["workloads"]:
            assert cell in e2e[e["moves"]].get("workloads", [cell])
        layers.setdefault(e["name"].split(".")[0], set()).add(e["layer"])
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(bench.reader(e["name"]).read)
