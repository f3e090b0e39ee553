"""Whole runs at tiny sizes on the CPU through the harness (the look for a
card skipped), the refusal without a card, the import check, a dummy cell
added from new files alone, and planted faults that `correct` must catch;
on a card, the control (the reference in TF32) must fail the check."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from wcbench import faults
from wcbench.harness import ROOT, Bench, forbidden_modules, run_cell
from wcbench.tests.tiny import tiny_bench

CELLS = {"translate": "sgg-translate512.alternate-b4", "train": "ddpm-unet128.train-b16",
         "sample": "ddpm-unet128.sample-dpm20-b16"}
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("tiny")))


def _run(bench, cell, seed=SEED, trace=False, device="cpu"):
    return run_cell(bench, cell, seed, 0.5, trace, device, time.perf_counter())


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing(monkeypatch, capsys):
    from wcbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS["train"], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "weatherconverter_tpu_torch_fake.x", sys)
    assert "weatherconverter_tpu_torch_fake.x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "weatherconverter_tpu.fake", sys)
    assert "weatherconverter_tpu.fake" in forbidden_modules()


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from wcbench.tests.tiny import tiny_bench\n"
            "from wcbench.harness import run_cell, forbidden_modules\n"
            "r = run_cell(tiny_bench(%r), %r, 5, 0.2, False, 'cpu', time.perf_counter())\n"
            "print(r['correct'], forbidden_modules())\n") % (ROOT, str(tmp_path), CELLS["sample"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_runs_are_correct_and_report_their_metrics(tiny, kind):
    r = _run(tiny, CELLS[kind])
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check" and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in tiny.metrics("end_to_end", CELLS[kind])}


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(CELLS) for f in faults.FAULTS])
def test_planted_faults_make_correct_false(tiny, kind, fault):
    with faults.plant(kind, fault):
        r = _run(tiny, CELLS[kind])
    assert not r["correct"], r["check"]


def test_a_dummy_cell_from_new_files_alone(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "wcbench"), root / "wcbench", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    (root / "wcbench" / "configs" / "dummy.json").write_text(json.dumps({"size": 8}))
    (root / "wcbench" / "traffic" / "dummy-mix.json").write_text(json.dumps({"driver": "dummy", "n": 3}))
    (root / "wcbench" / "drivers" / "dummy.py").write_text(
        "import torch\n"
        "class Cell:\n"
        "    kind, steps_per_call = 'dummy', 1\n"
        "    def __init__(self, ctx):\n"
        "        self.x = torch.ones(ctx.config['size'], device=ctx.device)\n"
        "    def step(self, spans=False):\n"
        "        self.x = self.x * 1.0\n"
        "        return {'things': self.ctx_n if False else 1}\n"
        "    def free_program(self):\n"
        "        pass\n"
        "    def check(self, control=False):\n"
        "        return [('exact', float((self.x - 1).abs().max()), 0.0)]\n")
    (root / "wcbench" / "metrics" / "things_per_s.py").write_text(
        "def read(ctx):\n    return ctx.work['things'] / ctx.window_s\n")
    manifest["configs"].append({"name": "dummy", "source": "https://example.org/dummy", "file": "wcbench/configs/dummy.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "dummy.mix", "config": "dummy", "traffic": "dummy-mix", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({"name": "things_per_s", "unit": "things/s", "better": "higher", "bound": 0.05,
                                   "source": "host_clock", "workloads": ["dummy.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    bench = Bench(root=str(root), bench_dir=str(root / "wcbench"))
    r = run_cell(bench, "dummy.mix", 1, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"things_per_s", "setup_s"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is the reference in TF32, which only the card computes")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_control_fails_the_check_on_the_card(tiny, card, kind):
    from wcbench.harness import Context

    bench = tiny
    cell = bench.workload(CELLS[kind])
    tr = bench.traffic(cell["traffic"])
    ctx = Context(config=bench.config(cell["config"]), traffic=tr, seed=SEED, device=torch.device(card))
    runner = bench.driver(tr["driver"]).Cell(ctx)
    for _ in range(2):
        runner.step()
    runner.free_program()
    assert all(v <= limit for _, v, limit in runner.check())
    assert any(v > limit for _, v, limit in runner.check(control=True))
