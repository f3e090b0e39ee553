"""probes/stack_sample: a script's time by phase, statement and innermost call, its exit code kept."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import subprocess, sys, time


def phase_busy():
    t = time.perf_counter()
    while time.perf_counter() - t < 0.6:
        pass


def phase_child():
    subprocess.run([sys.executable, "-c", "import time; time.sleep(0.4)"])


def main():
    phase_busy()
    phase_child()
    return 3


if __name__ == "__main__":
    sys.exit(main())
"""


def test_stack_sample_attributes_time_to_phases_and_keeps_the_exit_code(tmp_path):
    script, out = tmp_path / "s.py", tmp_path / "o" / "samples.json"
    script.write_text(SCRIPT)
    proc = subprocess.run([sys.executable, "-m", "weatherconverter_tpu_torch.probes.stack_sample", "--every",
                           "0.02", "--out", str(out), str(script)], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 3, proc.stderr
    got = json.loads(out.read_text())
    assert got["every_s"] == 0.02 and got["wall_s"] >= 1.0
    assert set(got["by_phase"]) <= {"phase_busy", "phase_child", "main"}
    assert got["by_phase"]["phase_busy"] >= 0.3 and got["by_phase"]["phase_child"] >= 0.2
    # the busy loop's statement, and the child's time as the parent's wait in subprocess
    assert any(k.startswith("phase_busy:") and "s.py:phase_busy:" in k for k in got["by_phase_line"])
    assert any(k.startswith("phase_child | - | subprocess.py:") for k in got["by_phase_inner"])
