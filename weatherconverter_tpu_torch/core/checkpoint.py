"""Checkpoint save/restore with torch.save (port of the subset of
weatherconverter_tpu/core/checkpoint.py that the training loops use).

A checkpoint is one step directory, `<dir>/<step>/state.pt`, holding the
train state's `state_dict()` (model, optimizer, EMA where there is one,
step, epoch). A save writes a temporary file and renames it, so a reader
never sees half a file; saves are synchronous, so `wait` has nothing to
wait for (the JAX package's Orbax saves are asynchronous). Orbax itself is
not carried over.

Multi-process runs: every rank calls `save` (under FSDP it gathers the
full state, a collective), the primary alone writes, and every rank waits
at a barrier, so a checkpoint written by N ranks is one whole state that
loads into one process, and the reverse. `create_run` allocates the run
directory on the primary and hands its path to the others. Every rank
restores.

Best-metric bookkeeping as in the JAX manager: a manager made with
`best_metric_name` records in `<dir>/best.json` the step whose metric was
best so far ("max" or "min" mode), and `restore_auto(prefer_best=True)`
loads that step from a run's checkpoint directory. Unlike Orbax's keep-N,
the pruning of old steps never deletes the best one.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

from weatherconverter_tpu_torch.parallel.distributed import barrier, broadcast_object, is_primary
from weatherconverter_tpu_torch.parallel.fsdp import full_state

STATE_FILE = "state.pt"
BEST_FILE = "best.json"


class CheckpointManager:
    """Step-indexed checkpoints in one directory; keeps the newest
    `max_to_keep` and, with `best_metric_name`, the best step."""

    def __init__(self, directory: str, max_to_keep: int = 3, best_metric_name: Optional[str] = None,
                 best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', not {best_mode!r}")
        self.directory = os.path.abspath(directory)
        if is_primary():
            os.makedirs(self.directory, exist_ok=True)
        barrier()
        self.max_to_keep = max_to_keep
        self.best_metric_name = best_metric_name
        self.best_mode = best_mode
        self._best_path = os.path.join(self.directory, BEST_FILE)

    def _file(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(self._file(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """`state` is anything with `state_dict()`, or a tree torch.save takes.
        `metrics[best_metric_name]`, when given, may make this the best step.
        Every rank of a run calls it; the primary writes (module docstring)."""
        tree = full_state(state.state_dict() if hasattr(state, "state_dict") else state)
        if is_primary():
            self._write(step, tree, metrics)
        barrier()

    def _write(self, step: int, tree: Any, metrics: Optional[dict]) -> None:
        path = self._file(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(tree, path + ".tmp")
        os.replace(path + ".tmp", path)
        if metrics and self.best_metric_name and self.best_metric_name in metrics:
            current, best = float(metrics[self.best_metric_name]), self.best_value()
            if best is None or (current > best if self.best_mode == "max" else current < best):
                with open(self._best_path + ".tmp", "w") as f:
                    json.dump({"step": step, self.best_metric_name: current}, f)
                os.replace(self._best_path + ".tmp", self._best_path)
        keep = self.best_step()
        for old in self.all_steps()[:-self.max_to_keep]:
            if old != keep:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def _best(self) -> Optional[dict]:
        if not os.path.exists(self._best_path):
            return None
        with open(self._best_path) as f:
            return json.load(f)

    def best_value(self) -> Optional[float]:
        best = self._best()
        return None if best is None else float(best[self.best_metric_name])

    def best_step(self) -> Optional[int]:
        best = self._best()
        return None if best is None else int(best["step"])

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """The saved tree of `step` (the latest by default), loaded into
        `target` with `load_state_dict` when one is given."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return _load_into(self._file(step), target)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""


def _load_into(path: str, target: Any) -> Any:
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return tree
    target.load_state_dict(tree)
    return target


def find_max_run_id(base: str) -> int:
    if not os.path.isdir(base):
        return -1
    ids = [int(name) for name in os.listdir(base) if re.fullmatch(r"\d+", name)]
    return max(ids, default=-1)


def create_run(base: str) -> str:
    """Allocate the next numbered run directory, with checkpoints/ and
    samples/ inside it: on the primary, whose path every rank returns."""
    run_dir = None
    if is_primary():
        run_dir = os.path.join(base, str(find_max_run_id(base) + 1))
        os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(run_dir, "samples"), exist_ok=True)
    return broadcast_object(run_dir)


def restore_auto(path: str, target: Any, *, prefer_best: bool) -> Any:
    """Restore `target` from any checkpoint artifact this package writes: a
    state file, a CheckpointManager directory (its best step when it
    recorded one and `prefer_best`, else its latest) or one step directory.
    `prefer_best` has no default: a load (inference, a seg model for
    guidance) takes the best step, a resume the latest."""
    if os.path.isfile(path):
        return _load_into(path, target)
    if any(d.isdigit() for d in os.listdir(path)):
        mgr = CheckpointManager(path)
        return mgr.restore(step=mgr.best_step() if prefer_best else None, target=target)
    return _load_into(os.path.join(path, STATE_FILE), target)
