"""Checkpoint save/restore with torch.save (port of the subset of
weatherconverter_tpu/core/checkpoint.py that the training loop uses).

A checkpoint is one step directory, `<dir>/<step>/state.pt`, holding the
train state's `state_dict()` (model, Adam, EMA, step, epoch). A save writes
a temporary file and renames it, so a reader never sees half a file; saves
are synchronous, so `wait` has nothing to wait for (the JAX package's Orbax
saves are asynchronous). Orbax itself is not carried over.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    """Step-indexed checkpoints in one directory; keeps the newest
    `max_to_keep`. (The JAX manager's best-metric bookkeeping serves
    segmentation training and comes with that slice.)"""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _file(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(self._file(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """`state` is anything with `state_dict()`, or a tree torch.save takes."""
        path = self._file(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        torch.save(tree, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

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
    samples/ inside it."""
    run_dir = os.path.join(base, str(find_max_run_id(base) + 1))
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "samples"), exist_ok=True)
    return run_dir


def restore_auto(path: str, target: Any) -> Any:
    """Restore `target` from any checkpoint artifact this package writes: a
    state file, a CheckpointManager directory (its latest step) or one step
    directory."""
    if os.path.isfile(path):
        return _load_into(path, target)
    if any(d.isdigit() for d in os.listdir(path)):
        return CheckpointManager(path).restore(target=target)
    return _load_into(os.path.join(path, STATE_FILE), target)
