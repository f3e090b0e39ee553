"""Preemption-safe training: SIGTERM -> flush a checkpoint -> clean exit
(port of weatherconverter_tpu/core/preempt.py, which has no JAX in it; the
port's package imports nothing from the JAX package's `core`, whose
__init__ loads JAX).

Schedulers deliver SIGTERM with a grace window before they kill a worker.
The training loop polls a flag at every step boundary; on preemption it
saves the current train state through the normal checkpoint path, waits
for the write and returns. The handler only sets the flag, so a signal
landing in the middle of a step never corrupts it: the loop finishes the
step, then checkpoints the post-step state.

In a multi-process run a signal may reach one rank only; a rank that left
the loop alone would leave the others waiting in the next collective. The
loops read `triggered_anywhere(group)`, the flag agreed across the ranks
(an all-reduce of max over a gloo group, parallel.sharding.host_group) at
every step boundary, and all save and return together. The flag is a CPU
tensor: agreeing it waits for the other ranks' hosts, never for the card.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

import torch
import torch.distributed as dist


class PreemptionGuard:
    """Context manager that latches termination signals into a flag.

        with PreemptionGuard() as guard:
            for batch in loader:
                ...
                if guard.triggered:
                    <save + flush checkpoint>; break

    Installs handlers for `signals` (default SIGTERM; SIGINT is left to
    KeyboardInterrupt so ^C still aborts hard) on __enter__ and restores the
    previous ones on __exit__. A second signal while the flag is set
    restores the default handler and re-raises, so a stuck flush can still
    be killed. Off the main thread, where Python forbids signal(), the guard
    is an always-False flag.
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,)):
        self._signals = signals
        self._prev: dict = {}
        self._event = threading.Event()
        self.received: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def triggered_anywhere(self, group=None) -> bool:
        """`triggered` on any rank of `group`, a gloo process group (None:
        this process alone). Every rank of the group must call it."""
        if group is None:
            return self.triggered
        flag = torch.tensor([int(self.triggered)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())

    def _handler(self, signum, frame):
        if self._event.is_set():
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self.received = signum
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not on the main thread
                pass
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        return None


def preempt_save_index(ckpt, global_step: int) -> int:
    """A save index for a preemption checkpoint that is unique and grows
    within the run's CheckpointManager: epoch-cadence saves use small epoch
    numbers, so the global step is normally larger; if a tiny run makes
    them collide, bump past the latest saved index."""
    latest = ckpt.latest_step()
    if latest is not None and global_step <= latest:
        return latest + 1
    return max(global_step, 1)
