"""Run logging: console and an append-only metrics.jsonl (port of
weatherconverter_tpu/core/logging.py without the optional wandb sink).

`log` writes one JSON record per call with the run time (`_time`) and the
step (`_step`); 0-d tensors and numpy scalars become plain numbers. The run
config goes to config.json beside it. In a multi-process run only the
primary logs: the other ranks' loggers write and print nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, config: Optional[dict] = None):
        from weatherconverter_tpu_torch.parallel.distributed import is_primary

        self.run_dir = run_dir
        self.enabled = is_primary()
        self._t0 = time.time()
        if not self.enabled:
            self._f = None
            return
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if config:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        rec = {k: _scalar(v) for k, v in metrics.items()}
        rec["_time"] = round(time.time() - self._t0, 3)
        if step is not None:
            rec["_step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def print(self, msg: str) -> None:
        if self.enabled:
            print(msg, flush=True)

    def finish(self) -> None:
        if self._f is not None:
            self._f.close()


def _scalar(v):
    return v.item() if hasattr(v, "item") and getattr(v, "ndim", None) == 0 else v
