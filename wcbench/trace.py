"""From a torch.profiler trace to what the per-layer readers take: the
device's kernels in the traced window, the time they cover (the union of
their intervals, not the sum of their lengths), the idle gaps and what the
host was doing in each, and the `breakdown` of the result line."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    """Kernels as (name, start_us, end_us); host ops as (name, start_us,
    end_us); the traced window [t0_us, t1_us]."""

    kernels: list[tuple[str, float, float]]
    host: list[tuple[str, float, float]]
    t0_us: float
    t1_us: float
    merged: list[tuple[float, float]] = field(default_factory=list)

    def __post_init__(self):
        self.kernels = [k for k in self.kernels if k[2] > self.t0_us and k[1] < self.t1_us]
        self.merged = union([(max(s, self.t0_us), min(e, self.t1_us)) for _, s, e in self.kernels])

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) * 1e-6

    def kernel_time_s(self, match) -> float:
        """The summed lengths of the kernels whose name `match` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the window, in order."""
        out, at = [], self.t0_us
        for s, e in self.merged:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.t1_us:
            out.append((at, self.t1_us))
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for n, s, e in self.kernels:
            ops[_short(n)] += (e - s) * 1e-6
        return {"device_ops": _top(ops, top), "idle_gaps": _top(self.idle_by_host(), top)}

    def idle_by_host(self) -> dict[str, float]:
        """Idle seconds by the innermost host op running at each gap's middle."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = defaultdict(float)
        for s, e in self.gaps():
            mid, best = (s + e) / 2, None
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 200), -1):
                n, hs, he = host[j]
                if hs <= mid <= he and (best is None or he - hs < best[1]):
                    best = (n, he - hs)
            out[_short(best[0]) if best else "(no host op)"] += (e - s) * 1e-6
        return out


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _top(d: dict[str, float], n: int) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof, t0_us: float | None = None, t1_us: float | None = None) -> Trace:
    """The kernels (with memory copies and fills; not the ranges of
    record_function, which the profiler also lists on the device) and host
    ops of a stopped torch.profiler.profile. The window is [t0_us, t1_us] on
    the profiler's clock, by default the span of the ranges named
    "wcbench.window"."""
    from torch.autograd import DeviceType

    kernels, host, marks = [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False) and ev.name != "wcbench.window":
                kernels.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
            if ev.name == "wcbench.window":
                marks.append((s, e))
    if t0_us is None:
        t0_us = min(s for s, _ in marks) if marks else min((k[1] for k in kernels), default=0.0)
    if t1_us is None:
        t1_us = max(e for _, e in marks) if marks else max((k[2] for k in kernels), default=0.0)
    return Trace(kernels, host, t0_us, t1_us)
