"""Stage timers and event counters.

Port of the timer registry of vieo_slam_tpu/utils/metrics.py (the
reference's mlog::Timer statics).  Stage timers measure HOST wall time
around a stage; GPU work is asynchronous, so a timer bounds enqueue plus
host work unless the stage ends by reading results back (tracking and
local mapping do).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class _StageStat:
    """Cumulative stats of one named stage."""
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    last: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.last = dt
        if dt > self.max:
            self.max = dt

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Registry:
    """Named stage timers + event counters and gauges."""

    def __init__(self):
        self.stages: dict[str, _StageStat] = defaultdict(_StageStat)
        self.counters: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str):
        """`with metrics.timer("track"): ...` -- cumulative host timing."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def set_gauge(self, name: str, v):
        self.counters[name] = v

    def report(self) -> dict:
        """Machine-readable snapshot: per-stage ms stats + counters."""
        return {
            "stages_ms": {
                k: {"count": s.count,
                    "mean": round(1e3 * s.mean, 3),
                    "max": round(1e3 * s.max, 3),
                    "last": round(1e3 * s.last, 3),
                    "total": round(1e3 * s.total, 1)}
                for k, s in sorted(self.stages.items())
            },
            "counters": dict(sorted(self.counters.items())),
        }

    def reset(self):
        self.stages.clear()
        self.counters.clear()


# process-global registry (mlog's statics)
metrics = Registry()
