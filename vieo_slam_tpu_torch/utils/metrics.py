"""Metrics, timing and leveled logging.

Port of vieo_slam_tpu/utils/metrics.py (the reference's mlog::Timer
statics, its PRINT_* leveled macros with ANSI colors and per-file sinks,
and the per-stage exit report of stereo_euroc.cc).  Stage timers measure
HOST wall time around a stage; GPU work is asynchronous, so a timer bounds
enqueue plus host work unless the stage ends by reading results back
(tracking and local mapping do).  For device time use `trace()`, which
wraps torch.profiler and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from dataclasses import dataclass

# --------------------------------------------------------------------------
# leveled logging

LOG_ERROR, LOG_WARN, LOG_INFO, LOG_DEBUG = 0, 1, 2, 3
_LEVEL_NAMES = {"error": 0, "warn": 1, "info": 2, "debug": 3}
_COLORS = {0: "\033[31m", 1: "\033[33m", 2: "\033[32m", 3: "\033[36m"}
_RESET = "\033[0m"


def _env_level() -> int:
    return _LEVEL_NAMES.get(
        os.environ.get("VIEO_LOG", "warn").lower(), LOG_WARN)


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
    """Named stage timers + event counters and gauges + leveled logger."""

    def __init__(self, level: int | None = None, sink=None):
        self.stages: dict[str, _StageStat] = defaultdict(_StageStat)
        self.counters: dict[str, int] = defaultdict(int)
        self.level = _env_level() if level is None else level
        self.sink = sink or sys.stderr
        self.enabled = True
        self._files: dict[str, object] = {}

    # -- timing ------------------------------------------------------------

    @contextlib.contextmanager
    def timer(self, name: str):
        """`with metrics.timer("track"): ...` -- cumulative host timing."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def add_time(self, name: str, dt: float):
        if self.enabled:
            self.stages[name].add(dt)

    # -- counters ----------------------------------------------------------

    def count(self, name: str, n: int = 1):
        if self.enabled:
            self.counters[name] += n

    def set_gauge(self, name: str, v):
        if self.enabled:
            self.counters[name] = v

    # -- logging -----------------------------------------------------------

    def _log(self, lvl: int, msg: str, file: str | None):
        if lvl <= self.level:
            print(f"{_COLORS[lvl]}[vieo]{_RESET} {msg}", file=self.sink)
        if file is not None:
            f = self._files.get(file)
            if f is None:
                f = self._files[file] = open(file, "a")
            f.write(msg + "\n")

    def error(self, msg: str, file: str | None = None):
        self._log(LOG_ERROR, msg, file)

    def warn(self, msg: str, file: str | None = None):
        self._log(LOG_WARN, msg, file)

    def info(self, msg: str, file: str | None = None):
        self._log(LOG_INFO, msg, file)

    def debug(self, msg: str, file: str | None = None):
        self._log(LOG_DEBUG, msg, file)

    # -- reporting ---------------------------------------------------------

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

    def format_report(self) -> str:
        """Human table (the stereo_euroc.cc exit report, widened)."""
        lines = [f"{'stage':<28}{'n':>7}{'mean ms':>10}{'max ms':>10}"
                 f"{'total s':>10}"]
        for k, s in sorted(self.stages.items()):
            lines.append(f"{k:<28}{s.count:>7}{1e3 * s.mean:>10.2f}"
                         f"{1e3 * s.max:>10.2f}{s.total:>10.2f}")
        if self.counters:
            lines.append("-- counters --")
            for k, v in sorted(self.counters.items()):
                lines.append(f"{k:<40}{v:>12}")
        return "\n".join(lines)

    def reset(self):
        self.stages.clear()
        self.counters.clear()

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


# process-global registry (mlog's statics)
metrics = Registry()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Device-time profiling of the block: torch.profiler over the host
    and, on a CUDA device, the card, exported as a Chrome trace to
    `log_dir/trace.json` (the port's counterpart of the JAX package's
    xprof directory; open it in chrome://tracing or Perfetto).

    `device` defaults to the GPU and raises without one, like the entry
    points; device="cpu" traces the host alone.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
