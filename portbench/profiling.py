"""What the profiler's trace of the profiled sub-window says.

A reduction of torch.profiler's events (the method of chip_smoke.py's
`summarize_profile`, copied): the device's busy time as the union of its
operations' intervals, the device operations, each kernel's device time,
the operations that took the most device time, and the idle gaps of the
device by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench."
WINDOW_SPAN = SPAN_PREFIX + "window"


def _is_device(e) -> bool:
    return "cuda" in str(getattr(e, "device_type", "")).lower()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(prof, top: int = 10) -> dict | None:
    """{window_s, busy_s, ops, kernel_s {name: s}, device_ops [[name, s]],
    idle_gaps [[host op, s]]} of the profiled window (marked by a
    WINDOW_SPAN range); None where the trace holds no device operation."""
    events = prof.events()
    win = next((e for e in events if e.name == WINDOW_SPAN
                and not _is_device(e)), None)
    if win is None:
        return None
    w0, w1 = win.time_range.start, win.time_range.end
    dev = [e for e in events if _is_device(e)
           and not e.name.startswith(SPAN_PREFIX)
           and e.time_range.end > w0 and e.time_range.start < w1]
    if not dev:
        return None
    merged = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                     for e in dev])
    busy_us = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
    # The host's innermost operation at the middle of each idle gap.
    host = sorted((e for e in events if not _is_device(e)
                   and e.name != WINDOW_SPAN),
                  key=lambda e: e.time_range.start)
    gaps = []
    prev = w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gap_by = defaultdict(float)
    starts = [e.time_range.start for e in host]
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid)
        best = None
        # Scan back over the operations that started before the middle;
        # the innermost one covering it is the shortest.
        for e in reversed(host[max(0, k - 400):k]):
            if e.time_range.end >= mid and (
                    best is None or e.time_range.elapsed_us()
                    < best.time_range.elapsed_us()):
                best = e
        gap_by[best.name if best is not None else "(no host op)"] += b - a
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "ops": len(dev),
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "device_ops": [[k, v / 1e6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(
            gap_by.items(), key=lambda kv: -kv[1])[:top]],
    }
