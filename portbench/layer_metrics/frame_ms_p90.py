"""90th percentile of the time from a frame's hand-over to its pose."""

import statistics

LAYER = "system"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(win, log):
    """Over the frames outside the profiled sub-window."""
    ms = [1e3 * s for s in win.frame_s]
    if len(ms) < 10:
        return None
    p90 = statistics.quantiles(ms, n=10, method="inclusive")[8]
    log(f"frame_ms_p90: {len(ms)} frames, median {statistics.median(ms):.3f}"
        f" ms, p90 {p90:.3f} ms")
    return p90
