"""A stage timer's mean over the frames that the profiler did not see."""


def mean_ms(win, stage: str):
    """Mean ms a call of `stage` (utils.metrics' host timer) in the window's
    unprofiled part; None where it never ran."""
    n, total = win.unprofiled["stages"].get(stage, (0, 0.0))
    return 1e3 * total / n if n else None
