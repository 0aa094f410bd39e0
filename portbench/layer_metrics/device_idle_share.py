"""1 - (the union of the device's operation intervals) / wall, over the
profiled sub-window."""

LAYER = "device"
UNIT = "fraction"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(win, log):
    p = win.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
