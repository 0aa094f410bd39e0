"""Share of the hand-written kernels' roofline: the summed least times of
the B1-B4 launches in the profiled sub-window, from their shapes and data
(portbench/roofline.py), over their device time in the trace."""

from ..roofline import KERNELS

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(win, log):
    if win.profile is None or not win.bounds:
        return None
    bound_ms = device_ms = 0.0
    for kernel, (calls, b_ms, by) in sorted(win.bounds.items()):
        name = KERNELS[kernel]
        d_ms = 1e3 * sum(s for k, s in win.profile["kernel_s"].items()
                         if name in k)
        n = sum(1 for k in win.profile["kernel_s"] if name in k)
        log(f"kernels_roofline: {kernel} ({name}) {calls} calls, bound "
            f"{b_ms:.6f} ms ({by}), device {d_ms:.6f} ms over {n} names"
            + (f", {100 * b_ms / d_ms:.3f} %" if d_ms > 0 else ""))
        if d_ms > 0:
            bound_ms += b_ms
            device_ms += d_ms
    if device_ms <= 0:
        return None
    return 100.0 * bound_ms / device_ms
