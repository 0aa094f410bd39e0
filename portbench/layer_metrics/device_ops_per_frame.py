"""Device operations (kernels, copies, fills) a frame in the profiled
sub-window."""

LAYER = "device"
UNIT = "ops/frame"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(win, log):
    p = win.profile
    if p is None or not win.profiled_frames:
        return None
    log(f"device_ops_per_frame: {p['ops']} operations over "
        f"{win.profiled_frames} profiled frames, busy {p['busy_s']:.6f} s "
        f"of {p['window_s']:.6f} s")
    return p["ops"] / win.profiled_frames
