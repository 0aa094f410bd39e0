"""Mean synchronized time of build_stereo_frame (ORB on both images and
the stereo search) a frame."""

LAYER = "frame build"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(win, log):
    if not win.build_s:
        return None
    return 1e3 * sum(win.build_s) / len(win.build_s)
