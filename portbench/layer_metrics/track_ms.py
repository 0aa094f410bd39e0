"""Mean host time of the program's `track` stage, a frame: the tracker's two-
stage association and pose optimization."""

from ._stage import mean_ms

LAYER = "tracking"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(win, log):
    return mean_ms(win, "track")
