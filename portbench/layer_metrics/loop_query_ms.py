"""Mean host time of the program's `loop_closing` stage, a keyframe: the place-
recognition query (and closing, where one closes)."""

from ._stage import mean_ms

LAYER = "loop closing"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(win, log):
    return mean_ms(win, "loop_closing")
