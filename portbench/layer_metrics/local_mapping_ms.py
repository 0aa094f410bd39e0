"""Mean host time of the program's `local_mapping` stage, a keyframe: point
creation, culling and the windowed BA."""

from ._stage import mean_ms

LAYER = "local mapping"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(win, log):
    return mean_ms(win, "local_mapping")
