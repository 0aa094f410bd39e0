"""Mean host time of the program's `vio.fuse` stage, a fused frame: the joint
visual-inertial pose solve, replayed from CUDA graphs."""

from ._stage import mean_ms

LAYER = "VIO"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(win, log):
    return mean_ms(win, "vio.fuse")
