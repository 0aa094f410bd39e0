#!/usr/bin/env python3
"""Time each frame of one row of the port's evaluate_ntimes.py on one GPU
by tracking state.

    python3 scripts/row_states.py --row stereo_lem --seed 11

Runs the row at its own size (640x480, its features and levels) frame by
frame through evaluate_ntimes.Row, each frame (render, build, track)
between device syncs, and prints: the card's name and power limit, the
seconds of the frames and the state of every frame as one string (. OK,
L LOST, o ODOMOK, n not initialized), the count and median ms of the
frames in each state, the stage report (utils/metrics.format_report),
the row's numbers, and
torch.profiler's top host and device entries over three frames from the
twentieth LOST frame on (when the row has one).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev  # noqa: E402
from vieo_slam_tpu_torch.ops import cuda_build  # noqa: E402
from vieo_slam_tpu_torch.utils.device import nvidia_smi  # noqa: E402
from vieo_slam_tpu_torch.utils.metrics import metrics  # noqa: E402

LETTER = {"OK": ".", "LOST": "L", "ODOMOK": "o", "NOT_INITIALIZED": "n"}
PROFILE_AT_LOST = 20      # profile from this LOST frame on, three frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", default="stereo_lem")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_states: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    cuda_build.build_all(verbose=False)
    dev = torch.device("cuda", 0)
    n = 2 * ev.LOOP_FRAMES_PER_LAP \
        if args.row.endswith(("_loop", "_lem")) else 60
    metrics.reset()
    row = ev.Row(args.row, args.seed, n, dev)
    states, times, prof, first = [], [], None, None
    for i in range(n):
        if prof is None and states.count("LOST") == PROFILE_AT_LOST:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            first = i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states.append(row.step(i).name)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if first is not None and i == first + 2:
            prof.__exit__(None, None, None)
            window = states[first:i + 1]
    numbers = row.finish()
    print(f"{args.row} seed {args.seed}, {n} frames in "
          f"{sum(times):.1f} s: " + "".join(LETTER[s] for s in states))
    st, ts = np.asarray(states), 1e3 * np.asarray(times)
    for s in LETTER:
        if (st == s).any():
            print(f"  {s}: {(st == s).sum()} frames, median "
                  f"{np.median(ts[st == s]):.2f} ms, first at frame "
                  f"{int(np.argmax(st == s))}")
    print(metrics.format_report())
    print(numbers)
    if first is not None:
        ka = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in ka)
        host_us = sum(e.self_cpu_time_total for e in ka)
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        print(f"frames {first}-{first + 2} ({window}) under torch.profiler: "
              f"{launches} kernel launches, host {1e-3 * host_us:.1f} ms, "
              f"device {1e-3 * dev_us:.1f} ms")
        print(ka.table(sort_by="cpu_time_total", row_limit=15,
                       max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
