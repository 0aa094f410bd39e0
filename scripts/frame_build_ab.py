#!/usr/bin/env python3
"""Time chip_smoke.py phase 5's frame build of two or more checkouts on one
GPU, in turns.

    python3 scripts/frame_build_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout that holds `chip_smoke.py` and
`vieo_slam_tpu_torch/` (a parent commit is unpacked with `git archive`
into a git-ignored directory).  Every root gets a process of its own,
which builds that checkout's kernels and runs phase 5's measurement: the
30-frame full-width stereo run (752x480, 1200 features, 8 levels) through
`chip_smoke.run_sequence`, then `chip_smoke.split_frame_build` over frames
5-14 (the two extractions and the stereo search, each synchronized).  It
prints the median ms of the frame build, of the two extractions and of
the stereo search, and of the whole frame, beside the card's name and
power limit.  Compare two versions only within one invocation.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from vieo_slam_tpu_torch.ops import cuda_build
cuda_build.build_all()
dev = torch.device("cuda", 0)
system, states, times, res, (cam, bf, cfg, images), _ = cs.run_sequence(
    torch, dev, 752, 1200, 8, 30)
t = 1e3 * np.asarray(times[5:])
ext, ste = cs.split_frame_build(torch, dev, cam, bf, cfg, images[5:15])
print("AB " + json.dumps({"build_ms": float(np.median(t[:, 0])),
                          "extract_x2_ms": ext, "stereo_ms": ste,
                          "frame_ms": float(np.median(t.sum(1))),
                          "lost": sum(s.name == "LOST" for s in states),
                          "ate": float(res["rmse"])}))
"""


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for n, root in enumerate(roots):
        out = subprocess.run([sys.executable, "-c", CHILD],
                             cwd=Path(root).resolve(), capture_output=True,
                             text=True, timeout=900)
        line = next((x for x in out.stdout.splitlines()
                     if x.startswith("AB ")), None)
        if out.returncode != 0 or line is None:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(line[3:])
        print(f"run {n} {root}: frame build {r['build_ms']:.2f} ms (extract "
              f"x2 {r['extract_x2_ms']:.2f}, stereo {r['stereo_ms']:.2f}), "
              f"frame {r['frame_ms']:.2f} ms; LOST {r['lost']}, ATE "
              f"{r['ate']:.5f} m", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
