#!/usr/bin/env python3
"""Time the port's hand-written kernels of two or more checkouts on one
GPU, in turns, at the main-path shapes of chip_smoke.py phase 3.

    python3 scripts/compare_port_kernels.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout that holds `chip_smoke.py` and
`vieo_slam_tpu_torch/` (a parent commit is unpacked with `git archive`
into a git-ignored directory).  Every root gets a process of its own,
which builds that checkout's kernels, runs `chip_smoke.check_kernels`
(every kernel is first held against its plain version) and prints per
kernel the time of a wrapper call (CUDA events) and the time inside the
CUDA kernels (torch.profiler).  Compare two versions only within one
invocation: two invocations may land on two cards.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
rows = chip_smoke.check_kernels(torch, torch.device("cuda", 0))
keep = ("ms", "device_ms", "pair_ms", "pair_device_ms", "plain_ms")
print("ROWS " + json.dumps({k: {x: r[x] for x in keep if x in r}
                            for k, r in rows.items()}))
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
                     if x.startswith("ROWS ")), None)
        if out.returncode != 0 or line is None:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        for k, r in json.loads(line[5:]).items():
            print(f"run {n} {root} {k}: " + ", ".join(
                f"{x} {'not measured' if v is None else format(v, '.4f')}"
                for x, v in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
