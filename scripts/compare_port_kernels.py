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
invocation: two invocations may land on two cards.  Each process also
extracts ORB features of three stereo pairs at the full-width and the
known configuration, and the script says whether every root's features
equal the first root's bit for bit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
rows = chip_smoke.check_kernels(torch, torch.device("cuda", 0))
keep = ("ms", "device_ms", "pair_ms", "pair_device_ms", "library_ms",
        "plain_ms")
print("ROWS " + json.dumps({k: {x: r[x] for x in keep if x in r}
                            for k, r in rows.items()}))
from vieo_slam_tpu_torch.ops import orb
feats = []
for width, n_features, n_levels in ((752, 1200, 8), (640, 600, 4)):
    cam, _, world, _, Rcw, tcw, _ = chip_smoke.scene(3, width)
    cfg = orb.OrbConfig(n_features=n_features, n_levels=n_levels)
    for i in range(3):
        pair = torch.stack([torch.from_numpy(x) for x in world.render_stereo(
            cam, Rcw[i], tcw[i], chip_smoke.BASELINE)]).cuda()
        feats += [x.cpu() for x in orb.extract_orb_batch(pair, cfg)]
torch.save(feats, sys.argv[1])
"""


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        for n, root in enumerate(roots):
            feats = str(Path(tmp) / f"features_{n}.pt")
            out = subprocess.run([sys.executable, "-c", CHILD, feats],
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
            got = torch.load(feats)
            first = first or got
            print(f"run {n} {root} features of 6 stereo pairs: "
                  + ("bit-equal to run 0's" if all(
                      torch.equal(a, b) for a, b in zip(got, first))
                     else "DIFFER from run 0's"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
