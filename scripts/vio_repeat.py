#!/usr/bin/env python3
"""Run one row of the port's evaluate_ntimes.py several times at one seed
on one GPU, at 752x480, 1200 features and 8 levels,
first as the port runs by default and then under
torch.use_deterministic_algorithms, and report whether repeated runs
agree.

    python3 scripts/vio_repeat.py [--row stereo_vio] [--seed 0]
        [--runs 2] [--out FILE]

Each run reports the keyframe ATE without the final global BA (the bar
of chip_smoke.py's phase 12), the ATE of the tracked frames, the VI init
frame, |g| and the gyro bias, and a digest of every tracked pose and
keyframe pose, bit for bit: two runs with one digest computed the same
trajectory.  The deterministic runs set warn_only, so an operator without
a deterministic implementation on the card still runs; the warnings it
gives are listed.  CUBLAS_WORKSPACE_CONFIG is set for the whole process
(before CUDA starts), as deterministic cuBLAS needs.  Prints the card's
name and power limit first; with --out, writes the numbers there as
JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.examples.evaluate_ntimes import (  # noqa: E402
    LOOP_FRAMES_PER_LAP, Row)
from vieo_slam_tpu_torch.io.evaluate import ate  # noqa: E402
from vieo_slam_tpu_torch.utils.device import nvidia_smi  # noqa: E402


def run(row: str, seed: int, dev) -> dict:
    """One run of the row at full width: the system and its front end,
    the states, the VI init frame, the keyframe ATE without the final
    global BA, the ATE of the tracked frames and the seconds of the run."""
    n = 2 * LOOP_FRAMES_PER_LAP if row.endswith("_loop") else 60
    r = Row(row, seed, n, dev, 752, 1200, 8)
    init_at, t0 = None, time.perf_counter()
    for i in range(n):
        r.step(i)
        if init_at is None and getattr(r.front, "inited", False):
            init_at = i
    r.system.wait_idle()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    numbers = r.finish()
    traj = r.system.tracker.trajectory
    poses = np.asarray([-(R.T @ t) for _, R, t, _ in traj])
    return dict(system=r.system, front=r.front, states=r.states,
                init_at=init_at, run_s=run_s,
                ate_no_gba=numbers["rmse_noFullBA"],
                ate_track=ate(np.asarray([x[0] for x in traj]), poses,
                              r.sc.ts, r.sc.twc)["rmse"])


def digest(out) -> str:
    system = out["system"]
    h = hashlib.sha256()
    for _, R, t, _ in system.tracker.trajectory:
        h.update(np.ascontiguousarray(R, np.float32).tobytes())
        h.update(np.ascontiguousarray(t, np.float32).tobytes())
    m = system.map
    for k in m.keyframe_ids():
        h.update(np.ascontiguousarray(m.kf_Rcw[k], np.float32).tobytes())
        h.update(np.ascontiguousarray(m.kf_tcw[k], np.float32).tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", default="stereo_vio")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("vio_repeat: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    from vieo_slam_tpu_torch.ops import cuda_build

    cuda_build.build_all(verbose=False)
    results = []
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        for i in range(a.runs):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = run(a.row, a.seed, dev)
            vio = out["front"]
            r = dict(mode=mode, run=i, ate_kf=float(out["ate_no_gba"]),
                     ate_track=float(out["ate_track"]),
                     init_at=out["init_at"],
                     g=float(np.linalg.norm(vio.gw)) if vio is not
                     out["system"] else None,
                     bg=[float(x) for x in vio.bg] if vio is not
                     out["system"] else None,
                     lost=out["states"].count("LOST"),
                     digest=digest(out), run_s=float(out["run_s"]),
                     warnings=sorted({str(w.message).split("\n")[0][:160]
                                      for w in caught
                                      if "determinis" in str(w.message)}))
            results.append(r)
            print(json.dumps(r), flush=True)
    for mode in ("default", "deterministic"):
        ds = [r["digest"] for r in results if r["mode"] == mode]
        ates = [r["ate_kf"] for r in results if r["mode"] == mode]
        print(f"{mode}: {len(set(ds))} distinct trajectories in {len(ds)} "
              f"runs; keyframe ATE {ates}", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
