#!/usr/bin/env python3
"""Run the port's async-mapping, VIO, encoder, multi-camera and map-reuse
rows on one GPU and hold their means against the JAX package's
ACCURACY_r05.json.

    python3 scripts/vio_rows.py [--width 640 --features N --levels 4]
        [--rows stereo_async,stereo_vio,vio_blackout,vio_loop]
        [--seeds 11,18,25] [--out FILE]

    python3 scripts/vio_rows.py \
        --rows veo,vieo,multicam_kb8,multicam4_kb8,map_reuse

The rows are the port's evaluate_ntimes.py, run through its run_once
(phases 11-20 of chip_smoke.py run them at 752x480, 1200 features, 8
levels); the defaults are the JAX package's own row configuration and
seeds (seed0 11 + 7 i), 360 frames for a loop or figure-eight row and 60
otherwise, and each row's own feature count (1000 for mono and mono_loop,
600 otherwise) unless --features sets one for all.  Each row reports
what evaluate_ntimes.py does: the keyframe ATE without and with the
final global BA, the LOST, ODOMOK and relocalization counts and the
keyframe ATE after the recovery (blackout, map reuse), the loops closed,
the fused points and the keyframe ATE before and after the first closure
(loop), the LOST and relocalization counts (figure-eight), and each
partner view's triangulations a frame and mean squared two-view error
(multi-camera), beside the seconds of the run.  A mean agrees with the
reference when its ATEs are within 30 % or 1 mm of it (whichever is
larger), its LOST frames within 30 % or one, its triangulation counts
within 30 % and its other counts within one.  Prints the card's name and
power limit first; with --out, writes every run's numbers there as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.examples import evaluate_ntimes  # noqa: E402
from vieo_slam_tpu_torch.utils.device import nvidia_smi  # noqa: E402

ATE_KEYS = ("rmse_noFullBA", "rmse_fullBA", "rmse_postRecovery",
            "rmse_preLC", "rmse_postLC")
COUNT_KEYS = ("n_odomok", "n_relocs", "loops_closed")
TRI_KEYS = tuple(f"view{v}_tri_per_frame" for v in (1, 2, 3))


def verdict(mean: dict, ref: dict) -> list:
    """(key, port mean, reference, agrees) for every key both carry."""
    rows = []
    for k, v in mean.items():
        want = ref.get("avg_" + k)
        if want is None:
            continue
        if k in ATE_KEYS and np.isnan(want):
            ok = bool(np.isnan(v))      # no closure in either (loop rows)
        elif k in ATE_KEYS:
            ok = abs(v - want) <= max(0.3 * want, 1e-3)
        elif k in TRI_KEYS:
            ok = abs(v - want) <= 0.3 * want
        elif k in COUNT_KEYS:
            ok = abs(v - want) <= 1.0
        elif k == "n_lost":
            ok = abs(v - want) <= max(0.3 * want, 1.0)
        else:
            ok = None
        rows.append((k, v, want, ok))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--features", type=int, default=None,
                    help="features for every row (default: each row's own)")
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--rows",
                    default="stereo_async,stereo_vio,vio_blackout,vio_loop")
    ap.add_argument("--seeds", default="11,18,25")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vio_rows: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    ref = json.loads((ROOT / "ACCURACY_r05.json").read_text())["scenarios"]
    features = "the row's own" if args.features is None else args.features
    size = f"{args.width}x480, {features} features, {args.levels} levels"
    report = {"card": smi, "size": size, "runs": {}, "means": {}}
    all_ok = True
    for row in args.rows.split(","):
        runs = []
        n = 2 * evaluate_ntimes.LOOP_FRAMES_PER_LAP \
            if row.endswith(("_loop", "_lem")) else 60
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = evaluate_ntimes.run_once(
                row, seed, n, device=dev, width=args.width,
                n_features=args.features, n_levels=args.levels)
            r["seconds"] = time.perf_counter() - t0
            runs.append(r)
            print(f"{row} seed {seed} at {size}: "
                  + ", ".join(f"{k} {v:.5g}" for k, v in r.items()),
                  flush=True)
        mean = {k: float(np.nanmean([r.get(k, np.nan) for r in runs]))
                for k in dict.fromkeys(k for r in runs for k in r)}
        report["runs"][row], report["means"][row] = runs, mean
        for k, v, want, ok in verdict(mean, ref.get(row, {})):
            all_ok &= ok is not False
            print(f"  {row} mean {k}: port {v:.5g}, ACCURACY_r05 {want:.5g}"
                  f" -> {'agrees' if ok else 'DIFFERS' if ok is False else ''}",
                  flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"all rows agree with ACCURACY_r05: {all_ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
