#!/usr/bin/env python3
"""Run the port's place-recognition rows on one GPU at a chosen size and
break their keyframe ATE down.

    python3 scripts/place_recognition_rows.py [--width 752 --features 1200
        --levels 8] [--rows stereo_blackout,stereo_loop]

The rows are chip_smoke.py's phases 9 and 10 (the stereo_blackout and
stereo_loop rows of the port's evaluate_ntimes.py, driven frame by frame
through its Row); at --width 640
--features 600 --levels 4 they run at the JAX package's own row
configuration.  For the blackout row the keyframes before the blackout
are aligned to the ground truth alone, and the keyframes after the
recovery are scored both in that alignment and in their own; every
keyframe's position error in the whole-run alignment is printed, and for
each successful relocalization the error of its coarse (RANSAC) and
refined pose against the true pose in the map's frame (keyframe 0's
camera), with its match and inlier counts.  For the
loop row: the keyframe ATE before and after each closure and without and
with the final global BA.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.examples.evaluate_ntimes import (  # noqa: E402
    LOOP_FRAMES_PER_LAP, Row)
from vieo_slam_tpu_torch.io.evaluate import associate, umeyama_alignment  # noqa: E402
from vieo_slam_tpu_torch.utils.device import nvidia_smi  # noqa: E402
from vieo_slam_tpu_torch.utils.metrics import metrics  # noqa: E402

# Noise seeds of chip_smoke.py's phase 9: 0, and 11 (the rows' first run).
PLACE_SEEDS = (0, 11)


def kf_positions(system):
    m = system.map
    kfs = m.keyframe_ids()
    p = np.stack([-(m.kf_Rcw[k].T @ m.kf_tcw[k]) for k in kfs])
    return m.kf_timestamp[kfs], p


def aligned_errors(t_kf, p_kf, ts, p_gt, fit):
    """Position error of every keyframe after aligning the keyframes where
    `fit` (a mask over them) holds to the ground truth."""
    ia, ib = associate(t_kf, ts)
    err = np.full(len(t_kf), np.nan)
    if fit[ia].sum() < 3:
        return err
    src, dst = p_kf[ia], p_gt[ib]
    s, R, t = umeyama_alignment(src[fit[ia]], dst[fit[ia]], False)
    err[ia] = np.linalg.norm(s * src @ R.T + t - dst, axis=1)
    return err


def rms(x):
    return float(np.sqrt(np.nanmean(np.square(x))))


def trace_relocalization():
    """Record, per relocalization candidate that passes RANSAC, the coarse
    pose, its inlier count, the harvested matches and the refined pose."""
    from vieo_slam_tpu_torch.frontend import relocalization as rl

    log = []
    pnp3, pnp, popt = rl.pnp_ransac_3d3d, rl.pnp_ransac, rl.pose_optimization

    def coarse(fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            if bool(res.ok):
                log.append(dict(coarse=(res.Rcw.cpu().numpy(),
                                        res.tcw.cpu().numpy()),
                                n_coarse=int(res.n_inliers)))
            return res
        return wrapped

    def refine(R, t, obs, *a, **kw):
        res = popt(R, t, obs, *a, **kw)
        log[-1].update(refined=(res.Rcw.cpu().numpy(), res.tcw.cpu().numpy()),
                       n_harvest=int(obs.valid.sum()),
                       n_refined=int(res.n_inliers))
        return res

    rl.pnp_ransac_3d3d, rl.pnp_ransac = coarse(pnp3), coarse(pnp)
    rl.pose_optimization = refine
    return log


def pose_error(R, t, Rg, tg):
    """(camera position error in m, rotation error in rad)."""
    c, cg = -R.T @ t, -Rg.T @ tg
    ang = np.arccos(np.clip((np.trace(R @ Rg.T) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.linalg.norm(c - cg)), float(ang)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--rows", default="stereo_blackout,stereo_loop")
    ap.add_argument("--seeds", default=",".join(
                        str(x) for x in PLACE_SEEDS),
                    help="noise seeds, comma-separated (the JAX package's "
                         "evaluate_ntimes.py runs 11, 18, 25)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("place_recognition_rows: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    size = (f"{args.width}x480, {args.features} features, {args.levels} "
            f"levels")
    relocs = trace_relocalization()
    for row, seed in ((r, int(x)) for r in args.rows.split(",")
                      for x in args.seeds.split(",")):
        relocs.clear()
        n = 2 * LOOP_FRAMES_PER_LAP if row.endswith("_loop") else 60
        run = Row(row, seed, n, dev, args.width, args.features, args.levels)
        recovered_at = None
        for i in range(n):
            before = metrics.counters.get("reloc_success", 0)
            run.step(i)
            if recovered_at is None and \
                    metrics.counters.get("reloc_success", 0) > before:
                recovered_at = i
        out = run.finish()
        system, states, ts = run.system, run.states, run.sc.ts
        Rcw, tcw, twc = run.Rcw, run.tcw, run.sc.twc
        t_kf, p_kf = kf_positions(system)
        whole = aligned_errors(t_kf, p_kf, ts, twc,
                               np.ones(len(t_kf), bool))
        print(f"{row} at {size}, seed {seed}: LOST {states.count('LOST')}, "
              f"relocalizations {run.counter('reloc_success'):.0f}, loops "
              f"{system.loop_closer.n_loops_closed}, fused "
              f"{system.loop_closer.total_fuse_count}, "
              f"{len(t_kf)} keyframes; keyframe ATE without / with the "
              f"final GBA {out['rmse_noFullBA']:.5f} / "
              f"{out['rmse_fullBA']:.5f} m",
              flush=True)
        if row == "stereo_blackout":
            b0, b1 = run.sc.bo
            pre = t_kf < ts[b0]
            post = t_kf > ts[b1]
            in_pre = aligned_errors(t_kf, p_kf, ts, twc, pre)
            own = aligned_errors(t_kf, p_kf, ts, twc, post)
            i = recovered_at
            if i is not None:
                # the true pose of the recovery frame in keyframe 0's frame
                Rg = Rcw[i] @ Rcw[0].T
                tg = tcw[i] - Rg @ tcw[0]
                for r in relocs:            # up to the recovery
                    if "refined" in r:
                        ec = pose_error(*r["coarse"], Rg, tg)
                        ef = pose_error(*r["refined"], Rg, tg)
                        print(f"  relocalization candidate: coarse "
                              f"{r['n_coarse']} inliers, error {ec[0]:.4f} "
                              f"m {ec[1]:.4f} rad; {r['n_harvest']} "
                              f"harvested, refined {r['n_refined']} inliers, "
                              f"error {ef[0]:.4f} m {ef[1]:.4f} rad "
                              f"(against frame {i})")
                        if r["n_refined"] >= 20:
                            break
            traj = system.tracker.trajectory
            errs = []
            for j in range(max(b0 - 3, 0), len(traj)):
                Rg = Rcw[j] @ Rcw[0].T
                tg = tcw[j] - Rg @ tcw[0]
                e = pose_error(traj[j][1], traj[j][2], Rg, tg)
                errs.append(f"{j} {traj[j][3][0]} {e[0]:.4f} {e[1]:.4f}")
            print("  per frame: index, state, camera error in keyframe 0's "
                  "frame (m, rad), as tracked: " + ", ".join(errs))
            print(f"  recovered at frame {recovered_at}; keyframe "
                  f"ATE before the blackout {rms(in_pre[pre]):.5f} m; after "
                  f"the recovery, aligned alone {rms(own[post]):.5f} m, in "
                  f"the pre-blackout alignment {rms(in_pre[post]):.5f} m")
        for k, c, a, b in run.lc_events:
            print(f"  closure keyframe {k} to {c}: keyframe ATE "
                  f"{a:.5f} -> {b:.5f} m")
        print("  keyframe time, error in the whole-run alignment (m): "
              + ", ".join(f"{t:.1f} {e:.4f}" for t, e in zip(t_kf, whole)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
