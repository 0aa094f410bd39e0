"""End-to-end demo on the synthetic world: stereo SLAM with loop closing,
the final global BA, trajectory and map export, and the ATE report.

Port of the JAX package's examples/run_synthetic.py: a feature-level
circle (the landmarks' own observations, no rendering) through a System
with a LoopCloser, or through a VioFrontend fed 200 Hz IMU with --vio.
The trajectory (TUM) and the map (npz) go to the temporary directory
(/tmp unless TMPDIR names another), and with --viewer map snapshots to
its vieo_viewer/ folder.

Run: python -m vieo_slam_tpu_torch.examples.run_synthetic [--vio]
     [--frames 140] [--viewer] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..backend.loop_closing import LoopCloser, LoopClosingConfig
from ..cameras import models as cm
from ..frontend.frame import make_frame_from_features
from ..io.evaluate import ate
from ..io.serialization import save_map, write_trajectory_tum
from ..sim.world import (SyntheticWorld, WorldConfig, circle_trajectory,
                         make_imu_samples, trajectory_to_tcw)
from ..system import System, SystemConfig
from ..utils.device import resolve_device
from ..vio.frontend import VioConfig, VioFrontend


def main(argv=None) -> dict:
    """Runs the demo; returns its ATE (rmse, median, ...)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vio", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--frames", type=int, default=140)
    ap.add_argument("--viewer", action="store_true",
                    help="save map snapshots to <tmp>/vieo_viewer/")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tmp = tempfile.gettempdir()

    cam = cm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    bf = 400.0 * 0.2
    world = SyntheticWorld(WorldConfig(n_landmarks=5000, seed=4,
                                       extent=(6.0, 4.5, 3.0)))
    ts = np.arange(args.frames) * 0.1
    Rwc, twc, v_w, a_w = circle_trajectory(ts, radius=1.0, omega=0.35,
                                           look_outward=True)
    Rcw, tcw = trajectory_to_tcw(Rwc, twc)

    sys_ = System(cam, bf, SystemConfig(), device=dev)
    sys_.loop_closer = LoopCloser(cam, bf, sys_.map,
                                  LoopClosingConfig(min_kf_gap=8), device=dev)
    front = sys_
    imu = None
    if args.vio:
        front = VioFrontend(sys_, cfg=VioConfig(init_min_kfs=10,
                                                init_min_span=3.0))
        imu = make_imu_samples(ts, Rwc.astype(np.float64), v_w, a_w,
                               rate_hz=200.0, noise_g=1e-4, noise_a=1e-3)

    viewer = None
    if args.viewer:
        from ..viz import Viewer

        viewer = Viewer(os.path.join(tmp, "vieo_viewer"), every_n_kf=5)

    rng = np.random.RandomState(21)
    t0 = time.time()
    imu_i = 0
    for i in range(args.frames):
        if imu is not None:
            t_imu, gyro, acc = imu
            while imu_i < len(t_imu) and t_imu[imu_i] <= ts[i]:
                front.track_odom(t_imu[imu_i], gyro[imu_i], acc[imu_i])
                imu_i += 1
        obs = world.observe(Rcw[i], tcw[i], cam, bf=bf, n_kp=500,
                            pixel_noise=0.25, bit_flips=4, clutter=40,
                            rng=rng, max_depth=10.0)
        frame = make_frame_from_features(
            obs["uv"], obs["level"], obs["angle"], obs["desc"],
            obs["valid"], ur=obs["ur"], depth=obs["depth"],
            timestamp=ts[i], device=dev)
        st = front.track_frame(frame)
        if viewer is not None:
            viewer.poll(sys_)
        if i % 20 == 0:
            print(f"frame {i:4d} state={st.name} "
                  f"kfs={sys_.map.n_keyframes()} "
                  f"lms={sys_.map.n_landmarks()}", flush=True)
    dt = time.time() - t0
    print(f"tracked {args.frames} frames in {dt:.1f}s "
          f"({dt / args.frames * 1e3:.0f} ms/frame incl. host)")

    sys_.final_global_ba()
    traj_path = os.path.join(tmp, "traj_synthetic.txt")
    map_path = os.path.join(tmp, "map_synthetic.npz")
    write_trajectory_tum(traj_path, sys_.tracker.trajectory)
    save_map(sys_.map, map_path)
    traj = sys_.tracker.trajectory
    t_est = np.asarray([x[0] for x in traj])
    p_est = np.asarray([-(x[1].T @ x[2]) for x in traj])
    res = ate(t_est, p_est, ts, twc)
    loops = sys_.loop_closer.n_loops_closed if sys_.loop_closer else 0
    print(f"ATE rmse={res['rmse']:.4f} m  median={res['median']:.4f} m  "
          f"loops_closed={loops}")
    print(f"trajectory -> {traj_path}, map -> {map_path}")
    return res


if __name__ == "__main__":
    main()
