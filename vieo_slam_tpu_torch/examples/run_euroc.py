"""Run stereo(-VIO) SLAM on a EuRoC sequence directory.

Port of the JAX package's examples/run_euroc.py (the reference's
Examples/Stereo/stereo_euroc.cc): reads the ASL layout with
io/euroc.load_euroc, builds the System and its frame builder from the
settings file with io/config.build_system, builds each stereo frame with
io/config.make_frame_builder as a rectified pair (as the JAX example
does, whatever distortion the file gives: a EuRoC stereo pair is
rectified before it is tracked), feeds the IMU ahead of each frame with
--vio, and writes TUM trajectories before and after the final global BA
(the *_NO_FULLBA.txt A/B outputs).

Run: python -m vieo_slam_tpu_torch.examples.run_euroc <sequence_dir>
     <settings.yaml> [--vio] [--out traj.txt] [--max-frames N]
     [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..io.config import build_system, load_settings, make_frame_builder
from ..io.euroc import load_euroc, load_image_gray
from ..io.serialization import write_trajectory_tum
from ..vio.frontend import VioConfig, VioFrontend


def main(argv=None):
    """Runs the sequence; returns the System."""
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("settings")
    ap.add_argument("--vio", action="store_true")
    ap.add_argument("--out", default="traj.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    seq = load_euroc(args.sequence)
    sys_ = build_system(settings, sensor="stereo", device=args.device)
    dev = sys_.device
    frame_fn = make_frame_builder(
        dataclasses.replace(settings, model="pinhole"), device=dev)

    front = sys_
    if args.vio:
        Rcb = tcb = None
        if settings.Tbc is not None:
            Tcb = np.linalg.inv(settings.Tbc)
            Rcb, tcb = Tcb[:3, :3], Tcb[:3, 3]
        front = VioFrontend(sys_, Rcb=Rcb, tcb=tcb, cfg=VioConfig(
            sigma_g=settings.imu_sigma_g, sigma_a=settings.imu_sigma_a))

    n = len(seq.t_cam) if not args.max_frames else \
        min(args.max_frames, len(seq.t_cam))
    imu_i = 0
    t0 = time.time()
    for i in range(n):
        t = seq.t_cam[i]
        if args.vio:
            while imu_i < len(seq.t_imu) and seq.t_imu[imu_i] <= t:
                front.track_odom(seq.t_imu[imu_i], seq.gyro[imu_i],
                                 seq.acc[imu_i])
                imu_i += 1
        img_l, img_r = (torch.from_numpy(load_image_gray(p)).to(dev)
                        for p in (seq.cam0_paths[i], seq.cam1_paths[i]))
        st = front.track_frame(frame_fn(img_l, img_r, t))
        if i % 50 == 0:
            print(f"frame {i}/{n} state={st.name} "
                  f"kfs={sys_.map.n_keyframes()}", flush=True)
    print(f"done: {n} frames in {time.time() - t0:.1f}s")

    # with/without-full-BA A/B (stereo_euroc.cc): both recovered through
    # each frame's reference keyframe, so the final GBA moves the second
    write_trajectory_tum(args.out.replace(".txt", "_NO_FULLBA.txt"),
                         sys_.trajectory())
    sys_.final_global_ba()
    write_trajectory_tum(args.out, sys_.trajectory())
    print(f"trajectories -> {args.out} (+ _NO_FULLBA A/B)")
    return sys_


if __name__ == "__main__":
    main()
