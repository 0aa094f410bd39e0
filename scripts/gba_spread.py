#!/usr/bin/env python3
"""How far two runs of one global BA drift apart on the GPU.

    python3 scripts/gba_spread.py

Runs the port's stereo_blackout row (chip_smoke.run_row, 60 frames, noise
seed 11, 640 x 480, 600 features, 4 levels: the row's first run),
saves its map, loads it into fresh Systems with every keyframe but the
first moved by 1 cm, and runs run_global_ba on each: the single-device
branch twice (s1, s2) and the distributed branch over 4 shards on the
card twice (d1, d2), in one stage of 25 iterations and in the final GBA's
stages (10, 15), with PyTorch's default algorithms and then under
torch.use_deterministic_algorithms(True).  Prints the ms of each run, the
largest pose differences s1-s2, d1-d2 and s1-d1 (rad, m) and each run's
keyframe ATE.  By default index_add_'s atomic sums take another order on
every run; the spread says how far LM carries that apart.  Needs a GPU.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from vieo_slam_tpu_torch.io.evaluate import ate  # noqa: E402
from vieo_slam_tpu_torch.ops import cuda_build  # noqa: E402
from vieo_slam_tpu_torch.parallel.dist_ba import make_ba_mesh  # noqa: E402
from vieo_slam_tpu_torch.system import System  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("gba_spread: needs a CUDA GPU")
    print(cs.nvidia_smi(), flush=True)
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    run = cs.run_row(torch, dev, "stereo_blackout", 11, width=640,
                     n_features=600, n_levels=4)
    src = run["system"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        src.save_map(path)

        def moved():
            s = System(src.cam, src.bf, src.cfg, device=dev)
            s.load_map(path)
            s.map.kf_tcw[s.map.keyframe_ids()[1:]] += np.float32(0.01)
            return s

        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            for stages in ((25,), (10, 15)):
                out = {}
                for name, distributed in (("s1", False), ("s2", False),
                                          ("d1", True), ("d2", True)):
                    s = moved()
                    if distributed:
                        s.mapper.ba_mesh = make_ba_mesh([dev] * 4)
                    t0 = time.perf_counter()
                    s.mapper.run_global_ba(distributed=distributed,
                                           stage_iters=stages)
                    torch.cuda.synchronize()
                    out[name] = (s.map, 1e3 * (time.perf_counter() - t0))
                kfs = out["s1"][0].keyframe_ids()

                def diff(a, b):
                    ma, mb = out[a][0], out[b][0]
                    return cs.pose_diff(ma.kf_Rcw[kfs], ma.kf_tcw[kfs],
                                        mb.kf_Rcw[kfs], mb.kf_tcw[kfs])

                def kf_ate(m):
                    p = np.stack([-(m.kf_Rcw[k].T @ m.kf_tcw[k])
                                  for k in kfs])
                    return ate(m.kf_timestamp[kfs], p, run["ts"],
                               run["twc"])["rmse"]

                print(f"deterministic {det}, stages {stages}: ms "
                      + ", ".join(f"{k} {v[1]:.1f}" for k, v in out.items())
                      + f"; s1-s2 {diff('s1', 's2')}, d1-d2 "
                      f"{diff('d1', 'd2')}, s1-d1 {diff('s1', 'd1')}; ATE "
                      + ", ".join(f"{k} {kf_ate(v[0]):.6f}"
                                  for k, v in out.items()), flush=True)
    torch.use_deterministic_algorithms(False)


if __name__ == "__main__":
    main()
