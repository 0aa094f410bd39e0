#!/usr/bin/env python3
"""Count the tensor operators the port's VIO solvers dispatch, on the CPU.

    python3 scripts/count_vio_ops.py

On a GPU each compute operator is one kernel launch, so these counts are
the launches a call costs when it runs as plain calls (the VIO front end
replays the fused solve and a frame's preintegration, and the window BA
its chain blocks, from CUDA graphs instead).  Counted: every ATen operator
but views.  Inputs are synthetic (seed 0); the counts depend on the
shapes and the iteration counts only.  No device time comes from here.
"""

from __future__ import annotations

import collections
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.cameras import models as cm  # noqa: E402
from vieo_slam_tpu_torch.math.navstate import NavState  # noqa: E402
from vieo_slam_tpu_torch.math.preintegration import (  # noqa: E402
    EncPreint, preintegrate_imu)
from vieo_slam_tpu_torch.solvers.motion_ba import PoseObs  # noqa: E402
from vieo_slam_tpu_torch.solvers.vio_ba import (  # noqa: E402
    vio_pose_optimization)
from vieo_slam_tpu_torch.solvers.vio_local_ba import (  # noqa: E402
    VioBAConfig, VioBAProblem, vio_ba)

VIEWS = {"slice", "select", "expand", "view", "unsqueeze", "transpose", "t",
         "alias", "as_strided", "squeeze", "permute", "_unsafe_view",
         "detach", "lift_fresh", "reshape"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))

    def compute(self) -> int:
        return sum(n for k, n in self.ops.items() if k not in VIEWS)


def counted(fn):
    with Count() as c:
        fn()
    return c.compute()


def main():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    z3 = torch.zeros(3)

    def imu(shape, T):
        return (t(rng.randn(*shape, T, 3) * 0.3),
                t(rng.randn(*shape, T, 3) + [0, 0, 9.81]),
                torch.full(shape + (T,), 0.005))

    for shape, T in (((), 21), ((10,), 80)):
        g, a, d = imu(shape, T)
        n = counted(lambda: preintegrate_imu(g, a, d, z3, z3, 1.7e-4, 2e-3))
        print(f"preintegrate_imu, windows {shape or 1} x {T} samples: {n} "
              f"operators, {n / T:.1f} a sample")

    cam = cm.make_pinhole(470.0, 470.0, 376.0, 240.0, 752, 480)
    g, a, d = imu((), 21)
    pre = preintegrate_imu(g, a, d, z3, z3, 1.7e-4, 2e-3)
    ns = NavState.identity()
    N = 4096
    pw = t(np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 6, N)])
    obs = PoseObs(pw=pw, uv=cm.project(cam, pw), ur=torch.full((N,), -1.0),
                  inv_sigma2=torch.ones(N), valid=torch.ones(N, dtype=bool))
    n = counted(lambda: vio_pose_optimization(
        ns, ns, pre, obs, cam, torch.eye(3), z3, 94.0,
        prior_info=torch.eye(15), last_fixed=False))
    print(f"vio_pose_optimization, {N} observations, 4 x 8 LM iterations: "
          f"{n} operators")

    K, M, O, C = 12, 1024, 8, 10
    g, a, d = imu((C,), 80)
    pre = preintegrate_imu(g, a, d, z3, z3, 1.7e-4, 2e-3)
    obs_kf = np.where(rng.rand(M, O) < 0.5, rng.randint(0, K, (M, O)), -1)
    prob = VioBAProblem(
        ns=NavState.identity((K,)), fixed_pr=torch.arange(K) == 0,
        fixed_vb=torch.arange(K) == 0, pw=pw[:M],
        lm_valid=torch.ones(M, dtype=bool),
        obs_kf=torch.from_numpy(obs_kf), obs_uv=t(rng.rand(M, O, 2) * 400),
        obs_ur=torch.full((M, O), -1.0), obs_inv_sigma2=torch.ones(M, O),
        obs_valid=torch.from_numpy(obs_kf >= 0), chain_i=torch.arange(C),
        chain_j=torch.arange(1, C + 1), chain_valid=torch.ones(C, dtype=bool),
        chain_weight=torch.ones(C), imu_pre=pre,
        enc_pre=EncPreint(torch.eye(3).expand(C, 3, 3), torch.zeros(C, 3),
                          torch.eye(6).expand(C, 6, 6), torch.zeros(C)),
        enc_valid=torch.zeros(C, dtype=bool), prior_idx=C,
        prior_info6=torch.ones(6))
    cfg = VioBAConfig(Rcb=torch.eye(3), tcb=z3, bf=torch.tensor(94.0),
                      gravity=torch.tensor([0.0, 0.0, -9.81]))
    n = counted(lambda: vio_ba(prob, cam, cfg, stage_iters=(4, 6)))
    print(f"vio_ba window, {K} keyframes, {C} chains, 4 + 6 iterations: {n} "
          f"operators")
    return 0


if __name__ == "__main__":
    sys.exit(main())
