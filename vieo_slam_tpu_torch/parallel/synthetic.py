"""Synthetic bundle-adjustment problems for the distributed BA's checks.

`mini_world` is the JAX package's `__graft_entry__._mini_world` (the
dry run's problem); `scaling_problem` is `scripts/scaling_bench.py`'s
`make_problem`, the global-BA problem of the JAX package's scaling and
multi-host harnesses.  Both are made with numpy from a seed and returned
as BAProblem tensors on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cameras import models as cm
from ..math import lie
from ..solvers.local_ba import BAProblem


def _problem(device, **arrays) -> BAProblem:
    return BAProblem(**{k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
                        for k, v in arrays.items()})


def mini_world(n_kf=4, n_lm=64, n_obs=3, seed=0, device="cpu"):
    """(cam, bf, prob): n_kf poses on a short arc, n_lm landmarks, each
    seen by n_obs random poses without pixel noise, the landmarks moved
    by 2 cm."""
    rng = np.random.RandomState(seed)
    cam = cm.make_pinhole(100.0, 100.0, 48.0, 32.0, 96, 64)
    bf = 100.0 * 0.1
    pw = rng.randn(n_lm, 3).astype(np.float32) * [1.0, 0.7, 0.5] + [0, 0, 4.0]
    xi = np.zeros((n_kf, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(n_kf)
    xi[:, 4] = 0.01 * np.arange(n_kf)
    R, t = lie.se3_exp(torch.from_numpy(xi))
    Rcw, tcw = R.numpy(), t.numpy()
    obs_kf = rng.randint(0, n_kf, (n_lm, n_obs)).astype(np.int32)
    pc = np.einsum("moij,mj->moi", Rcw[obs_kf], pw.astype(np.float32)) \
        + tcw[obs_kf]
    obs_uv = cm.project(cam, torch.from_numpy(pc.astype(np.float32))).numpy()
    return cam, bf, _problem(
        device, Rcw=Rcw, tcw=tcw,
        fixed=np.array([True] + [False] * (n_kf - 1)),
        pw=(pw + 0.02 * rng.randn(n_lm, 3)).astype(np.float32),
        lm_valid=np.ones(n_lm, bool), obs_kf=obs_kf, obs_uv=obs_uv,
        obs_ur=np.full((n_lm, n_obs), -1.0, np.float32),
        obs_inv_sigma2=np.ones((n_lm, n_obs), np.float32),
        obs_valid=np.ones((n_lm, n_obs), bool))


def scaling_problem(K=32, M=32768, O=8, seed=0, device="cpu"):
    """(cam, bf, prob): the global-BA problem of the JAX package's
    scaling harness -- K poses on a circle of radius 2 m looking inward,
    M landmarks in an 8 x 8 x 3 m box, each observed by O random poses
    (the observations behind a camera or outside the 640 x 480 image are
    invalid), 0.5 px pixel noise, the positions moved by 1 cm and the
    points by 2 cm; pose 0 fixed."""
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    twc = np.stack([2 * np.cos(ang), 2 * np.sin(ang), np.zeros(K)], -1)
    fwd = -twc / np.linalg.norm(twc, axis=-1, keepdims=True)
    up = np.tile([0.0, 0.0, -1.0], (K, 1))
    right = np.cross(fwd, up)
    down = np.cross(fwd, right)
    Rcw = np.swapaxes(np.stack([right, down, fwd], -1), -1, -2)
    tcw = -np.einsum("kij,kj->ki", Rcw, twc)
    pw = (rng.rand(M, 3) - 0.5) * np.array([8, 8, 3])
    cam = cm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    obs_kf = rng.randint(0, K, (M, O)).astype(np.int32)
    pc = np.einsum("moij,mj->moi", Rcw[obs_kf], pw) + tcw[obs_kf]
    z = np.clip(pc[..., 2], 0.5, None)
    uv = np.stack([400 * pc[..., 0] / z + 320, 400 * pc[..., 1] / z + 240],
                  -1).astype(np.float32)
    valid = (pc[..., 2] > 0.5) & (uv[..., 0] > 0) & (uv[..., 0] < 640) \
        & (uv[..., 1] > 0) & (uv[..., 1] < 480)
    uv = uv + rng.randn(M, O, 2).astype(np.float32) * 0.5
    tcw_n = tcw + rng.randn(K, 3) * 0.01
    pw_n = pw + rng.randn(M, 3) * 0.02
    return cam, 80.0, _problem(
        device, Rcw=Rcw.astype(np.float32), tcw=tcw_n.astype(np.float32),
        fixed=np.arange(K) == 0, pw=pw_n.astype(np.float32),
        lm_valid=np.ones(M, bool),
        obs_kf=np.where(valid, obs_kf, -1).astype(np.int32),
        obs_uv=uv, obs_ur=np.full((M, O), -1.0, np.float32),
        obs_inv_sigma2=np.ones((M, O), np.float32), obs_valid=valid)
