"""Trajectory evaluation: ATE with SE3/Sim3 alignment.

Equivalent of the TUM rgbd_benchmark_tools `evaluate_ate.py` pipeline the
reference uses (Examples/RunEuRoC/EvaluateEuRoC_Evaluate.sh:38-56), as a
library function: associate by timestamp, Umeyama alignment (optionally
with scale, for monocular), RMSE/median/max of translational error.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=False):
    """Least-squares similarity transform aligning src -> dst ([N, 3]):
    (scale, R, t); the scale is 1 unless with_scale."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    return float(s), R, mu_d - s * R @ mu_s


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt=0.02):
    """Nearest-timestamp association; returns index pairs."""
    j = np.searchsorted(t_b, t_a)
    j0 = np.clip(j - 1, 0, len(t_b) - 1)
    j1 = np.clip(j, 0, len(t_b) - 1)
    pick = np.where(
        np.abs(t_b[j1] - t_a) < np.abs(t_b[j0] - t_a), j1, j0)
    ok = np.abs(t_b[pick] - t_a) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def ate(t_est, p_est, t_gt, p_gt, *, with_scale=False, max_dt=0.02):
    """Absolute trajectory error after alignment.

    Returns dict(rmse, mean, median, max, n, scale).
    """
    ia, ib = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ia) < 3:
        return dict(rmse=np.inf, mean=np.inf, median=np.inf, max=np.inf,
                    n=len(ia), scale=1.0)
    src = np.asarray(p_est)[ia]
    dst = np.asarray(p_gt)[ib]
    s, R, t = umeyama_alignment(src, dst, with_scale)
    aligned = s * src @ R.T + t
    err = np.linalg.norm(aligned - dst, axis=1)
    return dict(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        n=len(err),
        scale=float(s),
    )
