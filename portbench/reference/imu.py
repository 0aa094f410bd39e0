"""IMU preintegration between two frames: the VIO reference.

Written from its definition (Forster et al., "On-Manifold Preintegration
for Real-Time Visual-Inertial Odometry", with the midpoint samples the
port's VIO front end integrates), not from the program's code.  Sample k
of the window applies over dt_k with the mean of samples k and k+1 (the
last valid sample with itself), less the bias estimates:

    dp <- dp + dv dt + 1/2 dR a dt^2
    dv <- dv + dR a dt
    dR <- dR Exp(w dt)

The dtype is the caller's: float64 for the reference, float32 under
check.TF32 for the control.
"""

from __future__ import annotations

import torch

from .pose import _rodrigues


def preintegrate(gyro, acc, dt, mask, bg, ba):
    """(dR [3, 3], dv [3], dp [3]) of samples gyro, acc [T, 3] over dt [T]
    (mask [T] marks the valid ones) with biases bg, ba [3]."""
    T = gyro.shape[0]
    nxt = [k + 1 if k + 1 < T and bool(mask[k + 1]) else k for k in range(T)]
    dR = torch.eye(3, dtype=gyro.dtype, device=gyro.device)
    dv = torch.zeros(3, dtype=gyro.dtype, device=gyro.device)
    dp = torch.zeros_like(dv)
    for k in range(T):
        if not bool(mask[k]):
            continue
        h = dt[k]
        w = 0.5 * (gyro[k] + gyro[nxt[k]]) - bg
        a = 0.5 * (acc[k] + acc[nxt[k]]) - ba
        Ra = torch.matmul(dR, a)
        dp = dp + dv * h + 0.5 * Ra * h * h
        dv = dv + Ra * h
        dR = torch.matmul(dR, _rodrigues(w * h))
    return dR, dv, dp
