"""Motion-only pose optimization: the tracking reference.

Written from its definition (ORB-SLAM2's Optimizer::PoseOptimization, the
step the port's tracker takes twice a frame), not from the program's code:
one camera pose Tcw against fixed landmarks.  A stereo observation is the
residual (u, v, u_r) - (u^, v^, u^ - bf / z), a mono one (u, v) - (u^, v^),
with information inv_sigma2 * I and a Huber kernel at the chi-square 95 %
quantile (7.815 for three terms, 5.991 for two).  `rounds` rounds: each
lowers the robust cost over the valid observations still classified as
inliers (all of them in the first), then classifies every valid
observation again as an inlier when its chi2 <= delta^2 and it lies in
front of the camera.  Points within 1 mm of the camera plane take no part.

Each round runs the call's number of Levenberg-Marquardt iterations with
iteratively reweighted Huber weights, as the port's tracker defines its
"plm" mode: each iteration solves (H + lambda I) dx = g for four damping
values a decade apart (0.1, 1, 10 and 100 times lambda) and takes the
one of least robust cost if it lowers the cost; lambda starts at 1e-5
times the largest diagonal entry of the round's first H and becomes the
taken value over 3, or 1000 times itself when no candidate lowers the
cost.  The dtype is the caller's: float64 for the reference, float32
under check.TF32 for the control.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
MIN_DEPTH = 1e-3


def _rodrigues(phi: torch.Tensor) -> torch.Tensor:
    """exp of the skew matrix of phi [3]."""
    theta = torch.sqrt(torch.sum(phi * phi))
    K = torch.zeros(3, 3, dtype=phi.dtype, device=phi.device)
    K[0, 1], K[0, 2], K[1, 2] = -phi[2], phi[1], -phi[0]
    K = K - K.T
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    if float(theta) < 1e-12:
        return eye + K
    a = torch.sin(theta) / theta
    b = (1 - torch.cos(theta)) / (theta * theta)
    return eye + a * K + b * torch.matmul(K, K)


def _terms(R, t, pw, uv, ur, cam, bf):
    """Residuals r [N, 3] (the third zero for mono), Jacobians of the
    prediction d(u^, v^, u_r^)/d(rho, phi) [N, 3, 6] for the update
    p_c <- Exp(phi) p_c + rho, stereo [N] and in-front [N] masks."""
    fx, fy, cx, cy = cam
    pc = torch.matmul(pw, R.T) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    front = z > MIN_DEPTH
    z = torch.where(front, z, torch.ones_like(z))
    u_hat = fx * x / z + cx
    v_hat = fy * y / z + cy
    ur_hat = u_hat - bf / z
    stereo = ur >= 0
    r = torch.stack([uv[:, 0] - u_hat, uv[:, 1] - v_hat,
                     torch.where(stereo, ur - ur_hat,
                                 torch.zeros_like(ur))], dim=1)
    zero = torch.zeros_like(z)
    d_u = torch.stack([fx / z, zero, -fx * x / (z * z)], dim=1)
    d_v = torch.stack([zero, fy / z, -fy * y / (z * z)], dim=1)
    d_ur = d_u + torch.stack([zero, zero, bf / (z * z)], dim=1)
    d_ur = torch.where(stereo[:, None], d_ur, torch.zeros_like(d_ur))
    dproj = torch.stack([d_u, d_v, d_ur], dim=1)               # [N, 3, 3]
    # d p_c / d(rho, phi) = [I | -[p_c]x]
    skew = torch.zeros(pc.shape[0], 3, 3, dtype=pc.dtype, device=pc.device)
    skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -pc[:, 2], pc[:, 1], \
        -pc[:, 0]
    skew = skew - skew.transpose(1, 2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand_as(skew)
    J = torch.matmul(dproj, torch.cat([eye, -skew], dim=2))    # [N, 3, 6]
    return r, J, stereo, front


def _chi2(r, inv_sigma2):
    return torch.sum(r * r, dim=1) * inv_sigma2


def _huber(chi2, delta2):
    return torch.where(chi2 <= delta2, chi2,
                       2 * torch.sqrt(delta2 * chi2) - delta2)


def pose_optimization(R0, t0, pw, uv, ur, inv_sigma2, valid, cam, bf, *,
                      rounds: int, iters: int):
    """(Rcw, tcw) after `rounds` rounds of `iters` iterations from the
    start (R0, t0); cam (fx, fy, cx, cy).  All tensors in the dtype
    wanted."""
    R, t = R0.clone(), t0.clone()
    delta2 = torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO).to(pw.dtype)
    active = valid.clone()

    def cost(R, t, w_on):
        r, _, _, front = _terms(R, t, pw, uv, ur, cam, bf)
        return torch.sum(_huber(_chi2(r, inv_sigma2), delta2)
                         * (w_on & front))

    def system(R, t):
        r, J, _, front = _terms(R, t, pw, uv, ur, cam, bf)
        chi2 = _chi2(r, inv_sigma2)
        huber_w = torch.where(chi2 <= delta2, torch.ones_like(chi2),
                              torch.sqrt(delta2 / chi2.clamp_min(1e-30)))
        w = inv_sigma2 * huber_w * (active & front)
        return (torch.einsum("nri,n,nrj->ij", J, w, J),
                torch.einsum("nri,n,nr->i", J, w, r))

    eye = torch.eye(6, dtype=pw.dtype, device=pw.device)
    for _ in range(rounds):
        c = cost(R, t, active)
        lam = 1e-5 * max(float(torch.diagonal(system(R, t)[0]).max()), 1e-10)
        for _ in range(iters):
            H, g = system(R, t)
            best = None
            for k in (0.1, 1.0, 10.0, 100.0):
                dx = torch.linalg.solve(H + lam * k * eye, g)
                dR = _rodrigues(dx[3:])
                R1 = torch.matmul(dR, R)
                t1 = torch.matmul(dR, t) + dx[:3]
                c1 = cost(R1, t1, active)
                if best is None or c1 < best[0]:
                    best = (c1, R1, t1, lam * k)
            if best[0] < c:
                c, R, t = best[0], best[1], best[2]
                lam = max(best[3] / 3.0, 1e-12)
            else:
                lam *= 1000.0
        r, _, _, front = _terms(R, t, pw, uv, ur, cam, bf)
        active = valid & (_chi2(r, inv_sigma2) <= delta2) & front
    return R, t
