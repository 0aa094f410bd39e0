"""Visual-inertial initialization: gyro bias, scale, gravity, velocities.

Port of vieo_slam_tpu/vio/initialization.py: the gyro-bias Gauss-Newton
over the keyframe rotations, re-preintegration at the solved bias (all
windows in one batched preintegration), one dense least-squares for
[scale, gravity, every keyframe velocity], and the refinement that
enforces |g| = G and solves the accelerometer bias.  The linear systems
are filled with direct index writes into A and b.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..math import lie
from ..math.lie import mv as _mv
from ..math.preintegration import ImuPreint, preintegrate_imu

G_MAG = 9.810


class VioInit(NamedTuple):
    bg: torch.Tensor       # [3] gyro bias
    ba: torch.Tensor       # [3] accel bias
    scale: torch.Tensor    # scalar (1 for stereo / RGB-D)
    gw: torch.Tensor       # [3] gravity in the world frame
    v: torch.Tensor        # [N, 3] keyframe body velocities
    cond: torch.Tensor     # conditioning of the linear solves


def solve_gyro_bias(R_wb: torch.Tensor, pre: ImuPreint, *, iters: int = 4):
    """Minimize sum_i || Log((dR_i Exp(Jg_i bg))^T R_i^T R_{i+1}) ||^2 over
    bg.  R_wb [N, 3, 3]; pre: the N - 1 consecutive preintegrations, at
    bg = 0."""
    dR_vis = R_wb[:-1].transpose(-1, -2) @ R_wb[1:]

    def residual(bg):
        corr = pre.dR @ lie.so3_exp(torch.einsum("nij,j->ni", pre.Jg_R, bg))
        return lie.so3_log(corr.transpose(-1, -2) @ dR_vis).reshape(-1)

    bg = torch.zeros(3, dtype=R_wb.dtype, device=R_wb.device)
    eye = torch.eye(3, dtype=R_wb.dtype, device=R_wb.device)
    for _ in range(iters):
        r = residual(bg)
        J = jacfwd(residual)(bg)
        bg = bg - torch.linalg.solve_ex(J.T @ J + 1e-9 * eye, J.T @ r)[0]
    return bg


def _lstsq(A, b):
    """Least-squares solution of A x = b through the SVD, singular values
    below eps * max(A.shape) of the largest dropped (numpy's and the JAX
    package's lstsq rule), and the condition number of A."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = S > torch.finfo(A.dtype).eps * max(A.shape) * S[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    sol = Vh.transpose(-1, -2) @ (s_inv * (U.transpose(-1, -2) @ b))
    return sol, S[0] / torch.clamp_min(S[-1], 1e-12)


def linear_alignment(t_kf, R_wb, p_wc, R_wc, pcb, pre: ImuPreint, *,
                     solve_scale: bool = True):
    """One least-squares for [scale, gw, v_0..v_{N-1}].  For each
    consecutive pair (dt, dv, dp), with p_wb = s p_wc + R_wc pcb:
       s (pc_j - pc_i) + (Rwc_j - Rwc_i) pcb = v_i dt + .5 gw dt^2 + Rwb_i dp
       v_j - v_i = gw dt + Rwb_i dv."""
    dtype, dev = p_wc.dtype, p_wc.device
    N = p_wc.shape[0]
    M = N - 1
    dt = pre.dt
    off_g = 1 if solve_scale else 0
    off_v = off_g + 3
    A = torch.zeros((6 * M, off_v + 3 * N), dtype=dtype, device=dev)
    b = torch.zeros(6 * M, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dpc = p_wc[1:] - p_wc[:-1]
    dRwc_pcb = torch.einsum("mij,j->mi", R_wc[1:] - R_wc[:-1], pcb)
    Rdp = _mv(R_wb[:-1], pre.dp)
    Rdv = _mv(R_wb[:-1], pre.dv)
    # Row and column index grids of the M position (rp) and velocity (rv)
    # row blocks.
    m = torch.arange(M, device=dev)
    r3 = torch.arange(3, device=dev)
    rp = (6 * m)[:, None] + r3                       # [M, 3]
    rv = rp + 3
    cv_i = (off_v + 3 * m)[:, None] + r3             # v_i columns
    cg = off_g + r3
    dtm = dt[:, None, None]
    if solve_scale:
        A[rp, 0] = dpc
    A[rp[:, :, None], cg] = (-0.5 * dt ** 2)[:, None, None] * eye3
    A[rp[:, :, None], cv_i[:, None, :]] = -dtm * eye3
    rhs_p = Rdp - dRwc_pcb - (0.0 if solve_scale else 1.0) * dpc
    b[rp] = rhs_p
    A[rv[:, :, None], cg] = -dtm * eye3
    A[rv[:, :, None], cv_i[:, None, :]] = -eye3.expand(M, 3, 3)
    A[rv[:, :, None], cv_i[:, None, :] + 3] = eye3.expand(M, 3, 3)
    b[rv] = Rdv
    sol, cond = _lstsq(A, b)
    if solve_scale:
        s, gw, v = sol[0], sol[1:4], sol[4:].reshape(N, 3)
    else:
        s = torch.ones((), dtype=dtype, device=dev)
        gw, v = sol[0:3], sol[3:].reshape(N, 3)
    return s, gw, v, cond


def refine_with_gravity_mag(t_kf, R_wb, p_wc, R_wc, pcb, pre: ImuPreint,
                            gw0, *, solve_scale: bool = True):
    """Enforce |g| = G and solve the accelerometer bias: gw = G Exp(S dxy)
    ghat0 with S spanning the tangent of ghat0, linearized; the bias
    enters through Ja_p / Ja_v.  Unknowns [s?, dxy (2), ba (3), v (3N)]."""
    dtype, dev = p_wc.dtype, p_wc.device
    N = p_wc.shape[0]
    M = N - 1
    dt = pre.dt
    ghat = gw0 / torch.linalg.norm(gw0)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    ref = torch.where(torch.abs(ghat[0]) < 0.9, e1, e2)
    b1 = torch.linalg.cross(ghat, ref)
    b1 = b1 / torch.linalg.norm(b1)
    b2 = torch.linalg.cross(ghat, b1)
    S = torch.stack([b1, b2], dim=1)                  # [3, 2]
    Gg = G_MAG * ghat
    dG = -G_MAG * lie.hat(ghat) @ S                   # [3, 2]
    n_s = 1 if solve_scale else 0
    off_th = n_s
    off_ba = off_th + 2
    off_v = off_ba + 3
    dpc = p_wc[1:] - p_wc[:-1]
    dRwc_pcb = torch.einsum("mij,j->mi", R_wc[1:] - R_wc[:-1], pcb)
    Rdp = _mv(R_wb[:-1], pre.dp)
    Rdv = _mv(R_wb[:-1], pre.dv)
    RJa_p = R_wb[:-1] @ pre.Ja_p
    RJa_v = R_wb[:-1] @ pre.Ja_v
    A = torch.zeros((6 * M, off_v + 3 * N), dtype=dtype, device=dev)
    b = torch.zeros(6 * M, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    m = torch.arange(M, device=dev)
    r3 = torch.arange(3, device=dev)
    rp = (6 * m)[:, None] + r3
    rv = rp + 3
    cv_i = (off_v + 3 * m)[:, None] + r3
    cth = off_th + torch.arange(2, device=dev)
    cba = off_ba + r3
    dt1 = dt[:, None]
    dtm = dt[:, None, None]
    if solve_scale:
        A[rp, 0] = dpc
    A[rp[:, :, None], cth] = (-0.5 * dt ** 2)[:, None, None] * dG
    A[rp[:, :, None], cba] = -RJa_p
    A[rp[:, :, None], cv_i[:, None, :]] = -dtm * eye3
    b[rp] = (Rdp - dRwc_pcb + 0.5 * dt1 ** 2 * Gg
             - (0.0 if solve_scale else 1.0) * dpc)
    A[rv[:, :, None], cth] = -dtm * dG
    A[rv[:, :, None], cba] = -RJa_v
    A[rv[:, :, None], cv_i[:, None, :]] = -eye3.expand(M, 3, 3)
    A[rv[:, :, None], cv_i[:, None, :] + 3] = eye3.expand(M, 3, 3)
    b[rv] = Rdv + dt1 * Gg
    sol, cond = _lstsq(A, b)
    if solve_scale:
        s, th, ba, v = sol[0], sol[1:3], sol[3:6], sol[6:].reshape(N, 3)
    else:
        s = torch.ones((), dtype=dtype, device=dev)
        th, ba, v = sol[0:2], sol[2:5], sol[5:].reshape(N, 3)
    gw = G_MAG * (lie.so3_exp(S @ th) @ ghat)
    return s, gw, ba, v, cond


def _bias_and_windows(R_wc, Rcb, tcb, windows, sigma_g, sigma_a):
    """(R_wb, pcb, bg, the windows re-preintegrated at bg) shared by the
    initialization and the post-relocalization recompute."""
    Rbc = Rcb.transpose(-1, -2)
    pcb = -Rbc @ tcb
    R_wb = R_wc @ Rcb
    gyro_w, acc_w, dt_w, mask_w = windows
    zeros3 = torch.zeros(3, dtype=R_wc.dtype, device=R_wc.device)
    pre0 = preintegrate_imu(gyro_w, acc_w, dt_w, zeros3, zeros3, sigma_g,
                            sigma_a, mask=mask_w)
    bg = solve_gyro_bias(R_wb, pre0)
    pre1 = preintegrate_imu(gyro_w, acc_w, dt_w, bg, zeros3, sigma_g,
                            sigma_a, mask=mask_w)
    return R_wb, pcb, bg, pre1


def try_init_vio(t_kf, R_wc, p_wc, Rcb, tcb, gyro_w, acc_w, dt_w, mask_w,
                 sigma_g: float, sigma_a: float, *,
                 solve_scale: bool = True) -> VioInit:
    """Full VI initialization from keyframe vision poses and the padded IMU
    windows between consecutive keyframes ([N - 1, T, ...]): preintegrate
    at bg = 0, gyro-bias GN, re-preintegrate at bg, linear alignment,
    gravity-magnitude refinement."""
    dtype = p_wc.dtype
    Rcb, tcb, R_wc = Rcb.to(dtype), tcb.to(dtype), R_wc.to(dtype)
    R_wb, pcb, bg, pre1 = _bias_and_windows(
        R_wc, Rcb, tcb, (gyro_w, acc_w, dt_w, mask_w), sigma_g, sigma_a)
    _, gw1, _, cond1 = linear_alignment(t_kf, R_wb, p_wc, R_wc, pcb, pre1,
                                        solve_scale=solve_scale)
    s2, gw2, ba, v2, cond2 = refine_with_gravity_mag(
        t_kf, R_wb, p_wc, R_wc, pcb, pre1, gw1, solve_scale=solve_scale)
    return VioInit(bg=bg, ba=ba, scale=s2, gw=gw2, v=v2,
                   cond=torch.maximum(cond1, cond2))


def recompute_bias_navstate(t_kf, R_wc, p_wc, Rcb, tcb, gyro_w, acc_w, dt_w,
                            mask_w, gw0, sigma_g: float,
                            sigma_a: float) -> VioInit:
    """Post-relocalization bias and NavState recompute: the gyro-bias GN,
    re-preintegration and the linear accel-bias / velocity solve over the
    frames tracked since the relocalization, with the gravity of the
    original initialization kept (scale known)."""
    dtype = p_wc.dtype
    Rcb, tcb, R_wc = Rcb.to(dtype), tcb.to(dtype), R_wc.to(dtype)
    R_wb, pcb, bg, pre1 = _bias_and_windows(
        R_wc, Rcb, tcb, (gyro_w, acc_w, dt_w, mask_w), sigma_g, sigma_a)
    gw0 = torch.as_tensor(gw0, dtype=dtype, device=p_wc.device)
    _, gw, ba, v, cond = refine_with_gravity_mag(
        t_kf, R_wb, p_wc, R_wc, pcb, pre1, gw0, solve_scale=False)
    return VioInit(bg=bg, ba=ba, scale=torch.ones((), dtype=dtype,
                                                  device=p_wc.device),
                   gw=gw, v=v, cond=cond)
