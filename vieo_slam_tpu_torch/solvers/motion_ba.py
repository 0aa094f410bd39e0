"""Motion-only bundle adjustment: one pose against fixed landmarks.

Port of vieo_slam_tpu/solvers/motion_ba.py (pose_optimization): mono and
stereo reprojection terms with Huber kernels at the chi-square 95%
quantiles, `rounds` rounds of LM with inlier re-classification between
rounds.  Pose parametrization: Tcw with left update Tcw <- Exp(dxi) Tcw,
so d(pc)/d(dxi) = [I | -hat(pc)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import models as cm
from ..math import lie
from .lm import huber_cost, huber_weight, lm_solve, lm_solve_parallel

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Fixed-capacity observation set of one frame: pw [N, 3] landmarks,
    uv [N, 2] pixels, ur [N] right-u (<0 mono), inv_sigma2 [N], valid [N]."""

    pw: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


class PoseOptResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    H: torch.Tensor


def _residuals(Rcw, tcw, obs: PoseObs, cam: cm.Camera, bf):
    """(r [N, 3], J [N, 3, 6], stereo [N], depth_ok [N]); the third row is
    the stereo u_r channel (zero for mono)."""
    pc = torch.einsum("ij,nj->ni", Rcw, obs.pw) + tcw
    uv_hat, Jproj = cm.project_jacobian(cam, pc)
    z = pc[:, 2]
    depth_ok = z > 1e-3
    stereo = obs.ur >= 0
    r_uv = obs.uv - uv_hat
    inv_z = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    ur_hat = uv_hat[:, 0] - bf * inv_z
    r_ur = torch.where(stereo, obs.ur - ur_hat, torch.zeros_like(ur_hat))
    N = pc.shape[0]
    Jpc = torch.cat([torch.eye(3, dtype=pc.dtype, device=pc.device)
                     .expand(N, 3, 3), -lie.hat(pc)], dim=-1)   # [N, 3, 6]
    Juv_dxi = Jproj @ Jpc
    J_uv = -Juv_dxi
    J_ur = -(Juv_dxi[:, 0, :] + bf * (inv_z ** 2)[:, None] * Jpc[:, 2, :])
    J_ur = torch.where(stereo[:, None], J_ur, torch.zeros_like(J_ur))
    r = torch.cat([r_uv, r_ur[:, None]], dim=-1)
    J = torch.cat([J_uv, J_ur[:, None, :]], dim=-2)
    return r, J, stereo, depth_ok


def _chi2(r, inv_sigma2):
    return torch.sum(r * r, dim=-1) * inv_sigma2


def _delta2(stereo, dtype):
    return torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(dtype)


def _robust_cost(chi2, delta2, w_active, depth_ok):
    """Huber total with a saturation penalty for behind-camera points."""
    penalty = huber_cost(torch.full_like(chi2, 1e4), delta2)
    return torch.sum(huber_cost(chi2, delta2) * w_active * depth_ok) \
        + torch.sum(penalty * w_active * (~depth_ok))


def _retract(pose, dx):
    R, t = pose
    dR, dt = lie.se3_exp(dx)
    return dR @ R, dR @ t + dt


def pose_optimization(Rcw0: torch.Tensor, tcw0: torch.Tensor, obs: PoseObs,
                      cam: cm.Camera, bf=0.0, *, rounds: int = 4,
                      iters_per_round: int = 10,
                      mode: str = "lm") -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks; mode "lm"
    (classic LM), "plm" (parallel-lambda LM) or "gn" (fixed-damping
    Gauss-Newton)."""
    if mode not in ("lm", "plm", "gn"):
        raise ValueError(f"unknown pose optimization mode {mode!r}")
    dtype = tcw0.dtype
    bf = torch.as_tensor(bf, dtype=dtype, device=tcw0.device)

    def chi2_of(pose):
        r, _, stereo, depth_ok = _residuals(pose[0], pose[1], obs, cam, bf)
        chi2 = _chi2(r, obs.inv_sigma2)
        return chi2, _delta2(stereo, chi2.dtype), depth_ok

    def make_fns(active):
        w_active = (active & obs.valid).to(dtype)

        def system_fn(pose):
            r, J, stereo, depth_ok = _residuals(pose[0], pose[1], obs, cam, bf)
            chi2 = _chi2(r, obs.inv_sigma2)
            delta2 = _delta2(stereo, chi2.dtype)
            w = (huber_weight(chi2, delta2) * obs.inv_sigma2 * w_active
                 * depth_ok)
            H = torch.einsum("nri,n,nrj->ij", J, w, J)
            b = -torch.einsum("nri,n,nr->i", J, w, r)
            return H, b, _robust_cost(chi2, delta2, w_active, depth_ok)

        def cost_fn(pose):
            chi2, delta2, depth_ok = chi2_of(pose)
            return _robust_cost(chi2, delta2, w_active, depth_ok)

        return system_fn, cost_fn

    pose = (Rcw0, tcw0)
    active = torch.ones_like(obs.valid)
    H = torch.zeros((6, 6), dtype=dtype, device=tcw0.device)
    eye6 = torch.eye(6, dtype=dtype, device=tcw0.device)
    for _ in range(rounds):
        system_fn, cost_fn = make_fns(active)
        if mode == "gn":
            for _ in range(iters_per_round):
                Hs, b, _ = system_fn(pose)
                A = Hs + 1e-4 * torch.diagonal(Hs).max() * eye6
                pose = _retract(pose, torch.linalg.solve_ex(A, b)[0])
            H, _, _ = system_fn(pose)
        elif mode == "plm":
            pose, _, H = lm_solve_parallel(system_fn, cost_fn, _retract, pose,
                                           iters=iters_per_round)
        else:
            pose, _, H = lm_solve(system_fn, cost_fn, _retract, pose,
                                  iters=iters_per_round)
        chi2, delta2, depth_ok = chi2_of(pose)
        active = (chi2 <= delta2) & depth_ok
    inliers = active & obs.valid
    return PoseOptResult(Rcw=pose[0], tcw=pose[1], inliers=inliers,
                         n_inliers=inliers.sum(), H=H)


def pose_optimization_with_prior(Rcw0: torch.Tensor, tcw0: torch.Tensor,
                                 obs: PoseObs, cam: cm.Camera, bf,
                                 R_prior: torch.Tensor, t_prior: torch.Tensor,
                                 prior_info: torch.Tensor, *,
                                 rounds: int = 2,
                                 iters_per_round: int = 4) -> PoseOptResult:
    """Vision motion BA plus a 6D SE(3) prior on the camera pose (the
    wheel-encoder motion solve).

    The preintegrated wheel odometry predicts T_prior for the current
    camera with information `prior_info` [6, 6] in the left tangent of
    Tcw, ordered [rho, phi].  The prior residual r = log(Tcw T_prior^-1)
    enters every LM system with Jacobian I (exact to first order), so the
    odometry bounds the pose where few inliers leave vision
    underdetermined.  Classic LM; capturable in a CUDA graph (a float `bf`
    becomes a fill on the device, not a host copy)."""
    dtype = tcw0.dtype
    if not isinstance(bf, torch.Tensor):
        bf = torch.full((), float(bf), dtype=dtype, device=tcw0.device)

    def prior_terms(pose):
        Rd = pose[0] @ R_prior.T
        r6 = lie.se3_log(Rd, pose[1] - Rd @ t_prior)      # [rho, phi]
        return r6, r6 @ prior_info @ r6

    def chi2_of(pose):
        r, _, stereo, depth_ok = _residuals(pose[0], pose[1], obs, cam, bf)
        chi2 = _chi2(r, obs.inv_sigma2)
        return chi2, _delta2(stereo, chi2.dtype), depth_ok

    def make_fns(active):
        w_active = (active & obs.valid).to(dtype)

        def system_fn(pose):
            r, J, stereo, depth_ok = _residuals(pose[0], pose[1], obs, cam, bf)
            chi2 = _chi2(r, obs.inv_sigma2)
            delta2 = _delta2(stereo, chi2.dtype)
            w = (huber_weight(chi2, delta2) * obs.inv_sigma2 * w_active
                 * depth_ok)
            H = torch.einsum("nri,n,nrj->ij", J, w, J)
            b = -torch.einsum("nri,n,nr->i", J, w, r)
            r6, pcost = prior_terms(pose)
            return (H + prior_info, b - prior_info @ r6,
                    _robust_cost(chi2, delta2, w_active, depth_ok) + pcost)

        def cost_fn(pose):
            chi2, delta2, depth_ok = chi2_of(pose)
            return _robust_cost(chi2, delta2, w_active, depth_ok) \
                + prior_terms(pose)[1]

        return system_fn, cost_fn

    pose = (Rcw0, tcw0)
    active = torch.ones_like(obs.valid)
    H = torch.zeros((6, 6), dtype=dtype, device=tcw0.device)
    for _ in range(rounds):
        system_fn, cost_fn = make_fns(active)
        pose, _, H = lm_solve(system_fn, cost_fn, _retract, pose,
                              iters=iters_per_round)
        chi2, delta2, depth_ok = chi2_of(pose)
        active = (chi2 <= delta2) & depth_ok
    inliers = active & obs.valid
    return PoseOptResult(Rcw=pose[0], tcw=pose[1], inliers=inliers,
                         n_inliers=inliers.sum(), H=H)
