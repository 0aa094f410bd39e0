"""VIO motion-only bundle adjustment: two PVR+bias states with IMU /
encoder factors and the sliding marginal prior.

Port of vieo_slam_tpu/solvers/vio_ba.py: the joint state is 30D (the last
and the current frame's 15D tangents); residuals are whitened by the
Cholesky factor of each factor's information and stacked; Jacobians come
from torch.func.jacfwd through the NavState retraction; the dense 30x30 LM
runs a fixed number of iterations whose accept/reject decisions stay
tensor `where`s, with Huber IRLS on the reprojection block.  The last
state is then Schur-marginalized into the current frame's 15x15 prior for
the next call.  The solve neither reads the device from the host nor
copies host memory to it (the `*_ex` factorizations skip their error
checks; a failed step gives a non-finite cost and is rejected), so one
call can be captured into a CUDA graph (utils/cuda_graph.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..cameras import models as cm
from ..math.navstate import NavState, tcw_from_navstate
from ..math.preintegration import EncPreint, ImuPreint
from . import imu_factors
from .lm import huber_cost, huber_weight
from .motion_ba import CHI2_MONO, CHI2_STEREO, PoseObs


class VioOptResult(NamedTuple):
    ns: NavState              # optimized current state
    ns_last: NavState         # optimized (or untouched) last state
    inliers: torch.Tensor     # [N] reprojection inliers
    n_inliers: torch.Tensor
    prior_info: torch.Tensor  # [15, 15] marginal prior for the next call
    H_joint: torch.Tensor     # [30, 30] joint GN Hessian


# Per-iteration tangent-step caps [dp, dv, dphi, dbg, dba]: the rotation
# correction through the bias, Exp(Jg_R dbg), wraps at 2 pi, so a weakly
# constrained bias direction would otherwise admit huge wrapped steps.
_STEP_CAP = (1.0, 2.0, 0.5, 0.05, 0.5)


def _clamp_blocks(dx: torch.Tensor) -> torch.Tensor:
    """Clamp each 3D block of one or more stacked 15D tangents."""
    caps = torch.cat([torch.full((3,), c, dtype=dx.dtype, device=dx.device)
                      for c in _STEP_CAP]).repeat(dx.shape[-1] // 15)
    return torch.clamp(dx, -caps, caps)


def _solve(A, b):
    """torch.linalg.solve without the host-side error check."""
    return torch.linalg.solve_ex(A, b)[0]


def _chol_upper(A):
    """Upper Cholesky factor L^T (whitening: L^T r), unchecked."""
    return torch.linalg.cholesky_ex(A)[0].transpose(-1, -2)


def _pick(cond, a: NavState, b: NavState) -> NavState:
    return NavState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _reproj_terms(ns: NavState, obs: PoseObs, cam, Rcb, tcb, bf):
    Rcw, tcw = tcw_from_navstate(ns, Rcb, tcb)
    pc = torch.einsum("ij,nj->ni", Rcw, obs.pw) + tcw
    uv_hat = cm.project(cam, pc)
    z = pc[:, 2]
    depth_ok = z > 1e-3
    inv_z = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    stereo = obs.ur >= 0
    r_uv = obs.uv - uv_hat
    ur_hat = uv_hat[:, 0] - bf * inv_z
    r_ur = torch.where(stereo, obs.ur - ur_hat, torch.zeros_like(ur_hat))
    r = torch.cat([r_uv, r_ur[:, None]], dim=-1)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    delta2 = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    return r, chi2, delta2, depth_ok


def vio_pose_optimization(
    ns_last: NavState, ns_cur0: NavState, pre: ImuPreint, obs: PoseObs,
    cam: cm.Camera, Rcb: torch.Tensor, tcb: torch.Tensor, bf, *,
    prior_info: Optional[torch.Tensor] = None,
    enc_pre: Optional[EncPreint] = None,
    Rbe: Optional[torch.Tensor] = None, tbe: Optional[torch.Tensor] = None,
    sigma_bg_rw: float = 2e-4, sigma_ba_rw: float = 2e-3,
    gravity=imu_factors.GRAVITY, rounds: int = 4, iters_per_round: int = 8,
    last_fixed: Optional[bool] = None,
) -> VioOptResult:
    """Jointly refine the (last, current) NavStates against vision and
    odometry.  Without `prior_info` the last state is held fixed;
    otherwise both float and the last carries its 15D prior."""
    dtype, dev = ns_cur0.p.dtype, ns_cur0.p.device
    if not isinstance(bf, torch.Tensor):
        bf = torch.full((), float(bf), dtype=dtype, device=dev)
    if last_fixed is None:
        last_fixed = prior_info is None
    eye15 = torch.eye(15, dtype=dtype, device=dev)

    info_imu = imu_factors.imu_info_prv(pre)
    L_imu = _chol_upper(info_imu)
    info_b = imu_factors.bias_rw_info(sigma_bg_rw, sigma_ba_rw, pre.dt, dtype)
    L_b = torch.sqrt(torch.diagonal(info_b))
    if prior_info is not None:
        pi = 0.5 * (prior_info + prior_info.T) + 1e-8 * eye15
        L_prior = _chol_upper(pi)
    if enc_pre is not None:
        info_e = torch.linalg.inv_ex(
            enc_pre.cov + 1e-9 * torch.eye(6, dtype=dtype, device=dev))[0]
        L_enc = _chol_upper(0.5 * (info_e + info_e.T))

    ns_prior_ref = ns_last   # linearization point of the prior
    zero30 = torch.zeros(30, dtype=dtype, device=dev)

    def smooth_of(nl, nc):
        parts = [L_imu @ imu_factors.imu_residual_prv(nl, nc, pre, gravity),
                 L_b * imu_factors.bias_rw_residual(nl, nc)]
        if prior_info is not None:
            parts.append(L_prior @ imu_factors.prior_residual(
                nl, ns_prior_ref))
        if enc_pre is not None:
            parts.append(L_enc @ imu_factors.encoder_residual(
                nl, nc, enc_pre, Rbe, tbe))
        return torch.cat(parts)

    def cost_at(ns_l, ns_c, use):
        _, chi2, delta2, depth_ok = _reproj_terms(ns_c, obs, cam, Rcb, tcb,
                                                  bf)
        return torch.sum(smooth_of(ns_l, ns_c) ** 2) + torch.sum(
            huber_cost(chi2, delta2) * use * depth_ok)

    def linearize(ns_l, ns_c, use, last_floats):
        """(H [30, 30], b [30]) of the joint problem at (ns_l, ns_c)."""
        def smooth_r(dx):
            nl = ns_l.inc_pvr_bias(dx[:15]) if last_floats else ns_l
            return smooth_of(nl, ns_c.inc_pvr_bias(dx[15:]))

        def reproj_r(dx):
            return _reproj_terms(ns_c.inc_pvr_bias(dx[15:]), obs, cam, Rcb,
                                 tcb, bf)[0].reshape(-1)

        r_s = smooth_r(zero30)
        J_s = jacfwd(smooth_r)(zero30)
        r_p, chi2, delta2, depth_ok = _reproj_terms(ns_c, obs, cam, Rcb, tcb,
                                                    bf)
        w = huber_weight(chi2, delta2) * obs.inv_sigma2 * use * depth_ok
        J_p = jacfwd(reproj_r)(zero30).reshape(-1, 3, 30)
        H = J_s.T @ J_s + torch.einsum("nri,n,nrj->ij", J_p, w, J_p)
        b = -(J_s.T @ r_s) - torch.einsum("nri,n,nr->i", J_p, w, r_p)
        return H, b

    mask = torch.cat([torch.zeros(15, dtype=dtype, device=dev),
                      torch.ones(15, dtype=dtype, device=dev)])
    eye30 = torch.eye(30, dtype=dtype, device=dev)

    def lm_round(ns_l, ns_c, active):
        use = (active & obs.valid).to(dtype)
        lam = torch.full((), 1e-3, dtype=dtype, device=dev)
        cost = cost_at(ns_l, ns_c, use).to(dtype)
        for _ in range(iters_per_round):
            H, b = linearize(ns_l, ns_c, use, not last_fixed)
            if last_fixed:
                H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
                b = b * mask
            dx = _clamp_blocks(_solve(H + lam * eye30, b))
            nl_new = ns_l if last_fixed else ns_l.inc_pvr_bias(dx[:15])
            nc_new = ns_c.inc_pvr_bias(dx[15:])
            new_cost = cost_at(nl_new, nc_new, use).to(dtype)
            accept = (new_cost < cost) & torch.isfinite(new_cost)
            ns_l = _pick(accept, nl_new, ns_l)
            ns_c = _pick(accept, nc_new, ns_c)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, new_cost, cost)
        return ns_l, ns_c

    ns_l, ns_c = ns_last, ns_cur0
    active = torch.ones_like(obs.valid)
    for _ in range(rounds):
        ns_l, ns_c = lm_round(ns_l, ns_c, active)
        _, chi2, delta2, depth_ok = _reproj_terms(ns_c, obs, cam, Rcb, tcb,
                                                  bf)
        active = (chi2 <= delta2) & depth_ok

    # Joint Hessian with both states floating, then the Schur complement
    # of the last state: the prior on the current one.
    H, _ = linearize(ns_l, ns_c, (active & obs.valid).to(dtype), True)
    H_ll = H[:15, :15] + 1e-6 * eye15
    H_cl = H[15:, :15]
    prior_next = H[15:, 15:] - H_cl @ _solve(H_ll, H_cl.T)
    prior_next = 0.5 * (prior_next + prior_next.T)
    inliers = active & obs.valid
    return VioOptResult(ns=ns_c, ns_last=ns_l, inliers=inliers,
                        n_inliers=inliers.sum(), prior_info=prior_next,
                        H_joint=H)
