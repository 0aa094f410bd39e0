"""Sim3/SE3 3D-3D alignment: batched Horn closed form, RANSAC and the
two-sided reprojection refinement.

Port of vieo_slam_tpu/solvers/sim3_solver.py.  All RANSAC hypotheses are
evaluated at once ([H] triplets -> batched Horn -> [H, N] inlier matrix
-> argmax).  `sim3_ransac` is split into its draw and a deterministic
core (`sim3_ransac_from_indices`) like the PnP solvers.  The refinement's
Jacobians are one forward-mode `torch.func.jacfwd` over the shared
D-dimensional update, evaluated for all N edges at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..cameras import models as cm
from ..math import lie
from .lm import huber_cost, huber_weight, lm_solve
from .pnp_solver import draw_indices


def horn_alignment(p_src, p_dst, w=None, *, with_scale: bool = True):
    """Closed-form similarity aligning src -> dst ([..., N, 3]).

    Returns (R [..., 3, 3], t [..., 3], s [...]): dst ~= s R src + t."""
    if w is None:
        w = torch.ones(p_src.shape[:-1], dtype=p_src.dtype,
                       device=p_src.device)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    mu_s = torch.sum(p_src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(p_dst * w[..., None], dim=-2) / wsum
    xs = p_src - mu_s[..., None, :]
    xd = p_dst - mu_d[..., None, :]
    cov = torch.einsum("...ni,...n,...nj->...ij", xd, w, xs) \
        / wsum[..., None]
    U, D, Vh = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vh)
    one = torch.ones_like(det)
    fix = torch.stack([one, one, det], dim=-1)
    R = (U * fix[..., None, :]) @ Vh
    if with_scale:
        var_s = torch.sum(w[..., None] * xs * xs, dim=(-2, -1)) / wsum[..., 0]
        s = torch.sum(D * fix, dim=-1) / torch.clamp_min(var_s, 1e-12)
    else:
        s = one
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor


def sim3_ransac_from_indices(p_src, p_dst, valid, idx, *,
                             inlier_thresh: float = 0.05,
                             with_scale: bool = True,
                             refine: bool = True) -> Sim3RansacResult:
    """The deterministic core of sim3_ransac, given the [H, 3] samples."""
    R, t, s = horn_alignment(p_src[idx], p_dst[idx], with_scale=with_scale)
    pred = s[:, None, None] * torch.einsum("hij,nj->hni", R, p_src) \
        + t[:, None]
    err = torch.linalg.norm(pred - p_dst[None], dim=-1)         # [H, N]
    inl = (err < inlier_thresh) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    inliers = inl[best]
    if not refine:
        return Sim3RansacResult(R=R[best], t=t[best], s=s[best],
                                inliers=inliers, n_inliers=counts[best])
    # Weighted Horn on the best inlier set.
    R_f, t_f, s_f = horn_alignment(p_src, p_dst, w=inliers.to(p_src.dtype),
                                   with_scale=with_scale)
    pred = s_f * (p_src @ R_f.T) + t_f
    inliers = (torch.linalg.norm(pred - p_dst, dim=-1) < inlier_thresh) \
        & valid
    return Sim3RansacResult(R=R_f, t=t_f, s=s_f, inliers=inliers,
                            n_inliers=torch.sum(inliers.int()))


def sim3_ransac(p_src, p_dst, valid, key, *,
                n_hyp: int = 128, inlier_thresh: float = 0.05,
                with_scale: bool = True,
                refine: bool = True) -> Sim3RansacResult:
    """RANSAC Horn alignment of matched 3D pairs p_src/p_dst [N, 3];
    inlier_thresh in dst-frame metres.  The [n_hyp, 3] triplets are the
    JAX package's draw for the key (`prng.prng_key(seed)`), so a seed
    gives the reference's hypotheses."""
    idx = draw_indices(valid, n_hyp, 3, key)
    return sim3_ransac_from_indices(p_src, p_dst, valid, idx,
                                    inlier_thresh=inlier_thresh,
                                    with_scale=with_scale, refine=refine)


class OptimizeSim3Result(NamedTuple):
    R: torch.Tensor          # refined S_ck rotation
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor    # [N] bool (both directions pass chi2)
    n_inliers: torch.Tensor


CHI2_SIM3 = 10.0   # the reference's th2 = 10


def optimize_sim3(R0, t0, s0, p_k, p_c, uv_k, uv_c, inv_sigma2_k,
                  inv_sigma2_c, valid, cam: cm.Camera, *,
                  fix_scale: bool = True, rounds: int = 2,
                  iters: int = 8) -> OptimizeSim3Result:
    """Reprojection-based Sim3 refinement: one Sim3 S_ck with two-sided
    projection edges (p_k through S_ck against the c-image observation,
    p_c through S_ck^-1 against the k-image one), Huber at chi2 = 10,
    outliers re-classified between rounds.  Jacobians by forward-mode
    autodiff through the left-multiplicative retraction S <- Exp(dx) S.

    p_k, p_c [N, 3]: matched landmark positions in each KF's camera frame;
    uv_k, uv_c [N, 2]: their observed keypoints.  Returns the refined
    S_ck and the two-sided inlier set."""
    dt = t0.dtype
    D = 6 if fix_scale else 7

    def residuals(x):
        R, t, s = x
        pred_c = cm.project(cam, lie.sim3_apply(R, t, s, p_k))
        Ri, ti, si = lie.sim3_inverse(R, t, s)
        pred_k = cm.project(cam, lie.sim3_apply(Ri, ti, si, p_c))
        return torch.cat([uv_c - pred_c, uv_k - pred_k], dim=-1)   # [N, 4]

    def chi2_of(x):
        r = residuals(x)
        return (torch.sum(r[:, :2] ** 2, dim=-1) * inv_sigma2_c,
                torch.sum(r[:, 2:] ** 2, dim=-1) * inv_sigma2_k)

    def retract(x, dx):
        # No rotation re-projection here: this is differentiated at dx = 0
        # and an SVD projection is not differentiable at an orthogonal R;
        # rotations are re-projected between rounds instead.
        R, t, s = x
        if fix_scale:
            dx = torch.cat([dx, torch.zeros(1, dtype=dx.dtype,
                                            device=dx.device)])
        dR, dtr, ds = lie.sim3_exp(dx)
        return lie.sim3_compose(dR, dtr, ds, R, t, s)

    def make_fns(active):
        w_act = (active & valid).to(dt)

        def cost_fn(x):
            c_c, c_k = chi2_of(x)
            rho = huber_cost(c_c, CHI2_SIM3) + huber_cost(c_k, CHI2_SIM3)
            return torch.sum(rho * w_act)

        def system_fn(x):
            r0 = residuals(x)
            J = jacfwd(lambda d: residuals(retract(x, d)))(
                torch.zeros(D, dtype=dt, device=t0.device))      # [N, 4, D]
            c_c, c_k = chi2_of(x)
            w_c = huber_weight(c_c, CHI2_SIM3) * inv_sigma2_c * w_act
            w_k = huber_weight(c_k, CHI2_SIM3) * inv_sigma2_k * w_act
            w = torch.stack([w_c, w_c, w_k, w_k], dim=1)          # [N, 4]
            H = torch.einsum("nri,nr,nrj->ij", J, w, J)
            b = -torch.einsum("nri,nr,nr->i", J, w, r0)
            return H, b, cost_fn(x)

        return system_fn, cost_fn

    x = (R0.to(dt), t0, torch.as_tensor(s0, dtype=dt, device=t0.device))
    active = torch.ones_like(valid)
    for _ in range(rounds):
        system_fn, cost_fn = make_fns(active)
        x, _, _ = lm_solve(system_fn, cost_fn, retract, x, iters=iters)
        x = (lie.normalize_rotation(x[0]), x[1], x[2])
        c_c, c_k = chi2_of(x)
        active = (c_c <= CHI2_SIM3) & (c_k <= CHI2_SIM3)
    inliers = active & valid
    return OptimizeSim3Result(R=x[0], t=x[1], s=x[2], inliers=inliers,
                              n_inliers=torch.sum(inliers.int()))
