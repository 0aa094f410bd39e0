"""Windowed bundle adjustment with the landmark Schur complement.

Port of vieo_slam_tpu/solvers/local_ba.py with the semantics of its CPU
branch: observations grouped by landmark in fixed-capacity [M, O]
tensors, per-keyframe sums and the pose-pair Schur fill scattered with
`index_add_` (the JAX package's segment_sum; the pair fill in chunks of
landmarks, as the JAX package's distributed solve fills it), and the
reduced camera system solved densely.  parallel/dist_ba.py builds its
landmark-sharded step from the same pieces (_partial_schur,
_solve_camera_system, _back_substitute, lm_iterations).  Two robust
stages with outlier re-classification in between (5 iterations,
reclassify, 10 iterations).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import models as cm
from ..math import lie
from .lm import huber_cost, huber_weight
from .motion_ba import CHI2_MONO, CHI2_STEREO


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem, observations grouped by landmark.

    Rcw [K, 3, 3], tcw [K, 3]; fixed [K] bool; pw [M, 3]; lm_valid [M];
    obs_kf [M, O] int keyframe index (-1 pad); obs_uv [M, O, 2];
    obs_ur [M, O] (<0 mono); obs_inv_sigma2 [M, O]; obs_valid [M, O]."""

    Rcw: torch.Tensor
    tcw: torch.Tensor
    fixed: torch.Tensor
    pw: torch.Tensor
    lm_valid: torch.Tensor
    obs_kf: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor


class BAResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    pw: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def _obs_terms(Rcw, tcw, pw, prob: BAProblem, cam, bf):
    """Residual [M,O,3], pose Jacobian [M,O,3,6], landmark Jacobian
    [M,O,3,3], chi2 [M,O], delta2 [M,O], depth_ok [M,O]."""
    kf = prob.obs_kf.clamp_min(0).long()
    R = Rcw[kf]
    t = tcw[kf]
    pc = torch.einsum("moij,mj->moi", R, pw) + t
    uv_hat, Jproj = cm.project_jacobian(cam, pc)
    z = pc[..., 2]
    depth_ok = z > 1e-3
    inv_z = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    stereo = prob.obs_ur >= 0
    r_uv = prob.obs_uv - uv_hat
    ur_hat = uv_hat[..., 0] - bf * inv_z
    r_ur = torch.where(stereo, prob.obs_ur - ur_hat, torch.zeros_like(ur_hat))
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)
    M, O = z.shape
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(M, O, 3, 3)
    Jpc_pose = torch.cat([eye, -lie.hat(pc)], dim=-1)
    Juv_pose = Jproj @ Jpc_pose
    Jur_pose = Juv_pose[..., 0, :] + bf * (inv_z ** 2)[..., None] \
        * Jpc_pose[..., 2, :]
    Jur_pose = torch.where(stereo[..., None], Jur_pose,
                           torch.zeros_like(Jur_pose))
    Jp = -torch.cat([Juv_pose, Jur_pose[..., None, :]], dim=-2)
    Juv_lm = Jproj @ R
    Jur_lm = Juv_lm[..., 0, :] + bf * (inv_z ** 2)[..., None] * R[..., 2, :]
    Jur_lm = torch.where(stereo[..., None], Jur_lm, torch.zeros_like(Jur_lm))
    Jl = -torch.cat([Juv_lm, Jur_lm[..., None, :]], dim=-2)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    delta2 = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    return r, Jp, Jl, chi2, delta2, depth_ok


def _total_cost(Rcw, tcw, pw, prob, cam, bf, active):
    _, _, _, chi2, delta2, depth_ok = _obs_terms(Rcw, tcw, pw, prob, cam, bf)
    w_act = (active & prob.obs_valid).to(chi2.dtype)
    penalty = huber_cost(torch.full_like(chi2, 1e4), delta2)
    return torch.sum(huber_cost(chi2, delta2) * w_act * depth_ok) \
        + torch.sum(penalty * w_act * (~depth_ok))


def inv3x3(V: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return inv / det[..., None, None]


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _pair_chunk(K: int, M: int) -> int:
    """Landmarks per chunk of the pose-pair fill: the JAX package's
    distributed size, which bounds the chunk's [chunk, O, O, 6, 6]
    temporaries at about 64 MB at any K (one chunk up to 8192
    landmarks)."""
    return max(1, min(8192, max(256, (1 << 26) // (72 * max(K, 1))), M))


def _partial_schur(Rcw, tcw, pw, prob: BAProblem, cam, bf, active, lam):
    """The damped Schur system of prob's landmarks (all of them, or one
    shard's: the pose fields are whole either way).

    Returns ([Hpp [K,6,6], S [K,K,6,6], rhs [K,6]], the terms that a
    landmark-sharded solve sums over its shards, and (V_inv, bl, Wc,
    has_obs, kf_i), the landmark terms of the back-substitution."""
    K = Rcw.shape[0]
    r, Jp, Jl, chi2, delta2, depth_ok = _obs_terms(Rcw, tcw, pw, prob, cam,
                                                   bf)
    use = active & prob.obs_valid & depth_ok & (prob.obs_kf >= 0)
    w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2 * use
    kf_i = prob.obs_kf.clamp_min(0).long()
    kf_flat = kf_i.reshape(-1)
    wp = torch.where((~prob.fixed)[kf_i] & use, w, torch.zeros_like(w))

    Hpp_d = torch.einsum("mori,mo,morj->moij", Jp, wp, Jp)
    bp_o = -torch.einsum("mori,mo,mor->moi", Jp, wp, r)
    Hpp = _segment_sum(Hpp_d.reshape(-1, 6, 6), kf_flat, K)
    bp = _segment_sum(bp_o.reshape(-1, 6), kf_flat, K)

    V = torch.einsum("mori,mo,morj->mij", Jl, w, Jl)
    bl = -torch.einsum("mori,mo,mor->mi", Jl, w, r)
    lam_V = lam * torch.clamp_min(torch.diagonal(V, dim1=-2, dim2=-1), 1e-10)
    V_d = V + torch.diag_embed(lam_V)
    has_obs = torch.sum(w, dim=-1) > 0
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device).expand_as(V_d)
    V_inv = inv3x3(torch.where(has_obs[:, None, None], V_d, eye3))

    Wc = torch.einsum("mori,mo,morj->moij", Jp, wp, Jl)       # [M,O,6,3]
    Y = Wc @ V_inv[:, None]                                    # [M,O,6,3]
    Yb = torch.einsum("moij,mj->moi", Y, bl)
    # S[k,k'] = sum over landmarks of Y_o W_p^T for the pose pair (k, k')
    # of each observation pair (o, p), scattered in chunks of landmarks.
    pair_idx = kf_i[:, :, None] * K + kf_i[:, None, :]        # [M,O,O]
    S = torch.zeros((K * K, 6, 6), dtype=Y.dtype, device=Y.device)
    chunk = _pair_chunk(K, Y.shape[0])
    for a in range(0, Y.shape[0], chunk):
        Sp = torch.einsum("moik,mpjk->mopij", Y[a:a + chunk],
                          Wc[a:a + chunk])
        S = S + _segment_sum(Sp.reshape(-1, 6, 6),
                             pair_idx[a:a + chunk].reshape(-1), K * K)
    rhs = bp - _segment_sum(Yb.reshape(-1, 6), kf_flat, K)
    return [Hpp, S.reshape(K, K, 6, 6), rhs], (V_inv, bl, Wc, has_obs, kf_i)


def _solve_camera_system(Hpp, S, rhs, free, lam):
    """The damped reduced camera system, fixed poses masked out: dx [K,6]
    (zero for the fixed poses)."""
    K = Hpp.shape[0]
    lam_H = lam * torch.clamp_min(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                                  1e-10)
    S_full = -S.permute(0, 2, 1, 3).reshape(K, 6, K, 6).clone()
    ii = torch.arange(K, device=S.device)
    S_full[ii, :, ii, :] += Hpp + torch.diag_embed(lam_H)
    S_full = S_full.reshape(K * 6, K * 6)
    fm = free.repeat_interleave(6).to(S_full.dtype)
    S_masked = S_full * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    # solve_ex, as XLA's solve: a singular system gives a non-finite step,
    # which LM rejects, where torch.linalg.solve would raise.
    dx = torch.linalg.solve_ex(S_masked, rhs.reshape(-1) * fm)[0].reshape(
        K, 6)
    return torch.where(free[:, None], dx, torch.zeros_like(dx))


def _back_substitute(pw, lm_valid, dx, terms):
    """The landmarks after the pose step dx."""
    V_inv, bl, Wc, has_obs, kf_i = terms
    Wt_dx = torch.einsum("moij,moi->mj", Wc, dx[kf_i])
    dl = torch.einsum("mij,mj->mi", V_inv, bl - Wt_dx)
    return pw + torch.where((has_obs & lm_valid)[:, None], dl,
                            torch.zeros_like(dl))


def _pose_step(Rcw, tcw, dx):
    """The poses after the step dx [K,6]."""
    dRs, dts = lie.se3_exp(dx)
    return dRs @ Rcw, torch.einsum("kij,kj->ki", dRs, tcw) + dts


def _ba_iteration(Rcw, tcw, pw, prob: BAProblem, cam, bf, active, lam):
    """One damped Schur step; returns candidate (Rcw, tcw, pw)."""
    (Hpp, S, rhs), terms = _partial_schur(Rcw, tcw, pw, prob, cam, bf,
                                          active, lam)
    dx = _solve_camera_system(Hpp, S, rhs, ~prob.fixed, lam)
    return (*_pose_step(Rcw, tcw, dx),
            _back_substitute(pw, prob.lm_valid, dx, terms))


def lm_iterations(state: list, cost, step, cost_of, n_iters: int, lam):
    """n_iters Levenberg-Marquardt iterations with true accept/reject.

    step(state, lam) proposes a candidate, a list of tensors like state;
    cost_of(candidate) is its total cost.  The candidate replaces state
    where its cost is lower and finite (lambda halves), else lambda grows
    four times.  The tensors of state may lie on other devices than the
    cost.  Returns (state, cost)."""
    for _ in range(n_iters):
        cand = step(state, lam)
        new_cost = cost_of(cand)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        state = [torch.where(accept.to(n.device), n, o)
                 for n, o in zip(cand, state)]
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    return state, cost


def local_ba(prob: BAProblem, cam: cm.Camera, bf=0.0, *,
             stage_iters: tuple = (5, 10), init_lambda: float = 1e-4,
             init_active=None) -> BAResult:
    """Two-stage robust BA (5 iters, reclassify, 10 iters)."""
    dtype = prob.tcw.dtype
    bf = torch.as_tensor(bf, dtype=dtype, device=prob.tcw.device)

    def lm_stage(Rcw, tcw, pw, active, n_iters):
        def cost_of(s):
            return _total_cost(*s, prob, cam, bf, active).to(dtype)

        (Rcw, tcw, pw), cost = lm_iterations(
            [Rcw, tcw, pw], cost_of([Rcw, tcw, pw]),
            lambda s, lam: _ba_iteration(*s, prob, cam, bf, active, lam),
            cost_of, n_iters,
            torch.tensor(init_lambda, dtype=dtype, device=pw.device))
        return Rcw, tcw, pw, cost

    Rcw, tcw, pw = prob.Rcw, prob.tcw, prob.pw
    active = torch.ones_like(prob.obs_valid) if init_active is None \
        else init_active
    cost = torch.zeros((), dtype=dtype, device=pw.device)
    for n in stage_iters:
        Rcw, tcw, pw, cost = lm_stage(Rcw, tcw, pw, active, n)
        _, _, _, chi2, delta2, depth_ok = _obs_terms(Rcw, tcw, pw, prob, cam,
                                                     bf)
        gated = (chi2 <= delta2) & depth_ok
        frac = torch.sum((gated & prob.obs_valid).float()) \
            / torch.clamp_min(torch.sum(prob.obs_valid.float()), 1.0)
        active = torch.where(frac > 0.2, gated, prob.obs_valid)
    return BAResult(Rcw=Rcw, tcw=tcw, pw=pw,
                    obs_inlier=active & prob.obs_valid, cost=cost)


def landmark_refit_chi2(prob: BAProblem, cam: cm.Camera, bf):
    """Best-static-point consistency per landmark.

    Refit every landmark position alone (3 damped Gauss-Newton steps on
    its 3x3 system, poses fixed) and return the median per-observation
    chi2 at the refit position: a static landmark refits to sub-pixel
    residuals, a moving one (dynamic scene content) admits no single 3D
    point and keeps a large median -- what GBA's moving-landmark cull
    reads.  Returns (med_chi2 [M], n_obs [M])."""
    Rcw, tcw = prob.Rcw, prob.tcw
    bf = torch.as_tensor(bf, dtype=prob.tcw.dtype, device=prob.tcw.device)
    use0 = prob.obs_valid & (prob.obs_kf >= 0)
    pw = prob.pw
    eye3 = torch.eye(3, dtype=pw.dtype, device=pw.device)
    for _ in range(3):
        r, _, Jl, chi2, delta2, depth_ok = _obs_terms(Rcw, tcw, pw, prob,
                                                      cam, bf)
        w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2 \
            * (use0 & depth_ok)
        V = torch.einsum("mori,mo,morj->mij", Jl, w, Jl)
        bl = -torch.einsum("mori,mo,mor->mi", Jl, w, r)
        tr = torch.clamp_min(torch.diagonal(V, dim1=-2, dim2=-1).sum(-1),
                             1e-8)
        dl = torch.einsum("mij,mj->mi", inv3x3(V + (1e-3 * tr)[:, None, None]
                                               * eye3), bl)
        has = torch.sum(w, dim=-1) > 0
        pw = pw + torch.where(has[:, None], dl, torch.zeros_like(dl))
    _, _, _, chi2, _, depth_ok = _obs_terms(Rcw, tcw, pw, prob, cam, bf)
    valid = use0 & depth_ok
    n_obs = torch.sum(valid, dim=-1)
    # masked median: invalid slots sort to +inf, take the (n-1)//2-th
    c = torch.sort(torch.where(valid, chi2, torch.full_like(chi2,
                                                            float("inf"))),
                   dim=-1).values
    idx = ((n_obs - 1) // 2).clamp(0, c.shape[-1] - 1)
    med = torch.gather(c, 1, idx[:, None])[:, 0]
    return torch.where(n_obs > 0, med, torch.zeros_like(med)), n_obs
