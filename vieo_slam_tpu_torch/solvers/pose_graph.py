"""Sim3/SE3 pose-graph optimization (essential graph).

Port of the CPU branch of vieo_slam_tpu/solvers/pose_graph.py: keyframes
as Sim(3) vertices (scale pinned for stereo/RGB-D), constrained by edges
that carry their measured relative transform; after the solve, landmarks
follow their reference keyframe.  Per-edge 7-D residuals
r = log(S_m^-1 S_i S_j^-1) get their [E, 7, 14] Jacobians from one
forward-mode jacfwd over a 14-vector shared by all edges (each edge's
residual depends only on its own endpoints, so the shared update gives
every edge its own Jacobian); the blocks are scattered into the dense
[7K, 7K] system with `index_add_` and solved by Cholesky, a fixed number
of damped Gauss-Newton iterations on the graph's device with no host
check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..math import lie


class PoseGraphProblem(NamedTuple):
    """Vertices: Scw (world -> kf) as (R [K, 3, 3], t [K, 3], s [K]).

    edge_i/j [E] vertex ids (-1 pads); edge_R/t/s: measured relative
    transform S_ij = S_i S_j^-1; edge_w [E] weights; fixed [K] bool."""

    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    fixed: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_R: torch.Tensor
    edge_t: torch.Tensor
    edge_s: torch.Tensor
    edge_w: torch.Tensor


def make_edge_measurements(R, t, s, edge_i, edge_j):
    """S_ij = S_i S_j^-1 for each edge from the current vertex values."""
    ei, ej = edge_i.long(), edge_j.long()
    Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(R[ej], t[ej], s[ej])
    return lie.sim3_compose(R[ei], t[ei], s[ei], Rj_inv, tj_inv, sj_inv)


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """7-D residual log(S_m^-1 S_i S_j^-1)."""
    Ra, ta, sa = lie.sim3_compose(Ri, ti, si, *lie.sim3_inverse(Rj, tj, sj))
    Re, te, se = lie.sim3_compose(*lie.sim3_inverse(Rm, tm, sm), Ra, ta, sa)
    return lie.sim3_log(Re, te, se)


def optimize_pose_graph(prob: PoseGraphProblem, *, iters: int = 20,
                        fix_scale: bool = False,
                        lam: float = 1e-6) -> PoseGraphProblem:
    """Damped Gauss-Newton on the Sim3 graph, `iters` fixed steps."""
    K = prob.R.shape[0]
    dtype = prob.t.dtype
    dev = prob.t.device
    evalid = (prob.edge_i >= 0) & (prob.edge_j >= 0)
    ei = prob.edge_i.clamp_min(0).long()
    ej = prob.edge_j.clamp_min(0).long()
    w = torch.where(evalid, prob.edge_w, torch.zeros_like(prob.edge_w))
    fm = (~prob.fixed).repeat_interleave(7).to(dtype)
    if fix_scale:
        fm = fm * torch.tensor([1, 1, 1, 1, 1, 1, 0], dtype=dtype,
                               device=dev).repeat(K)
    eye = torch.eye(7 * K, dtype=dtype, device=dev)
    rows = torch.cat([ei, ej, ei, ej])
    cols = torch.cat([ei, ej, ej, ei])
    pair = rows * K + cols
    zero14 = torch.zeros(14, dtype=dtype, device=dev)
    R, t, s = prob.R, prob.t, prob.s
    for _ in range(iters):
        Rie, tie, sie = R[ei], t[ei], s[ei]
        Rje, tje, sje = R[ej], t[ej], s[ej]

        def resid(dx):
            Ria, tia, sia = lie.sim3_compose(*lie.sim3_exp(dx[:7]),
                                             Rie, tie, sie)
            Rja, tja, sja = lie.sim3_compose(*lie.sim3_exp(dx[7:]),
                                             Rje, tje, sje)
            return _edge_residual(Ria, tia, sia, Rja, tja, sja,
                                  prob.edge_R, prob.edge_t, prob.edge_s)

        r = resid(zero14)                                     # [E, 7]
        J = jacfwd(resid)(zero14)                             # [E, 7, 14]
        Ji, Jj = J[..., :7], J[..., 7:]
        if fix_scale:
            Ji = Ji.clone()
            Jj = Jj.clone()
            Ji[:, :, 6] = 0.0
            Jj[:, :, 6] = 0.0
        Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
        bi = -torch.einsum("eri,e,er->ei", Ji, w, r)
        bj = -torch.einsum("eri,e,er->ei", Jj, w, r)
        blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
        H = torch.zeros((K * K, 7, 7), dtype=dtype, device=dev).index_add_(
            0, pair, blocks)
        b = torch.zeros((K, 7), dtype=dtype, device=dev).index_add_(
            0, ei, bi).index_add_(0, ej, bj)
        Hd = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hd = Hd * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm) + lam * eye
        L, _ = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve((b.reshape(-1) * fm)[:, None], L)[:, 0]
        dx = (dx * fm).reshape(K, 7)
        R, t, s = lie.sim3_compose(*lie.sim3_exp(dx), R, t, s)
    return prob._replace(R=R, t=t, s=s)


def correct_landmarks(pw, lm_ref_kf, R_old, t_old, s_old, R_new, t_new,
                      s_new):
    """Move landmarks with their reference keyframes:
    p' = S_new(ref)^-1 S_old(ref) p."""
    k = lm_ref_kf.clamp_min(0).long()
    p_cam = lie.sim3_apply(R_old[k], t_old[k], s_old[k], pw)
    return lie.sim3_apply(*lie.sim3_inverse(R_new[k], t_new[k], s_new[k]),
                          p_cam)
