"""Monocular two-view initialization: batched E + H model race.

Port of vieo_slam_tpu/solvers/initializer.py: the essential (8-point) and
homography (4-point) models are solved for all RANSAC hypotheses at once
as batched SVDs, scored with robust truncated costs, and race by
S_H / (S_H + S_E) > 0.45.  The winner's motion candidates (4 from the
essential decomposition, listed twice, or 8 from the Faugeras homography
decomposition) go through the same cheirality + parallax + reprojection
vote.

Randomness is explicit: `monocular_init` draws the [n_hyp, 8] sample
indices for a key as the JAX package draws them (`utils.prng`, its
threefry stream); everything else is the deterministic
`monocular_init_from_indices`, so a test can feed indices drawn elsewhere.
Singular vectors carry the sign conventions of `torch.linalg.svd`; R21,
t21 and `good` do not depend on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import models as cm
from ..utils import prng
from .local_ba import inv3x3


class MonoInitResult(NamedTuple):
    ok: torch.Tensor       # bool scalar
    R21: torch.Tensor      # [3, 3] second-from-first rotation
    t21: torch.Tensor      # [3] unit-norm translation
    pw: torch.Tensor       # [N, 3] triangulated points (frame-1 coords)
    good: torch.Tensor     # [N] triangulation validity
    n_good: torch.Tensor


def _essential_from_8(rays1, rays2):
    """8-point linear solve, batched: [..., 8, 3] x2 -> [..., 3, 3]."""
    x1, y1 = rays1[..., 0], rays1[..., 1]
    x2, y2 = rays2[..., 0], rays2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, ones], dim=-1)               # [..., 8, 9]
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    E = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    # Project to the essential manifold: singular values (1, 1, 0).
    U, _, Vt2 = torch.linalg.svd(E)
    S = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype,
                                device=E.device))
    return U @ S @ Vt2


def _sampson(E, rays1, rays2):
    """Squared Sampson distance on the normalized plane.
    E [..., 3, 3], rays [N, 3] -> [..., N]."""
    Ex1 = torch.einsum("...ij,nj->...ni", E, rays1)
    Etx2 = torch.einsum("...ji,nj->...ni", E, rays2)
    x2tEx1 = torch.einsum("ni,...ni->...n", rays2, Ex1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return x2tEx1 ** 2 / denom.clamp_min(1e-12)


def _homography_from_4(rays1, rays2):
    """4-point DLT homography on the normalized plane, batched:
    [..., 4, 3] x2 -> [..., 3, 3] with H x1 ~ x2."""
    x1, y1 = rays1[..., 0], rays1[..., 1]
    x2, y2 = rays2[..., 0], rays2[..., 1]
    o = torch.ones_like(x1)
    z = torch.zeros_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], -1)
    A = torch.cat([r1, r2], dim=-2)                       # [..., 8, 9]
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    return Vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _h_transfer(Hm, rays1, rays2):
    """Symmetric squared transfer error of H on the normalized plane.
    Hm [..., 3, 3], rays [N, 3] -> [..., N].  The inverse is the closed
    form (adjugate / det): a singular hypothesis gives non-finite errors,
    which never count as inliers, instead of an exception."""
    Hinv = inv3x3(Hm)

    def fwd(M, a, b):
        pb = torch.einsum("...ij,nj->...ni", M, a)
        w = pb[..., 2:]
        pb = pb[..., :2] / torch.where(w.abs() > 1e-12, w,
                                       torch.full_like(w, 1e-12))
        return torch.sum((pb - b[..., :2]) ** 2, dim=-1)

    return fwd(Hm, rays1, rays2) + fwd(Hinv, rays2, rays1)


def _decompose_homography(Hm):
    """Faugeras SVD decomposition of a normalized-plane homography into
    8 (R, t) motion candidates; t is returned unit-normalized."""
    U, s, Vt = torch.linalg.svd(Hm)
    d1, d2, d3 = s[0], s[1], s[2]
    sdet = torch.linalg.det(U) * torch.linalg.det(Vt)
    eps = 1e-12
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    x1 = torch.sqrt(((d1 * d1 - d2 * d2)
                     / (d1 * d1 - d3 * d3).clamp_min(eps)).clamp_min(0.0))
    x3 = torch.sqrt(((d2 * d2 - d3 * d3)
                     / (d1 * d1 - d3 * d3).clamp_min(eps)).clamp_min(0.0))
    e1 = (1.0, -1.0, 1.0, -1.0)
    e3 = (1.0, 1.0, -1.0, -1.0)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                      .clamp_min(0.0))

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    # case d' = +d2
    st = root / ((d1 + d3) * d2).clamp_min(eps)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(eps)
    for i in range(4):
        stheta = e1[i] * e3[i] * st
        Rp = mat([[ct, zero, -stheta], [zero, one, zero], [stheta, zero, ct]])
        tp = (d1 - d3) * torch.stack([e1[i] * x1, zero, -e3[i] * x3])
        Rs.append(sdet * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2
    sp = root / ((d1 - d3) * d2).clamp_min(eps)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(eps)
    for i in range(4):
        sphi = e1[i] * e3[i] * sp
        Rp = mat([[cp, zero, sphi], [zero, -one, zero], [sphi, zero, -cp]])
        tp = (d1 + d3) * torch.stack([e1[i] * x1, zero, e3[i] * x3])
        Rs.append(sdet * U @ Rp @ Vt)
        ts.append(U @ tp)
    R8 = torch.stack(Rs)
    t8 = torch.stack(ts)
    return R8, t8 / torch.linalg.norm(t8, dim=-1, keepdim=True).clamp_min(eps)


def draw_hypotheses(valid: torch.Tensor, key,
                    n_hyp: int = 256) -> torch.Tensor:
    """[n_hyp, 8] sample indices, uniform over the valid matches with
    replacement: the JAX package's draw for the key
    (`prng.prng_key(seed)`), on valid's device."""
    return prng.categorical_valid(key, valid, (n_hyp, 8))


def monocular_init_from_indices(
        uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
        cam: cm.Camera, idx: torch.Tensor, *, sampson_px: float = 1.5,
        min_inliers: int = 60,
        min_parallax_cos: float = 0.99995) -> MonoInitResult:
    """monocular_init for given [n_hyp, 8] sample indices."""
    N = uv1.shape[0]
    idx = idx.long()
    rays1 = cm.unproject(cam, uv1)
    rays2 = cm.unproject(cam, uv2)
    f = 0.5 * (cam.fx + cam.fy)
    thresh = (sampson_px / f) ** 2

    # --- essential model (8-point) ---------------------------------
    E = _essential_from_8(rays1[idx], rays2[idx])         # [H, 3, 3]
    d = _sampson(E, rays1, rays2)                         # [H, N]
    inl = (d < thresh) & valid[None, :]
    sc = torch.sum(torch.where(inl, 1.0 - d / thresh, torch.zeros_like(d)),
                   dim=-1)
    best = torch.argmax(sc)
    E_b, inl_e, score_e = E[best], inl[best], sc[best]

    # --- homography model (4-point) ---------------------------------
    Hm = _homography_from_4(rays1[idx[:, :4]], rays2[idx[:, :4]])
    dh = _h_transfer(Hm, rays1, rays2)
    th_h = 2.0 * thresh                 # symmetric two-view transfer sum
    inl_h_all = (dh < th_h) & valid[None, :]
    sc_h = torch.sum(torch.where(inl_h_all, 1.0 - dh / th_h,
                                 torch.zeros_like(dh)), dim=-1)
    best_h = torch.argmax(sc_h)
    H_b, inl_h, score_h = Hm[best_h], inl_h_all[best_h], sc_h[best_h]

    # --- model race ---------------------------------------------------
    use_h = score_h / (score_h + score_e).clamp_min(1e-9) > 0.45

    # Decompose E into the 4 candidates (U W V^T / U W^T V^T, +-u3).
    U, _, Vt = torch.linalg.svd(E_b)
    U = U * torch.sign(torch.linalg.det(U))               # proper rotations
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E_b.dtype, device=E_b.device)
    R_a = U @ W @ Vt
    R_b = U @ W.T @ Vt
    t_u = U[:, 2]
    cands_R_e = torch.stack([R_a, R_a, R_b, R_b, R_a, R_a, R_b, R_b])
    cands_t_e = torch.stack([t_u, -t_u, t_u, -t_u, t_u, -t_u, t_u, -t_u])

    # Faugeras 8-candidate decomposition of H.
    cands_R_h, cands_t_h = _decompose_homography(H_b)

    cands_R = torch.where(use_h, cands_R_h, cands_R_e)    # [8, 3, 3]
    cands_t = torch.where(use_h, cands_t_h, cands_t_e)    # [8, 3]
    inliers = torch.where(use_h, inl_h, inl_e)

    # Score all 8 candidates at once.
    C = cands_R.shape[0]
    eye = torch.eye(3, dtype=E_b.dtype, device=E_b.device)
    rays = torch.stack([rays1, rays2], dim=1).expand(C, N, 2, 3)
    Rcw = torch.stack([eye.expand(C, 3, 3), cands_R], dim=1)   # [C, 2, 3, 3]
    tcw = torch.stack([torch.zeros_like(cands_t), cands_t], dim=1)
    pw = cm.triangulate_dlt(rays, Rcw[:, None].expand(C, N, 2, 3, 3),
                            tcw[:, None].expand(C, N, 2, 3))   # [C, N, 3]
    z1 = pw[..., 2]
    p2 = torch.einsum("cij,cnj->cni", cands_R, pw) + cands_t[:, None, :]
    z2 = p2[..., 2]
    c2 = -torch.einsum("cji,cj->ci", cands_R, cands_t)         # 2nd centre
    d1 = pw
    d2 = pw - c2[:, None, :]
    cosp = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1)
        * torch.linalg.norm(d2, dim=-1)).clamp_min(1e-12)
    # Reprojection consistency in both views: kills the near-zero-depth
    # garbage a degenerate (pure-rotation) model produces through the
    # ridge-regularized DLT.
    e1 = torch.sum((cm.project(cam, pw) - uv1) ** 2, dim=-1)
    e2 = torch.sum((cm.project(cam, p2) - uv2) ** 2, dim=-1)
    reproj_ok = (e1 < 4.0 * sampson_px ** 2) & (e2 < 4.0 * sampson_px ** 2)
    goods = inliers[None, :] & (z1 > 0) & (z2 > 0) \
        & (cosp < min_parallax_cos) & reproj_ok               # [C, N]
    scores = goods.sum(dim=-1)
    b = torch.argmax(scores)
    n_good = scores[b]
    return MonoInitResult(ok=n_good >= min_inliers, R21=cands_R[b],
                          t21=cands_t[b], pw=pw[b], good=goods[b],
                          n_good=n_good)


def monocular_init(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                   cam: cm.Camera, key, *,
                   n_hyp: int = 256, sampson_px: float = 1.5,
                   min_inliers: int = 60,
                   min_parallax_cos: float = 0.99995) -> MonoInitResult:
    """Two-view relative pose + structure from matched pixels.

    uv1/uv2: [N, 2] matched keypoints of the two frames; valid: [N]; key
    the draw's `prng.prng_key`.  Scale convention: |t21| = 1 (the caller
    rescales by median depth)."""
    idx = draw_hypotheses(valid, key, n_hyp)
    return monocular_init_from_indices(
        uv1, uv2, valid, cam, idx, sampson_px=sampson_px,
        min_inliers=min_inliers, min_parallax_cos=min_parallax_cos)
