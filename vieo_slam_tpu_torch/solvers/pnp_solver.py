"""Batched PnP RANSAC: camera pose from 2D-3D matches, every hypothesis
in one batch of tensor operations.

Port of vieo_slam_tpu/solvers/pnp_solver.py: H six-point DLT hypotheses
solved as one batched SVD of [H, 12, 12], inlier counting as one [H, N]
masked reduction, then a weighted all-inlier DLT refit; and the
depth-sensor variant, 3-point Horn hypotheses scored by reprojection.

Each solver is split into its draw and a deterministic core
(`*_from_indices`).  The draw is the JAX package's own:
`jax.random.categorical` over -1e9-masked f32 logits, reproduced from
the key's threefry stream by `utils.prng` on the tensors' device, so a
key gives the reference's hypotheses on the CPU and on the card.

The DLT null vector's sign is taken as the SVD returns it, as in the JAX
package: a hypothesis whose sign comes out negative puts the points
behind the camera and counts no inliers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import prng


class PnPResult(NamedTuple):
    Rcw: torch.Tensor        # [3, 3]
    tcw: torch.Tensor        # [3]
    inliers: torch.Tensor    # [N]
    n_inliers: torch.Tensor  # scalar int
    ok: torch.Tensor         # scalar bool


def draw_indices(valid: torch.Tensor, n_hyp: int, size: int,
                 key) -> torch.Tensor:
    """[n_hyp, size] row indices, uniform over the valid rows with
    replacement (row 0 everywhere when none is valid): the JAX solvers'
    `jax.random.categorical(key, where(valid, 0, -1e9), (n_hyp, size))`
    for the key `prng.prng_key(seed)`."""
    return prng.categorical_valid(key, valid, (n_hyp, size))


def _dlt_rows(xy, pw, w=None):
    """Per-correspondence 2x12 DLT rows: xy [..., N, 2] unit-plane
    observations, pw [..., N, 3] world points, w optional [..., N] weights.
    Returns [..., 2N, 12]."""
    X = torch.cat([pw, torch.ones_like(pw[..., :1])], dim=-1)   # [..., N, 4]
    z = torch.zeros_like(X)
    x = xy[..., 0:1]
    y = xy[..., 1:2]
    r1 = torch.cat([X, z, -x * X], dim=-1)
    r2 = torch.cat([z, X, -y * X], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    return torch.cat([r1, r2], dim=-2)


def _pose_from_p(P):
    """[..., 3, 4] projective camera -> (R, t) with R in SO(3), scaled by
    the mean singular value of P[:, :3]."""
    M = P[..., :3]
    U, S, Vh = torch.linalg.svd(M)
    detUV = torch.linalg.det(U @ Vh)
    one = torch.ones_like(detUV)
    D = torch.stack([one, one, detUV], dim=-1)
    R = U @ (D[..., None] * Vh)
    scale = torch.mean(S, dim=-1) * torch.sign(detUV)
    scale = torch.where(torch.abs(scale) < 1e-12,
                        torch.full_like(scale, 1e-12), scale)
    return R, P[..., 3] / scale[..., None]


def _reproj_errors(R, t, pw, xy):
    """[..., N] unit-plane reprojection error (inf behind the camera)."""
    pc = torch.einsum("...ij,...nj->...ni", R, pw) + t[..., None, :]
    z = pc[..., 2]
    good_z = z > 1e-6
    pred = pc[..., :2] / torch.where(good_z, z, torch.ones_like(z))[..., None]
    err = torch.linalg.norm(pred - xy, dim=-1)
    return torch.where(good_z, err, torch.full_like(err, float("inf")))


def _unit_plane(rays):
    zc = rays[:, 2:]
    return rays[:, :2] / torch.where(torch.abs(zc) < 1e-9,
                                     torch.full_like(zc, 1e-9), zc)


def _refit_and_pick(R, t, xy, pw, valid, thresh, min_inliers):
    """Best hypothesis by inlier count, then one weighted all-inlier DLT
    refit, kept when it has at least as many inliers."""
    err = _reproj_errors(R, t, pw[None], xy[None])          # [H, N]
    inl = (err < thresh) & valid[None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    A_all = _dlt_rows(xy, pw, w=inl[best].to(xy.dtype))     # [2N, 12]
    _, _, Vh2 = torch.linalg.svd(A_all[None])
    R2, t2 = _pose_from_p(Vh2[0, -1, :].reshape(3, 4))
    inl2 = (_reproj_errors(R2, t2, pw, xy) < thresh) & valid
    n2 = torch.sum(inl2)
    use_refit = n2 >= counts[best]
    n_out = torch.maximum(n2, counts[best])
    return PnPResult(Rcw=torch.where(use_refit, R2, R[best]),
                     tcw=torch.where(use_refit, t2, t[best]),
                     inliers=torch.where(use_refit, inl2, inl[best]),
                     n_inliers=n_out, ok=n_out >= min_inliers)


def pnp_ransac_from_indices(rays, pw, valid, idx, *, thresh: float = 0.01,
                            min_inliers: int = 12) -> PnPResult:
    """The deterministic core of pnp_ransac, given the [H, 6] samples."""
    xy = _unit_plane(rays)
    A = _dlt_rows(xy[idx], pw[idx])                         # [H, 12, 12]
    _, _, Vh = torch.linalg.svd(A)
    R, t = _pose_from_p(Vh[..., -1, :].reshape(-1, 3, 4))
    return _refit_and_pick(R, t, xy, pw, valid, thresh, min_inliers)


def pnp_ransac(rays, pw, valid, key, *,
               n_hyp: int = 256, thresh: float = 0.01,
               min_inliers: int = 12) -> PnPResult:
    """RANSAC pose from bearing rays [N, 3] (camera frame, any positive
    scale) and matched world points pw [N, 3]; valid [N]; thresh is the
    inlier gate on the unit plane (pixels / focal length); key the
    draw's `prng.prng_key`."""
    idx = draw_indices(valid, n_hyp, 6, key)
    return pnp_ransac_from_indices(rays, pw, valid, idx, thresh=thresh,
                                   min_inliers=min_inliers)


def pnp_ransac_3d3d_from_indices(p_cam, rays, pw, valid, idx, *,
                                 thresh: float = 0.0125,
                                 min_inliers: int = 12) -> PnPResult:
    """The deterministic core of pnp_ransac_3d3d, given the [H, 3]
    samples."""
    xy = _unit_plane(rays)
    src = pw[idx]                                           # [H, 3, 3]
    dst = p_cam[idx]
    cs = torch.mean(src, dim=1, keepdim=True)
    cd = torch.mean(dst, dim=1, keepdim=True)
    H = torch.einsum("hni,hnj->hij", dst - cd, src - cs)
    U, _, Vh = torch.linalg.svd(H)
    detUV = torch.linalg.det(U @ Vh)
    one = torch.ones_like(detUV)
    D = torch.stack([one, one, detUV], dim=-1)
    R = U @ (D[..., None] * Vh)
    t = cd[:, 0] - torch.einsum("hij,hj->hi", R, cs[:, 0])
    return _refit_and_pick(R, t, xy, pw, valid, thresh, min_inliers)


def pnp_ransac_3d3d(p_cam, rays, pw, valid3d, valid, key, *,
                    n_hyp: int = 1024,
                    thresh: float = 0.0125,
                    min_inliers: int = 12) -> PnPResult:
    """RANSAC pose from 3-point Horn hypotheses, reprojection-scored
    (depth-sensor relocalization).

    p_cam [N, 3] camera-frame keypoint 3D (ray * depth); rays [N, 3]
    bearing rays (for scoring); pw [N, 3] matched landmark positions;
    valid3d [N] rows usable for sampling (have depth); valid [N] rows
    usable for scoring; key the draw's `prng.prng_key`."""
    idx = draw_indices(valid3d, n_hyp, 3, key)
    return pnp_ransac_3d3d_from_indices(p_cam, rays, pw, valid, idx,
                                        thresh=thresh,
                                        min_inliers=min_inliers)
