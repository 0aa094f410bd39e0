"""Two-view triangulation of new landmarks between keyframe pairs.

Port of vieo_slam_tpu/backend/triangulation.py: free keypoints of KF1
are matched to free keypoints of KF2 under an epipolar gate (one dense
masked Hamming problem, kernel B3), DLT-triangulated, and filtered by
parallax / depth / reprojection checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import models as cm
from ..math import lie
from ..ops import matching


class TriangulationResult(NamedTuple):
    pw: torch.Tensor     # [N, 3] triangulated world points
    kp2: torch.Tensor    # [N] matched keypoint idx in KF2 (-1 invalid)
    good: torch.Tensor   # [N] all checks passed (N = keypoints of KF1)


def _lookup(table, idx):
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def triangulate_pair(Rcw1, tcw1, uv1, level1, desc1, free1,
                     Rcw2, tcw2, uv2, level2, desc2, free2,
                     inv_sigma2_tab, level_scales, cam: cm.Camera, *,
                     max_dist: int = matching.TH_LOW, ratio: float = 1.0,
                     epipolar_sigma: float = 3.84,
                     min_parallax_cos: float = 0.9998,
                     max_depth: float = 60.0) -> TriangulationResult:
    """Match free keypoints of KF1 vs KF2 with an epipolar gate and
    triangulate; returns per-KF1-keypoint slots."""
    rays1 = cm.unproject(cam, uv1)
    rays2 = cm.unproject(cam, uv2)
    R21 = Rcw2 @ Rcw1.T
    t21 = tcw2 - torch.einsum("ij,j->i", R21, tcw1)
    E = lie.hat(t21) @ R21
    l2 = torch.einsum("ij,nj->ni", E, rays1)
    num = torch.abs(torch.einsum("ni,mi->nm", l2, rays2))
    den = torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None] + 1e-12
    f = float(np.float32(0.5) * (np.float32(cam.fx) + np.float32(cam.fy)))
    epi_px = f * num / den
    sig = _lookup(level_scales, level2)[None, :]
    epi_ok = epi_px <= float(epipolar_sigma) ** 0.5 * sig

    idx, _ = matching.match_descriptors(desc1, desc2, free1, free2,
                                        max_dist=max_dist, ratio=ratio,
                                        extra_mask=epi_ok)
    matched = idx >= 0
    kp2 = idx.clamp_min(0).long()

    n = uv1.shape[0]
    rays = torch.stack([rays1, rays2[kp2]], dim=1)
    Rs = torch.stack([Rcw1, Rcw2]).expand(n, 2, 3, 3)
    ts = torch.stack([tcw1, tcw2]).expand(n, 2, 3)
    pw = cm.triangulate_dlt(rays, Rs, ts)

    pc1 = torch.einsum("ij,nj->ni", Rcw1, pw) + tcw1
    pc2 = torch.einsum("ij,nj->ni", Rcw2, pw) + tcw2
    depth_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05) \
        & (pc1[:, 2] < max_depth)
    d1 = torch.einsum("ji,nj->ni", Rcw1, rays1)
    d2 = torch.einsum("ji,nj->ni", Rcw2, rays2[kp2])
    cosp = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-12)
    parallax_ok = cosp < min_parallax_cos
    uvh1 = cm.project(cam, pc1)
    uvh2 = cm.project(cam, pc2)
    e1 = torch.sum((uvh1 - uv1) ** 2, dim=-1) * _lookup(inv_sigma2_tab, level1)
    e2 = torch.sum((uvh2 - uv2[kp2]) ** 2, dim=-1) \
        * _lookup(inv_sigma2_tab, level2[kp2])
    reproj_ok = (e1 < 5.991) & (e2 < 5.991)

    good = matched & depth_ok & parallax_ok & reproj_ok
    return TriangulationResult(pw=pw, kp2=torch.where(good, kp2, -1).int(),
                               good=good)
