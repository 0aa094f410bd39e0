"""Binary-descriptor matching as dense masked Hamming problems.

Port of vieo_slam_tpu/ops/matching.py: every matcher builds (or lets the
kernel build) an [M, N] candidate mask, takes masked Hamming best-2 per
row and the best row per column, and keeps one-to-one matches.  The
best-2 step is kernel B3 (`cuda_matching.fused_best2`); projection search
builds its window mask inside kernel B4
(`cuda_matching.fused_projection_best2`).  On CPU tensors both run their
plain PyTorch versions, which have the semantics of the JAX package's XLA
branch (ties to the lowest index, rows without candidates give INF).

All matchers return fixed-capacity index tensors with -1 for "no match".
"""

from __future__ import annotations

import math

import torch

from .cuda_matching import INF, best2_plain, fused_best2, fused_projection_best2
from .cuda_matching import hamming_matrix  # noqa: F401  (re-exported)

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row (best_idx, best, second) over masked columns; rows with no
    candidates give best >= INF; ties to the lowest index."""
    idx, best, second, _ = best2_plain(dist, mask)
    return idx, best, second


def _best2(desc_a, desc_b, mask):
    """(best_idx [Na], best [Na], second [Na], col_best_row [Nb])."""
    return fused_best2(desc_a, desc_b, mask.contiguous())


def _mutual(col_best_row, best_idx, valid):
    """Keep row a's match to column b only if a is also column b's best
    row (ties to the lowest row)."""
    rows = torch.arange(best_idx.shape[0], device=best_idx.device)
    return valid & (col_best_row[best_idx.clamp_min(0).long()] == rows)


def mutual_filter(best_idx: torch.Tensor, na: int, nb: int,
                  valid: torch.Tensor) -> torch.Tensor:
    """Keep a->b matches that are the best for that b too (one-to-one);
    ties to the lowest row, by a scatter-min of the row index (`na` for an
    invalid row)."""
    rows = torch.arange(na, dtype=torch.int32, device=best_idx.device)
    col = best_idx.clamp(min=0).long()
    owner = torch.full((nb,), na, dtype=torch.int32, device=best_idx.device)
    owner.scatter_reduce_(0, col, torch.where(valid, rows, na), "amin")
    return valid & (owner[col] == rows)


def mutual_from_dist(dist: torch.Tensor, mask: torch.Tensor,
                     best_idx: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Scatter-free one-to-one filter from the [Na, Nb] distance: keep
    row a's match to column b only if a is also the argmin of column b
    over the masked distance (ties to the lowest row)."""
    d = torch.where(mask, dist, torch.full_like(dist, INF))
    return _mutual(torch.argmin(d, dim=0), best_idx, valid)


def _level_lookup(table: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """table[clip(level, 0, T-1)]."""
    return table[level.long().clamp(0, table.shape[0] - 1)]


def rotation_consistency_mask(angle_a, angle_b, match_idx, valid):
    """Keep only the matches whose angle difference falls in the 3 most
    populated of HISTO_BINS histogram bins (ORBmatcher's rotation
    histogram); tied bins rank by the lower bin index, as `lax.top_k`
    ranks them.  Returns bool [Na]."""
    d = angle_a - angle_b[match_idx.clamp_min(0).long()]
    frac = torch.remainder(d / (2.0 * math.pi), 1.0)
    bins = (frac * HISTO_BINS).int().clamp(0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=d.device)
    hist.index_add_(0, bins, valid.int())
    top3 = torch.sort(hist, descending=True, stable=True).indices[:3]
    return valid & (bins[:, None] == top3[None, :]).any(dim=-1)


def match_descriptors(desc_a, desc_b, valid_a, valid_b, *,
                      max_dist: int = TH_LOW, ratio: float = 0.9,
                      angle_a=None, angle_b=None, extra_mask=None):
    """Generic one-to-one matcher; with keypoint angles, matches outside
    the dominant rotation bins are dropped.  Returns (idx [Na] int32 with
    -1 for unmatched, dist [Na] int32)."""
    mask = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    best_idx, best, second, col_best = _best2(desc_a, desc_b, mask)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    ok = _mutual(col_best, best_idx, ok)
    if angle_a is not None:
        ok = rotation_consistency_mask(angle_a, angle_b, best_idx, ok)
    return (torch.where(ok, best_idx, -1).int(),
            torch.where(ok, best, INF).int())


def search_by_projection(proj_uv, proj_level, proj_desc, proj_valid,
                         kp_uv, kp_level, kp_desc, kp_valid, *,
                         radius, level_scales, max_dist: int = TH_HIGH,
                         ratio: float = 1.0, level_tolerance: int = 1):
    """Match projected map points [M] against frame keypoints [N] within a
    per-point window of radius * level_scales[proj_level] pixels.
    `radius` is a float or a 0-d tensor.  Returns (idx [M], dist [M])."""
    level_scales = torch.as_tensor(level_scales, dtype=torch.float32,
                                   device=proj_uv.device)
    r = radius * _level_lookup(level_scales, proj_level)
    best_idx, best, second, col_best = fused_projection_best2(
        proj_desc, kp_desc, proj_uv, r, proj_level, proj_valid,
        kp_uv, kp_level, kp_valid, level_tolerance)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.float() <= ratio * second.float())
    ok = _mutual(col_best, best_idx, ok)
    return (torch.where(ok, best_idx, -1).int(),
            torch.where(ok, best, INF).int())


def stereo_candidate_mask(uv_l, level_l, valid_l, uv_r, level_r, valid_r, *,
                          min_disp: float, max_disp: float,
                          row_tol: float = 2.0, level_scales=None):
    """[Nl, Nr] candidate mask of rectified-stereo matching: same row
    (within row_tol, scaled by the left keypoint's level), disparity in
    [min_disp, max_disp], levels within 1, both keypoints valid."""
    dv = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    if level_scales is not None:
        scales = torch.as_tensor(level_scales, dtype=torch.float32,
                                 device=uv_l.device)
        row_ok = dv <= row_tol * _level_lookup(scales, level_l)[:, None]
    else:
        row_ok = dv <= row_tol
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    lvl_ok = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    return row_ok & disp_ok & lvl_ok & valid_l[:, None] & valid_r[None, :]


def search_stereo_rectified(uv_l, level_l, desc_l, valid_l,
                            uv_r, level_r, desc_r, valid_r, *,
                            min_disp: float, max_disp: float,
                            row_tol: float = 2.0, max_dist: int = TH_HIGH,
                            level_scales=None):
    """Rectified-stereo matching: same-row search with disparity bounds and
    Hamming best match.  Returns (u_right [Nl] f32, <0 unmatched;
    idx_r [Nl] int32, -1 unmatched)."""
    mask = stereo_candidate_mask(uv_l, level_l, valid_l, uv_r, level_r,
                                 valid_r, min_disp=min_disp,
                                 max_disp=max_disp, row_tol=row_tol,
                                 level_scales=level_scales)
    best_idx, best, _, col_best = _best2(desc_l, desc_r, mask)
    ok = best <= max_dist
    ok = _mutual(col_best, best_idx, ok)
    u_r = uv_r[best_idx.clamp_min(0).long(), 0]
    return (torch.where(ok, u_r, torch.full_like(u_r, -1.0)),
            torch.where(ok, best_idx, -1).int())


def fuse_candidates(proj_uv, proj_level, proj_desc, proj_valid,
                    kp_uv, kp_level, kp_desc, kp_valid, *,
                    radius: float, level_scales, max_dist: int = TH_LOW):
    """Fuse search: search_by_projection with the tighter distance gate."""
    return search_by_projection(
        proj_uv, proj_level, proj_desc, proj_valid,
        kp_uv, kp_level, kp_desc, kp_valid,
        radius=radius, level_scales=level_scales, max_dist=max_dist,
        ratio=1.0)
