"""FAST-9/16 + 3x3 NMS + threshold blend for one pyramid level (kernel B1).

`fast_nms_blend` replaces vieo_slam_tpu/ops/pallas_fast.py:fast_nms_blend.
On a CUDA tensor it launches the hand-written kernel in
`csrc/fast_nms.cu`; on a CPU tensor it runs the plain PyTorch composition
below (`fast_nms_blend_plain`), which is also what the kernel is held to,
bit for bit.

What bounds it on the H100 and what the design does about it: see the
note at the top of `csrc/fast_nms.cu` (operation-bound, one pass over
shared-memory tiles, no [16, H, W] circle stack in device memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

# 16-point Bresenham circle of radius 3 (clockwise from 12 o'clock),
# (dx, dy) with x right / y down -- the standard FAST-9/16 test set.
FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def fast_score_maps(img: torch.Tensor, thresholds) -> list[torch.Tensor]:
    """FAST-9/16 response maps [H, W] at several thresholds; 0 where not a
    corner.  Response: max of summed positive / negative exceedances.

    The 16 exceedances are summed in circle order, one add at a time, so
    the result is the same f32 value the kernel computes."""
    h, w = img.shape[-2:]
    padded = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    diffs = [padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
             for dx, dy in FAST_CIRCLE.tolist()]
    out = []
    for th in thresholds:
        th = float(th)
        above = torch.stack([d > th for d in diffs])
        below = torch.stack([d < -th for d in diffs])
        is_corner = _arc9(above) | _arc9(below)
        sb = torch.zeros_like(img)
        sd = torch.zeros_like(img)
        for d in diffs:
            sb = sb + torch.clamp_min(d - th, 0.0)
            sd = sd + torch.clamp_min(-d - th, 0.0)
        score = torch.maximum(sb, sd)
        out.append(torch.where(is_corner, score, torch.zeros_like(score)))
    return out


def _arc9(m: torch.Tensor) -> torch.Tensor:
    """Any run of >= 9 consecutive True among 16 circular positions
    ([16, H, W] -> [H, W]), by the doubling trick."""
    r = m & torch.roll(m, -1, 0)
    r = r & torch.roll(r, -2, 0)
    r = r & torch.roll(r, -4, 0)
    r = r & torch.roll(m, -8, 0)
    return r.any(dim=0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (out-of-image neighbours ignored)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def fast_nms_blend_plain(img: torch.Tensor, th_hi: float, th_lo: float,
                         boost: float = 1e4) -> torch.Tensor:
    """where(nms3(hi) > 0, nms3(hi) + boost, nms3(lo)) -- plain PyTorch."""
    s_hi, s_lo = fast_score_maps(img, (th_hi, th_lo))
    n_hi = nms3(s_hi)
    n_lo = nms3(s_lo)
    return torch.where(n_hi > 0, n_hi + boost, n_lo)


def fast_nms_blend(img: torch.Tensor, th_hi: float, th_lo: float,
                   boost: float = 1e4) -> torch.Tensor:
    """Blended keypoint-score map [H, W] f32 of one pyramid level."""
    if not img.is_cuda:
        return fast_nms_blend_plain(img, th_hi, th_lo, boost)
    cuda_build.require(img, "img", torch.float32, (None, None))
    H, W = img.shape
    out = torch.empty_like(img)
    lib = cuda_build.library("fast_nms.cu")
    rc = lib.vs_fast_nms_blend(img.data_ptr(), out.data_ptr(), H, W,
                               float(th_hi), float(th_lo), float(boost),
                               cuda_build.stream_of(img))
    cuda_build.check(rc, "fast_nms_blend")
    cuda_build.LAUNCHES["fast_nms_blend"] += 1
    return out
