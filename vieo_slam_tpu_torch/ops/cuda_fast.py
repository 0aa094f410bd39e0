"""FAST-9/16 + 3x3 NMS + threshold blend of pyramid levels (kernel B1).

`fast_nms_blend` replaces vieo_slam_tpu/ops/pallas_fast.py:fast_nms_blend;
`fast_nms_blend_multi` is the same for a list of images (all levels of all
images of a frame) in one launch.  On CUDA tensors they launch the
hand-written kernel in `csrc/fast_nms.cu`; on CPU tensors they run the
plain PyTorch composition below (`fast_nms_blend_plain`, level by level),
which is also what the kernel is held to, bit for bit.

What bounds it on the H100 and what the design does about it: see the
note at the top of `csrc/fast_nms.cu` (one launch, a cheap reject and the
corner test before the score, no [16, H, W] circle stack in device
memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

MAX_LEVELS = 32                # images per launch (fast_nms.cu)

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


def fast_nms_blend_multi_plain(level_imgs: list, th_hi: float, th_lo: float,
                               boost: float = 1e4) -> list[torch.Tensor]:
    """fast_nms_blend_plain, level by level."""
    return [fast_nms_blend_plain(im, th_hi, th_lo, boost) for im in level_imgs]


def fast_nms_blend_multi(level_imgs: list, th_hi: float, th_lo: float,
                         boost: float = 1e4) -> list[torch.Tensor]:
    """Blended keypoint-score maps [H_l, W_l] f32 of a list of images (the
    pyramid levels of one image, or of several): one kernel launch for up
    to 32 of them.  On the GPU the maps are views of one allocation."""
    if not level_imgs:
        return []
    if not level_imgs[0].is_cuda:
        return fast_nms_blend_multi_plain(level_imgs, th_hi, th_lo, boost)
    dev = level_imgs[0].device
    cuda_build.require_all(level_imgs, "level_imgs", torch.float32,
                           (None, None), dev)
    sizes = [im.shape[0] * im.shape[1] for im in level_imgs]
    if 0 in sizes:
        raise ValueError(f"level_imgs[{sizes.index(0)}]: image is empty")
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    lib = cuda_build.library("fast_nms.cu")
    stream = cuda_build.stream_of(flat)
    base, o = flat.data_ptr(), 0
    for a in range(0, len(level_imgs), MAX_LEVELS):
        chunk = level_imgs[a:a + MAX_LEVELS]
        table = np.array([(im.data_ptr(), im.shape[0], im.shape[1])
                          for im in chunk], dtype=np.int64)
        with cuda_build.on_device(flat):
            rc = lib.vs_fast_nms_blend_multi(
                table.ctypes.data, len(chunk), base + 4 * o, float(th_hi),
                float(th_lo), float(boost), stream)
        cuda_build.check(rc, "fast_nms_blend")
        cuda_build.LAUNCHES["fast_nms_blend"] += 1
        o += sum(sizes[a:a + MAX_LEVELS])
    return [m.view(im.shape) for m, im in zip(flat.split(sizes), level_imgs)]


def fast_nms_blend(img: torch.Tensor, th_hi: float, th_lo: float,
                   boost: float = 1e4) -> torch.Tensor:
    """Blended keypoint-score map [H, W] f32 of one pyramid level: the
    one-image case of `fast_nms_blend_multi`."""
    return fast_nms_blend_multi([img], th_hi, th_lo, boost)[0]
