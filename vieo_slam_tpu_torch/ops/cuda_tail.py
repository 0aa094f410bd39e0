"""The whole ORB keypoint tail for all pyramid levels at once (kernel B5).

`tail_fused_multi` replaces vieo_slam_tpu/ops/pallas_tail.py:
tail_fused_multi_kernel (and tail_fused_kernel, its one-level form).  Per
keypoint: a 53x53 edge-clamped window of its level image, the
intensity-centroid moments over the central 31x31 disc, a separable 7-tap
Gaussian inside the window (53 -> 47), the 256 rotated-BRIEF pair taps and
the bit compare.  On CUDA tensors it launches the hand-written kernel in
`csrc/tail.cu`, once for all levels; on CPU tensors it runs
`tail_fused_multi_plain` below.  There is no fallback: a build or launch
failure raises.

Arithmetic, the same in the kernel and the plain version (they agree bit
for bit wherever atan2 does):
  - window: the center is clamped into its own level image and every tap
    clamps to that image's edge (kernel B2's rule; equal to the JAX
    package's padded atlas for every in-image center);
  - moments: products patch * (mask * coord), zero-padded from 961 to 1024
    and summed by a fixed halving tree (s[i] += s[i + half]);
  - rotation: cos = m10 / r and sin = m01 / r with r = sqrt(m10^2 + m01^2)
    (the Pallas kernel's choice, here with a correctly rounded sqrt and
    divide; cos = 1, sin = 0 when r = 0).  The plain PyTorch tail of
    ops/orb.py rotates with cos(atan2(..)), an ulp away, which can move a
    tap across a rounding boundary;
  - the angle returned is atan2(m01, m10);
  - blur: rows then columns, 7 taps accumulated left to right, each
    product and sum rounded to f32 on its own (no fused multiply-add);
  - taps: round half to even, clamp into the 47x47 blurred patch; bit =
    first tap < second tap; 32 bits a word, bit j of word w is pair
    32 w + j; words leave as int32 bit patterns.

What bounds the kernel on the H100 and what its design does about it: see
the note at the top of `csrc/tail.cu`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .cuda_gather import gather_patches_plain, launches, level_table
from .orb import (BRIEF_PATTERN, DESC_WORDS, PATCH_RADIUS, _TAIL_R,
                  _blur7_patch, _disc_mask, _gauss7, brief_from_rotation)

_TREE = 1024                   # moment products, zero-padded


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) by halving, the kernel's
    order: s[i] += s[i + half] for half = n/2 .. 1."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def moment_weights() -> np.ndarray:
    """[2, 961] f32: mask * dx and mask * dy over the 31x31 centre, row
    major -- the weights of m10 and m01."""
    mask = _disc_mask(PATCH_RADIUS)
    coords = np.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, dtype=np.float32)
    return np.stack([(mask * coords[None, :]).reshape(-1),
                     (mask * coords[:, None]).reshape(-1)])


def moments_plain(big: torch.Tensor):
    """(m10, m01) of [N, 53, 53] windows over the central 31x31 disc."""
    c0, d = _TAIL_R - PATCH_RADIUS, 2 * PATCH_RADIUS + 1
    cen = big[:, c0:c0 + d, c0:c0 + d].reshape(-1, d * d)
    pad = (0, _TREE - d * d)
    out = []
    for w in moment_weights():
        prod = cen * torch.from_numpy(w).to(big.device)
        out.append(_tree_sum(torch.nn.functional.pad(prod, pad)))
    return out[0], out[1]


def tail_from_big_plain(big: torch.Tensor):
    """(angle [N], desc [N, 8] int32) from [N, 53, 53] raw windows, in the
    kernel's arithmetic."""
    m10, m01 = moments_plain(big)
    r = torch.sqrt(m10 * m10 + m01 * m01)
    pos = r > 0
    safe = torch.where(pos, r, torch.ones_like(r))
    ca = torch.where(pos, m10 / safe, torch.ones_like(r))
    sa = torch.where(pos, m01 / safe, torch.zeros_like(r))
    return torch.atan2(m01, m10), brief_from_rotation(_blur7_patch(big), ca, sa)


def tail_fused_multi_plain(level_imgs: list, level_uvs: list):
    """Plain PyTorch version of the kernel, level by level (so a level's
    result does not depend on what else is in the call).  Returns
    [(angle, desc), ...] per level."""
    out = []
    for im, uv in zip(level_imgs, level_uvs):
        if uv.shape[0] == 0:
            out.append((im.new_empty(0), torch.empty(
                (0, DESC_WORDS), dtype=torch.int32, device=im.device)))
        else:
            out.append(tail_from_big_plain(
                gather_patches_plain(im, uv, _TAIL_R)))
    return out


_TAPS = (ctypes.c_float * 7)(*_gauss7())      # the Gaussian taps, f32
_tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _tables_on(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's constant tables on `dev`, made once: the BRIEF pairs,
    [256, 4] f32 (x1, y1, x2, y2), and the moment weights, [2, 1024] f32
    (`moment_weights`, zero-padded)."""
    if dev not in _tables:
        w = np.zeros((2, _TREE), np.float32)
        w[:, :961] = moment_weights()
        _tables[dev] = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                             for x in (BRIEF_PATTERN.reshape(-1, 4)
                                       .astype(np.float32), w))
    return _tables[dev]


def tail_fused_multi(level_imgs: list, level_uvs: list):
    """[(angle [n_l] f32, desc [n_l, 8] int32), ...] per level.

    level_imgs: [H_l, W_l] f32 images (pyramid levels of one image, or of
    several); level_uvs: [n_l, 2] int32 centers (x, y) in level pixels.
    One kernel launch covers up to 32 levels."""
    if len(level_imgs) != len(level_uvs):
        raise ValueError("level_imgs and level_uvs differ in length")
    if not level_imgs:
        return []
    if not level_imgs[0].is_cuda:
        return tail_fused_multi_plain(level_imgs, level_uvs)
    table, counts = level_table(level_imgs, level_uvs)
    dev = level_imgs[0].device
    angle = torch.empty(sum(counts), dtype=torch.float32, device=dev)
    desc = torch.empty((len(angle), DESC_WORDS), dtype=torch.int32,
                       device=dev)
    if len(angle):
        lib = cuda_build.library("tail.cu")
        pattern, weights = (x.data_ptr() for x in _tables_on(dev))
        stream = cuda_build.stream_of(angle)
        for rows, n_rows, k0 in launches(table, counts):
            with cuda_build.on_device(angle):
                rc = lib.vs_tail_fused(rows, n_rows, _TAPS, pattern, weights,
                                       angle.data_ptr() + 4 * k0,
                                       desc.data_ptr() + 4 * DESC_WORDS * k0,
                                       stream)
            cuda_build.check(rc, "tail_fused")
            cuda_build.LAUNCHES["tail_fused"] += 1
    return list(zip(angle.split(counts), desc.split(counts)))
