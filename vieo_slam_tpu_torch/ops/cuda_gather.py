"""Square patch gather around integer centers (kernel B2).

`gather_patches` replaces vieo_slam_tpu/ops/pallas_gather.py:
gather_patches_kernel.  On a CUDA tensor it launches the hand-written
kernel in `csrc/gather.cu`; on a CPU tensor it runs the plain indexing
below (`gather_patches_plain`), which the kernel matches exactly (every
output is a copied f32 input).

Centers are clamped into the image first and taps clamp to the edge --
for in-image centers (the only ones the pipeline produces) this is the
JAX package's exact `gather_patches(mxu=False)`.

What bounds it on the H100 and what the design does about it: see the
note at the top of `csrc/gather.cu` (byte-bound, one block per keypoint,
clamp folded into the index arithmetic, no padded image copy).
"""

from __future__ import annotations

import torch

from . import cuda_build


def gather_patches_plain(img: torch.Tensor, centers: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """[N, 2r+1, 2r+1] patches of img [H, W] around centers [N, 2] (x, y)."""
    H, W = img.shape
    d = 2 * radius + 1
    off = torch.arange(d, device=img.device) - radius
    cx = centers[:, 0].long().clamp(0, W - 1)
    cy = centers[:, 1].long().clamp(0, H - 1)
    rows = (cy[:, None] + off[None, :]).clamp(0, H - 1)
    cols = (cx[:, None] + off[None, :]).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def gather_patches(img: torch.Tensor, centers: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """[N, 2r+1, 2r+1] f32 patches; img [H, W] f32, centers [N, 2] int32."""
    if not img.is_cuda:
        return gather_patches_plain(img, centers, radius)
    cuda_build.require(img, "img", torch.float32, (None, None))
    cuda_build.require(centers, "centers", torch.int32, (None, 2), img.device)
    H, W = img.shape
    N = centers.shape[0]
    d = 2 * radius + 1
    out = torch.empty((N, d, d), dtype=torch.float32, device=img.device)
    if N == 0:
        return out
    lib = cuda_build.library("gather.cu")
    rc = lib.vs_gather_patches(img.data_ptr(), centers.data_ptr(),
                               out.data_ptr(), H, W, N, int(radius),
                               cuda_build.stream_of(img))
    cuda_build.check(rc, "gather_patches")
    cuda_build.LAUNCHES["gather_patches"] += 1
    return out
