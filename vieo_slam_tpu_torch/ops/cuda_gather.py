"""Square patch gather around integer centers (kernel B2).

`gather_patches_multi` replaces vieo_slam_tpu/ops/pallas_gather.py:
gather_patches_kernel for a list of (level image, centers) entries -- all
levels of all images of a frame -- in one launch; `gather_patches` is its
one-entry case.  On CUDA tensors they launch the hand-written kernel in
`csrc/gather.cu`; on CPU tensors they run the plain indexing below
(`gather_patches_plain`, entry by entry), which the kernel matches exactly
(every output is a copied f32 input).

Centers are clamped into the image first and taps clamp to the edge --
for in-image centers (the only ones the pipeline produces) this is the
JAX package's exact `gather_patches(mxu=False)`.

What bounds it on the H100 and what the design does about it: see the
note at the top of `csrc/gather.cu` (byte-bound; one launch, a block of 8
warps per keypoint walking window rows, no divide, no padded image copy).
"""

from __future__ import annotations

from array import array

import torch

from . import cuda_build

MAX_LEVELS = 32                # (level, image) entries per launch (levels.cuh)


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


def gather_patches_multi_plain(level_imgs: list, level_uvs: list,
                               radius: int) -> list[torch.Tensor]:
    """gather_patches_plain, entry by entry."""
    return [gather_patches_plain(im, uv, radius)
            for im, uv in zip(level_imgs, level_uvs)]


def level_table(level_imgs: list, level_uvs: list):
    """(table, counts) of CUDA entries, after checking them: the table of
    csrc/levels.cuh, rows (image pointer, centers pointer, H, W, count) of
    64-bit integers, and the count of each entry.  One pass over the
    entries; a bad one is named by `cuda_build.require_all`."""
    dev = level_imgs[0].device
    f32, i32 = torch.float32, torch.int32
    rows, counts = [], []
    for im, uv in zip(level_imgs, level_uvs):
        hw, n2 = im.shape, uv.shape
        if not (len(hw) == 2 and len(n2) == 2 and n2[1] == 2 and hw[0]
                and hw[1] and im.dtype is f32 and uv.dtype is i32
                and im.device == dev and uv.device == dev
                and im.is_contiguous() and uv.is_contiguous()):
            cuda_build.require_all(level_imgs, "level_imgs", f32,
                                   (None, None), dev)
            cuda_build.require_all(level_uvs, "level_uvs", i32, (None, 2),
                                   dev)
            empty = next(i for i, x in enumerate(level_imgs) if not x.numel())
            raise ValueError(f"level_imgs[{empty}]: image is empty")
        rows += (im.data_ptr(), uv.data_ptr(), hw[0], hw[1], n2[0])
        counts.append(n2[0])
    return array("q", rows), counts


def launches(table: array, counts: list):
    """(table address, entries, first keypoint) of each launch: up to 32
    entries a launch; a launch with no keypoint is left out."""
    base, k0 = table.buffer_info()[0], 0
    for a in range(0, len(counts), MAX_LEVELS):
        n = sum(counts[a:a + MAX_LEVELS])
        if n:
            yield base + 40 * a, len(counts[a:a + MAX_LEVELS]), k0
        k0 += n


def gather_patches_flat(level_imgs: list, level_uvs: list,
                        radius: int) -> torch.Tensor:
    """[sum n_l, 2r+1, 2r+1] f32: the patches of every entry, entry after
    entry, in one buffer; one kernel launch for up to 32 entries.  The
    lists must not be empty."""
    if len(level_imgs) != len(level_uvs):
        raise ValueError("level_imgs and level_uvs differ in length")
    if not level_imgs[0].is_cuda:
        return torch.cat(gather_patches_multi_plain(level_imgs, level_uvs,
                                                    radius))
    table, counts = level_table(level_imgs, level_uvs)
    d = 2 * int(radius) + 1
    out = torch.empty((sum(counts), d, d), dtype=torch.float32,
                      device=level_imgs[0].device)
    if not out.shape[0]:
        return out
    lib = cuda_build.library("gather.cu")
    stream = cuda_build.stream_of(out)
    for rows, n_rows, k0 in launches(table, counts):
        with cuda_build.on_device(out):
            rc = lib.vs_gather_patches_multi(rows, n_rows,
                                             out.data_ptr() + 4 * d * d * k0,
                                             int(radius), stream)
        cuda_build.check(rc, "gather_patches")
        cuda_build.LAUNCHES["gather_patches"] += 1
    return out


def gather_patches_multi(level_imgs: list, level_uvs: list,
                         radius: int) -> list[torch.Tensor]:
    """[(n_l, 2r+1, 2r+1) f32 patches, ...] per entry: level_imgs [H_l, W_l]
    f32, level_uvs [n_l, 2] int32 centers (x, y).  On the GPU one launch
    covers up to 32 entries and the results are views of one buffer."""
    if len(level_imgs) != len(level_uvs):
        raise ValueError("level_imgs and level_uvs differ in length")
    if not level_imgs:
        return []
    if not level_imgs[0].is_cuda:
        return gather_patches_multi_plain(level_imgs, level_uvs, radius)
    flat = gather_patches_flat(level_imgs, level_uvs, radius)
    return list(flat.split([int(uv.shape[0]) for uv in level_uvs]))


def gather_patches(img: torch.Tensor, centers: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """[N, 2r+1, 2r+1] f32 patches; img [H, W] f32, centers [N, 2] int32:
    the one-entry case of `gather_patches_multi`."""
    return gather_patches_multi([img], [centers], radius)[0]
