"""Masked Hamming best-2 (kernel B3) and projection-search best-2 (B4).

`fused_best2` replaces vieo_slam_tpu/ops/pallas_matching.py:fused_best2
and `fused_projection_best2` replaces its fused_projection_best2.  On CUDA
tensors they launch the hand-written kernels in `csrc/matching.cu`; on
CPU tensors they run the plain PyTorch versions below, which the kernels
match exactly (integer outputs).

Descriptors are int32 [.., 8] tensors holding the bits of the JAX
package's uint32 words (PyTorch cannot shift uint32 on the CPU).

Contract of both (the Pallas kernels'): returns (best_idx [M] i32,
best [M] i32, second [M] i32, col_best_row [N] i32).  Rows without a
candidate give best = second = 1 << 30 and best_idx = 0; ties break to
the lowest index, on rows and on columns; a column without a candidate
gives col_best_row = 0.  On the GPU the four results are views of one
allocation.

What bounds them on the H100 and what the design does about it: see the
note at the top of `csrc/matching.cu`.
"""

from __future__ import annotations

import torch

from . import cuda_build

INF = 1 << 30
_ROW_BITS = 22          # packed column key: (dist << 22) | row


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 element, as int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[M, 8] x [N, 8] int32 descriptor bits -> [M, N] int32 distances."""
    M, N = desc_a.shape[0], desc_b.shape[0]
    dist = torch.zeros((M, N), dtype=torch.int64, device=desc_a.device)
    for w in range(desc_a.shape[1]):
        dist += popcount32(desc_a[:, w, None] ^ desc_b[None, :, w])
    return dist.int()


def best2_plain(dist: torch.Tensor, mask: torch.Tensor):
    """Row best/second/argbest and column best row over a masked [M, N]
    distance matrix, ties to the lowest index."""
    M, N = dist.shape
    dev = dist.device
    d = torch.where(mask, dist.long(), torch.full_like(dist, INF).long())
    if M == 0 or N == 0:
        return _empty_result(M, N, dev)
    cols = torch.arange(N, device=dev)
    rows = torch.arange(M, device=dev)
    best = d.min(dim=1).values
    ibest = torch.where(d == best[:, None], cols[None, :], N).min(dim=1).values
    d2 = torch.where(cols[None, :] == ibest[:, None], INF, d)
    second = d2.min(dim=1).values
    cmin = d.min(dim=0).values
    crow = torch.where(d == cmin[None, :], rows[:, None], M).min(dim=0).values
    return ibest.int(), best.int(), second.int(), crow.int()


def fused_best2_plain(desc_a, desc_b, mask):
    return best2_plain(hamming_matrix(desc_a, desc_b), mask)


def projection_mask(uv_a, radius_a, level_a, valid_a, uv_b, level_b, valid_b,
                    level_tolerance):
    """[M, N] candidate mask of search_by_projection: pixel window of
    per-row radius (du*du + dv*dv <= r*r), level gate, validity."""
    r = torch.where(valid_a, radius_a.float(), torch.full_like(radius_a, -1.0))
    du = uv_a[:, 0, None] - uv_b[None, :, 0]
    dv = uv_a[:, 1, None] - uv_b[None, :, 1]
    within = du * du + dv * dv <= (r * r)[:, None]
    lvl_ok = torch.abs(level_a.float()[:, None] - level_b.float()[None, :]) \
        <= float(level_tolerance)
    return within & lvl_ok & (r[:, None] >= 0) & valid_b[None, :]


def fused_projection_best2_plain(desc_a, desc_b, uv_a, radius_a, level_a,
                                 valid_a, uv_b, level_b, valid_b,
                                 level_tolerance):
    mask = projection_mask(uv_a, radius_a, level_a, valid_a, uv_b, level_b,
                           valid_b, level_tolerance)
    return best2_plain(hamming_matrix(desc_a, desc_b), mask)


def _empty_result(M, N, dev):
    """The contract's answer when one side has no rows: no candidates."""
    big = torch.full((M,), INF, dtype=torch.int32, device=dev)
    return (torch.zeros(M, dtype=torch.int32, device=dev), big, big.clone(),
            torch.zeros(N, dtype=torch.int32, device=dev))


def _outputs(M, N, dev):
    """(idx, best, second, col_best_row) as views of one allocation, and
    the allocation."""
    buf = torch.empty(3 * M + N, dtype=torch.int32, device=dev)
    return buf.split((M, M, M, N)), buf


def _native(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` as the kernel reads it.  A tensor of the kernel's dtype that is
    contiguous passes through untouched; any other is cast or copied here,
    at the caller's cost."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _check_rows(M):
    if M > (1 << _ROW_BITS):
        raise ValueError(f"{M} rows exceed the packed column key "
                         f"({1 << _ROW_BITS})")


def fused_best2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                mask: torch.Tensor):
    """Masked Hamming + row best2 + column best row.

    desc_a [M, 8] int32, desc_b [N, 8] int32, mask [M, N] bool; any number
    of columns (the kernel tiles them)."""
    if not desc_a.is_cuda:
        return fused_best2_plain(desc_a, desc_b, mask)
    dev = desc_a.device
    M, N = mask.shape
    cuda_build.require(desc_a, "desc_a", torch.int32, (M, 8), dev)
    cuda_build.require(desc_b, "desc_b", torch.int32, (N, 8), dev)
    cuda_build.require(mask, "mask", torch.bool, (M, N), dev)
    _check_rows(M)
    if M == 0 or N == 0:
        return _empty_result(M, N, dev)
    out, buf = _outputs(M, N, dev)
    lib = cuda_build.library("matching.cu")
    with cuda_build.on_device(desc_a):
        rc = lib.vs_fused_best2(desc_a.data_ptr(), desc_b.data_ptr(),
                                mask.data_ptr(), M, N, buf.data_ptr(),
                                cuda_build.stream_of(desc_a))
    cuda_build.check(rc, "fused_best2")
    cuda_build.LAUNCHES["fused_best2"] += 1
    return out


def fused_projection_best2(desc_a, desc_b, uv_a, radius_a, level_a, valid_a,
                           uv_b, level_b, valid_b, level_tolerance):
    """search_by_projection's candidate scoring: window + level gate +
    masked Hamming + row best2 + column best row, with the [M, N] mask
    built inside the kernel.

    radius_a [M] f32 is the per-row pixel radius (already level-scaled).
    The kernel reads the arguments as they come -- uv and radius f32,
    levels int32, valid flags bool -- and everything around it (validity,
    column keys, unpacking) happens on the device in the same call.  A uv,
    radius or level tensor of another dtype or a non-contiguous one is cast
    or copied first; the flags must be bool, as the plain version needs
    them."""
    if not desc_a.is_cuda:
        return fused_projection_best2_plain(
            desc_a, desc_b, uv_a, radius_a, level_a, valid_a, uv_b, level_b,
            valid_b, level_tolerance)
    dev = desc_a.device
    M, N = desc_a.shape[0], desc_b.shape[0]
    cuda_build.require(desc_a, "desc_a", torch.int32, (M, 8), dev)
    cuda_build.require(desc_b, "desc_b", torch.int32, (N, 8), dev)
    _check_rows(M)
    side = []           # holds a cast copy until the launch is enqueued
    for t, name, dtype, shape in (
            (uv_a, "uv_a", torch.float32, (M, 2)),
            (radius_a, "radius_a", torch.float32, (M,)),
            (level_a, "level_a", torch.int32, (M,)),
            (valid_a, "valid_a", torch.bool, (M,)),
            (uv_b, "uv_b", torch.float32, (N, 2)),
            (level_b, "level_b", torch.int32, (N,)),
            (valid_b, "valid_b", torch.bool, (N,))):
        if dtype != torch.bool:             # the flags must come as bool
            t = _native(t, dtype)
        cuda_build.require(t, name, dtype, shape, dev)
        side.append(t)
    if M == 0 or N == 0:
        return _empty_result(M, N, dev)
    out, buf = _outputs(M, N, dev)
    lib = cuda_build.library("matching.cu")
    with cuda_build.on_device(desc_a):
        rc = lib.vs_fused_projection_best2(
            desc_a.data_ptr(), desc_b.data_ptr(),
            *(t.data_ptr() for t in side), float(level_tolerance), M, N,
            buf.data_ptr(), cuda_build.stream_of(desc_a))
    cuda_build.check(rc, "fused_projection_best2")
    cuda_build.LAUNCHES["fused_projection_best2"] += 1
    return out
