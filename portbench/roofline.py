"""The least time each hand-written kernel could take, from its shapes.

A copy of chip_smoke.py's `bound()` and of its byte and operation counts of
kernels B1-B4 (the phase-3 arithmetic), against the published peaks of one
H100 SXM at its 700 W limit: 3.35 TB/s of HBM3 and 67 TFLOP/s in f32
outside the tensor cores (no kernel here uses them; their 32-bit integer
operations count against the same rate, which the card's int32 rate does
not exceed).  Each input byte counts once, each output byte once; where the
work follows the data (B1's reject, the candidate cells of B3 and B4), the
count is what these inputs need.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# B1: FAST-9/16 at two thresholds + 3x3 NMS + blend, for the least
# implementation, whose work follows the data:
#  - every pixel: the compass reject (any 9 consecutive circle positions
#    hold two of the taps 0, 4, 8, 12): 4 differences, 8 comparisons, 6
#    adds, 2 comparisons and an or;
#  - every pixel that passes it: the other 12 differences and, per
#    threshold, 32 comparisons, 32 ops packing them into two 16-bit masks
#    and 24 for the two 9-run tests by doubling;
#  - every corner, per threshold: 96 for the exceedance sums, their max, 8
#    max + compare + select for the NMS, compare + add + select for the
#    blend.
B1_REJECT_OPS = 4 + 8 + 6 + 2 + 1
B1_TEST_OPS = 12 + 2 * (32 + 32 + 24)
B1_SCORE_OPS = 96 + 1 + 10 + 3
# Per candidate pair of the Hamming best-2: 8 XOR, 8 popcount, 7 adds, the
# row best/second update (3) and the column minimum (1).
HAMMING_OPS = 27
# Per pair of B4's projection window + level gate: 2 sub, 2 mul, add,
# compare, level sub + abs + compare, 2 ands.
WINDOW_OPS = 11

# The kernels' names in the profiler's trace (csrc/*.cu).
KERNELS = {"B1": "fast_nms_blend_kernel", "B2": "gather_patches_kernel",
           "B3": "best2_kernel<false", "B4": "best2_kernel<true"}

_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
           (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
           (-2, -2), (-1, -3)]


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _arc9(m: torch.Tensor) -> torch.Tensor:
    r = m & torch.roll(m, -1, 0)
    r = r & torch.roll(r, -2, 0)
    r = r & torch.roll(r, -4, 0)
    r = r & torch.roll(m, -8, 0)
    return r.any(dim=0)


def b1_work(levels, th_hi: float, th_lo: float):
    """(pixels, pixels that pass the compass reject at the lower threshold,
    corners summed over the two thresholds) of a list of level images:
    what B1's operations follow."""
    px = survivors = corners = 0
    th = min(th_hi, th_lo)
    for im in levels:
        im = im.float()
        h, w = im.shape
        p = F.pad(im[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
        d = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - im
                         for dx, dy in _CIRCLE])
        taps = d[[0, 4, 8, 12]]
        keep = ((taps > th).sum(0) >= 2) | ((taps < -th).sum(0) >= 2)
        px += im.numel()
        survivors += int(keep.sum())
        for t in (th_hi, th_lo):
            corners += int((_arc9(d > t) | _arc9(d < -t)).sum())
    return px, survivors, corners


def b1(levels, th_hi, th_lo):
    px, survivors, corners = b1_work(levels, th_hi, th_lo)
    return bound(8 * px, B1_REJECT_OPS * px + B1_TEST_OPS * survivors
                 + B1_SCORE_OPS * corners)


def b2(levels, uvs, radius: int):
    px = sum(int(im.numel()) for im in levels)
    n_kp = sum(int(uv.shape[0]) for uv in uvs)
    d = 2 * radius + 1
    return bound(4 * px + 8 * n_kp + 4 * n_kp * d * d, 0)


def b3(M: int, N: int, candidates: int):
    return bound(32 * (M + N) + M * N + 4 * (3 * M + N),
                 M * N + HAMMING_OPS * candidates)


def b4(LC: int, N: int, candidates: int):
    return bound(32 * (LC + N) + 20 * LC + 16 * N + 4 * (3 * LC + N),
                 WINDOW_OPS * LC * N + HAMMING_OPS * candidates)


def projection_candidates(uv_a, radius_a, level_a, valid_a, uv_b, level_b,
                          valid_b, level_tolerance) -> int:
    """B4's candidate cells: pixel window, level gate, validity."""
    r = torch.where(valid_a, radius_a.float(), torch.full_like(radius_a, -1.0))
    du = uv_a[:, 0, None] - uv_b[None, :, 0]
    dv = uv_a[:, 1, None] - uv_b[None, :, 1]
    within = du * du + dv * dv <= (r * r)[:, None]
    lvl_ok = torch.abs(level_a.float()[:, None] - level_b.float()[None, :]) \
        <= float(level_tolerance)
    return int((within & lvl_ok & (r[:, None] >= 0) & valid_b[None, :]).sum())


class Recorder:
    """Records the inputs of the kernel wrappers' calls while `on`, and
    works out each call's bound afterwards.  install() wraps the program's
    use sites of B1-B4 (ops.orb and ops.matching)."""

    def __init__(self):
        self.on = False
        self.calls = []          # (kernel, thunk giving (bound_ms, by))

    def install(self, orb_mod, matching_mod):
        fast0 = orb_mod.fast_nms_blend_multi
        gather0 = orb_mod.gather_patches_flat
        best0 = matching_mod.fused_best2
        proj0 = matching_mod.fused_projection_best2

        def fast(levels, th_hi, th_lo, *a, **k):
            if self.on:
                self.calls.append(("B1", lambda l=list(levels): b1(
                    l, th_hi, th_lo)))
            return fast0(levels, th_hi, th_lo, *a, **k)

        def gather(levels, uvs, radius):
            if self.on:
                self.calls.append(("B2", lambda l=list(levels), u=list(uvs):
                                   b2(l, u, radius)))
            return gather0(levels, uvs, radius)

        def best2(desc_a, desc_b, mask):
            if self.on:
                self.calls.append(("B3", lambda: b3(
                    desc_a.shape[0], desc_b.shape[0], int(mask.sum()))))
            return best0(desc_a, desc_b, mask)

        def proj(desc_a, desc_b, *args):
            if self.on:
                self.calls.append(("B4", lambda: b4(
                    desc_a.shape[0], desc_b.shape[0],
                    projection_candidates(*args))))
            return proj0(desc_a, desc_b, *args)

        orb_mod.fast_nms_blend_multi = fast
        orb_mod.gather_patches_flat = gather
        matching_mod.fused_best2 = best2
        matching_mod.fused_projection_best2 = proj

    def bounds(self) -> dict:
        """{kernel: (calls, summed bound ms, bound_by of the last)}."""
        out = {}
        for kernel, thunk in self.calls:
            ms, by = thunk()
            n, tot, _ = out.get(kernel, (0, 0.0, by))
            out[kernel] = (n + 1, tot + ms, by)
        return out
