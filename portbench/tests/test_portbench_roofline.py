"""The benchmark's copy of the kernels' bounds reproduces PERF.md's bound
column at the full-width shapes (752x480, 8 levels, 1200 keypoints)."""

from portbench import roofline


def _levels():
    h, w = 480, 752
    sizes = [(h, w)]
    for lv in range(1, 8):
        s = 1.2 ** lv
        sizes.append((round(h / s), round(w / s)))
    return sizes


def test_bound_column():
    px = sum(h * w for h, w in _levels())
    # B1: one image's 8 levels; bytes bound it (the reject's operations
    # fall far below).
    b1, by1 = roofline.bound(8 * px, roofline.B1_REJECT_OPS * px)
    b2, by2 = roofline.bound(4 * px + 8 * 1200 + 4 * 1200 * 53 * 53, 0)
    b3, by3 = roofline.b3(1200, 1200, 0)
    b4, by4 = roofline.b4(4096, 1200, 0)
    assert (round(b1, 4), by1) == (0.0027, "bytes")
    assert (round(b2, 4), by2) == (0.0054, "bytes")
    assert (round(b3, 4), by3) == (0.0005, "bytes")
    assert (round(b4, 4), by4) == (0.0008, "operations")


def test_b2_helper_counts_the_same_bytes():
    import torch
    levels = [torch.zeros(h, w) for h, w in _levels()]
    uvs = [torch.zeros(150, 2) for _ in levels]
    assert roofline.b2(levels, uvs, 26)[0] == roofline.bound(
        4 * sum(h * w for h, w in _levels()) + 8 * 1200
        + 4 * 1200 * 53 * 53, 0)[0]
