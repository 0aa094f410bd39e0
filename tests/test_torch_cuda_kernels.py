"""Kernels B1-B5 on the GPU against their plain PyTorch versions, at the
edge shapes that chip_smoke.py's main-path shapes do not reach: images
smaller than one tile, ragged tiles, many levels in one launch and more
than one launch takes, empty inputs, all-masked rows and columns, many
exact Hamming ties, more columns than one shared-memory tile, rows that do
not fill a block, every cell a candidate, inputs the wrapper has to cast;
for the patch gather B2 one entry, the 16 levels of a stereo pair, more
entries than one launch takes, empty entries, images smaller than the
window and centers off the image; for the tail kernel B5 one keypoint,
odd counts, one level, an empty level, more levels than one launch takes,
the 16 levels of a full-width stereo pair, centers on and outside the
border and an image as narrow as the window; and B1-B5 on every visible
GPU of a machine with two or more, while cuda:0 is the current device.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skip elsewhere.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerance: none for B1-B4 (B1 repeats the plain version's f32 adds in
the same order, B2 copies pixels, B3 and B4 return integers) and none for
B5's descriptors (every product and sum is rounded as in the plain
version, the moment sums run in the same tree order); B5's angles agree
to 1e-6 rad, the room two atan2 implementations may differ in.
"""

import numpy as np
import pytest
import torch

from vieo_slam_tpu_torch.ops import cuda_build, cuda_fast, cuda_gather
from vieo_slam_tpu_torch.ops import cuda_matching as cm
from vieo_slam_tpu_torch.ops import cuda_tail

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda", 0)


def assert_launched(name, fn):
    """fn() launches kernel `name` exactly once."""
    n0 = cuda_build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES[name] == n0 + 1
    return out


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 65), (134, 210),
                                   (481, 753)])
def test_fast_nms_blend(dev, shape):
    rng = np.random.RandomState(sum(shape))
    img = rng.rand(*shape).astype(np.float32) * 220 + 10
    img[rng.randint(0, shape[0], 40), rng.randint(0, shape[1], 40)] = 255.0
    x = torch.from_numpy(img).to(dev)
    got = assert_launched("fast_nms_blend",
                          lambda: cuda_fast.fast_nms_blend(x, 20.0, 7.0))
    want = cuda_fast.fast_nms_blend_plain(x, 20.0, 7.0)
    assert torch.equal(got, want)


FAST_MULTI_CASES = {
    # name: [(H, W), ...]
    "tiny_among_large": [(97, 131), (1, 1), (200, 310), (2, 3), (30, 30),
                         (31, 61)],
    "full_struct": [(20 + i, 45 - i) for i in range(32)],
    "two_launches": [(20 + i, 45 - i) for i in range(33)],
    "stereo_pair": [(round(120 / 1.2 ** lv), round(188 / 1.2 ** lv))
                    for lv in range(8) for _ in range(2)],
}


@pytest.mark.parametrize("case", sorted(FAST_MULTI_CASES))
def test_fast_nms_blend_multi(dev, case):
    rng = np.random.RandomState(len(case))
    imgs = []
    for H, W in FAST_MULTI_CASES[case]:
        img = rng.rand(H, W).astype(np.float32) * 220 + 10
        n = max(H * W // 50, 1)
        img[rng.randint(0, H, n), rng.randint(0, W, n)] = 255.0
        imgs.append(torch.from_numpy(img).to(dev))
    n0 = cuda_build.LAUNCHES["fast_nms_blend"]
    got = cuda_fast.fast_nms_blend_multi(imgs, 20.0, 7.0)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["fast_nms_blend"] - n0 \
        == -(-len(imgs) // cuda_fast.MAX_LEVELS)
    want = cuda_fast.fast_nms_blend_multi_plain(imgs, 20.0, 7.0)
    assert len(got) == len(want) == len(imgs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert any((g > 1e4).any() for g in got)


def test_fast_nms_blend_thresholds_swapped(dev):
    """th_hi < th_lo: the high test cannot be skipped where the low fails."""
    rng = np.random.RandomState(5)
    img = rng.rand(70, 90).astype(np.float32) * 220 + 10
    x = torch.from_numpy(img).to(dev)
    assert torch.equal(cuda_fast.fast_nms_blend(x, 7.0, 20.0),
                       cuda_fast.fast_nms_blend_plain(x, 7.0, 20.0))


def test_fast_nms_blend_rejects_bad_arguments(dev):
    img = torch.zeros((60, 80), device=dev)
    with pytest.raises(TypeError, match=r"level_imgs\[1\]"):
        cuda_fast.fast_nms_blend_multi([img, img.double()], 20.0, 7.0)
    with pytest.raises(ValueError, match=r"level_imgs\[1\]"):
        cuda_fast.fast_nms_blend_multi([img, img.T], 20.0, 7.0)
    with pytest.raises(ValueError, match=r"level_imgs\[1\]"):
        cuda_fast.fast_nms_blend_multi([img, img.cpu()], 20.0, 7.0)
    with pytest.raises(ValueError, match=r"level_imgs\[0\]"):
        cuda_fast.fast_nms_blend_multi([img[:0]], 20.0, 7.0)


@pytest.mark.parametrize("radius", [15, 26])
def test_gather_patches(dev, radius):
    rng = np.random.RandomState(radius)
    img = torch.from_numpy(rng.rand(61, 97).astype(np.float32)).to(dev)
    centers = np.concatenate([
        np.stack([rng.randint(-40, 140, 300), rng.randint(-40, 100, 300)], -1),
        [[0, 0], [96, 60], [-1, 60], [97, 61]]]).astype(np.int32)
    c = torch.from_numpy(centers).to(dev)
    got = assert_launched("gather_patches",
                          lambda: cuda_gather.gather_patches(img, c, radius))
    assert torch.equal(got, cuda_gather.gather_patches_plain(img, c, radius))
    empty = cuda_gather.gather_patches(img, c[:0], radius)
    assert empty.shape == (0, 2 * radius + 1, 2 * radius + 1)


GATHER_MULTI_CASES = {
    # name: [(H, W, n_centers), ...] per entry
    "one_entry": [(97, 131, 41)],
    "stereo_pair": [(round(480 / 1.2 ** lv), round(752 / 1.2 ** lv),
                     150 - 15 * lv) for _ in range(2) for lv in range(8)],
    "two_launches": [(40 + i, 70 - i, 1 + i % 5) for i in range(33)],
    "three_launches_empty": [(30 + i % 7, 50 + i % 11, 0 if i % 4 == 1
                              else 3) for i in range(70)],
    "all_empty": [(40, 50, 0), (30, 20, 0)],
    "smaller_than_window": [(20, 31, 6), (1, 1, 2), (53, 1, 3), (2, 60, 4)],
}


@pytest.mark.parametrize("case", sorted(GATHER_MULTI_CASES))
@pytest.mark.parametrize("radius", [15, 26])
def test_gather_patches_multi(dev, case, radius):
    rng = np.random.RandomState(len(case) + radius)
    imgs, uvs = [], []
    for H, W, n in GATHER_MULTI_CASES[case]:
        imgs.append(torch.from_numpy(
            rng.rand(H, W).astype(np.float32) * 255).to(dev))
        # centers inside, on the corners, and up to 40 pixels outside
        c = np.stack([rng.randint(-40, W + 40, n),
                      rng.randint(-40, H + 40, n)], -1)
        c[:4] = np.array([[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]])[:n]
        uvs.append(torch.from_numpy(c.astype(np.int32)).to(dev))
    counts = [n for *_, n in GATHER_MULTI_CASES[case]]
    launches = sum(any(counts[a:a + cuda_gather.MAX_LEVELS])
                   for a in range(0, len(counts), cuda_gather.MAX_LEVELS))
    n0 = cuda_build.LAUNCHES["gather_patches"]
    got = cuda_gather.gather_patches_multi(imgs, uvs, radius)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["gather_patches"] == n0 + launches
    want = cuda_gather.gather_patches_multi_plain(imgs, uvs, radius)
    assert len(got) == len(want) == len(imgs)
    d = 2 * radius + 1
    for g, w, n in zip(got, want, counts):
        assert g.shape == (n, d, d) and torch.equal(g, w)


def test_gather_patches_rejects_bad_arguments(dev):
    img = torch.zeros((60, 80), device=dev)
    uv = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match=r"level_uvs\[1\]"):
        cuda_gather.gather_patches_multi([img, img], [uv, uv.long()], 26)
    with pytest.raises(ValueError, match=r"level_imgs\[1\]"):
        cuda_gather.gather_patches_multi([img, img.T], [uv, uv], 26)
    with pytest.raises(ValueError, match=r"level_uvs\[0\]"):
        cuda_gather.gather_patches_multi([img], [uv.cpu()], 26)
    with pytest.raises(ValueError, match=r"level_imgs\[0\]"):
        cuda_gather.gather_patches_multi([img[:0]], [uv], 26)
    with pytest.raises(ValueError):
        cuda_gather.gather_patches_multi([img], [uv, uv], 26)


def descriptors(rng, n, n_unique):
    words = rng.randint(0, 2 ** 32, (n_unique, 8), np.uint64).astype(np.uint32)
    return words[rng.randint(0, n_unique, n)].view(np.int32)


# (M, N, mask density): one cell; fewer rows than a block and a ragged
# mask row (N % 4 != 0); the stereo shape; empty sides; more columns than
# one shared-memory tile (2048), ragged and aligned; many blocks (16 rows
# each) with rows that do not fill the last one; every cell a candidate.
@pytest.mark.parametrize("M,N,density", [
    (1, 1, 0.3), (37, 2001, 0.3), (1200, 1200, 0.3), (0, 5, 0.3),
    (5, 0, 0.3), (70, 4099, 0.05), (3, 4100, 0.3), (2113, 300, 0.02),
    (4229, 200, 0.02), (150, 260, 1.0)])
def test_fused_best2(dev, M, N, density):
    rng = np.random.RandomState(M + N)
    a = torch.from_numpy(descriptors(rng, M, max(M // 3, 1))).to(dev)
    b = torch.from_numpy(descriptors(rng, N, max(N // 3, 1))).to(dev)
    mask = rng.rand(M, N) < density
    if density < 1.0:
        mask[: M // 10] = False
        mask[:, : N // 10] = False
    mask = torch.from_numpy(mask).to(dev)
    want = cm.fused_best2_plain(a, b, mask)
    if M and N:
        got = assert_launched("fused_best2",
                              lambda: cm.fused_best2(a, b, mask))
    else:
        got = cm.fused_best2(a, b, mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (M, N, radius): as above for B4; with a radius of 2000 pixels every
# cell of a valid row and column is a candidate, with 0.5 almost none.
@pytest.mark.parametrize("M,N,base_radius", [
    (1, 1, 15.0), (530, 2100, 15.0), (4096, 1200, 15.0), (0, 7, 15.0),
    (9, 0, 15.0), (90, 4101, 15.0), (2113, 333, 15.0), (4229, 1200, 15.0),
    (1200, 1200, 15.0), (300, 700, 2000.0), (500, 600, 0.5)])
def test_fused_projection_best2(dev, M, N, base_radius):
    rng = np.random.RandomState(M * 7 + N)
    kp_uv = (rng.rand(N, 2) * [752, 480]).astype(np.float32)
    pick = rng.randint(0, max(N, 1), M)
    proj_uv = (kp_uv[pick] if N else np.zeros((M, 2), np.float32)) \
        + rng.randn(M, 2).astype(np.float32) * 6
    # Candidates exactly on the window boundary: du^2 + dv^2 == r^2.
    if N:
        proj_uv[: M // 8] = kp_uv[pick[: M // 8]] + np.float32(15.0) \
            * np.array([[0.6, 0.8]], np.float32)
    level_a = rng.randint(0, 8, M).astype(np.int32)
    radius = (np.float32(base_radius)
              * np.float32(1.2) ** level_a).astype(np.float32)
    radius[: min(M, 3)] = -1.0
    args = [torch.from_numpy(x).to(dev) for x in (
        descriptors(rng, M, max(M // 2, 1)), descriptors(rng, N,
                                                         max(N // 2, 1)),
        proj_uv.astype(np.float32), radius, level_a, rng.rand(M) > 0.1,
        kp_uv, rng.randint(0, 8, N).astype(np.int32), rng.rand(N) > 0.1)]
    args.append(1)
    want = cm.fused_projection_best2_plain(*args)
    if M and N:
        got = assert_launched("fused_projection_best2",
                              lambda: cm.fused_projection_best2(*args))
    else:
        got = cm.fused_projection_best2(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fused_projection_best2_casts_and_copies(dev):
    """float and int64 levels, a strided uv: cast or copied by the wrapper,
    same answer as the native dtypes; flags must be bool."""
    rng = np.random.RandomState(2)
    M, N = 200, 150
    kp_uv = (rng.rand(N, 2) * [300, 200]).astype(np.float32)
    pick = rng.randint(0, N, M)
    proj_uv = kp_uv[pick] + rng.randn(M, 2).astype(np.float32) * 4
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    native = [t(descriptors(rng, M, 60)), t(descriptors(rng, N, 60)),
              t(proj_uv), t(np.full(M, 12.0, np.float32)),
              t(rng.randint(0, 4, M).astype(np.int32)), t(rng.rand(M) > 0.1),
              t(kp_uv), t(rng.randint(0, 4, N).astype(np.int32)),
              t(rng.rand(N) > 0.1), 1]
    want = cm.fused_projection_best2_plain(*native)
    other = list(native)
    other[2] = t(np.repeat(proj_uv, 2, axis=1))[:, ::2]
    assert not other[2].is_contiguous()
    other[4], other[7] = native[4].float(), native[7].long()
    for args in (native, other):
        for g, w in zip(cm.fused_projection_best2(*args), want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="uv_a"):
        cm.fused_projection_best2(*native[:2], native[2][:-1], *native[3:])
    with pytest.raises(TypeError, match="valid_b"):
        cm.fused_projection_best2(*native[:8], native[8].float(), 1)


TAIL_CASES = {
    # name: [(H, W, n_centers), ...] per level
    "one_keypoint": [(60, 80, 1)],
    "odd_count": [(97, 131, 37), (81, 109, 5)],
    "empty_level": [(120, 160, 33), (100, 133, 0), (83, 111, 17)],
    "all_empty": [(40, 50, 0)],
    "window_wide_image": [(53, 53, 20), (70, 53, 9)],
    "smaller_than_window": [(20, 31, 6), (1, 1, 2)],
    "three_launches": [(64 + 2 * i, 70 + i, 3) for i in range(70)],
    "stereo_pair": [(round(480 / 1.2 ** lv), round(752 / 1.2 ** lv),
                     150 - 15 * lv) for _ in range(2) for lv in range(8)],
}


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_tail_fused(dev, case):
    rng = np.random.RandomState(len(case))
    imgs, uvs = [], []
    for H, W, n in TAIL_CASES[case]:
        imgs.append(torch.from_numpy(
            rng.rand(H, W).astype(np.float32) * 255).to(dev))
        # centers inside, on the border, and up to 30 pixels outside
        c = np.stack([rng.randint(-30, W + 30, n),
                      rng.randint(-30, H + 30, n)], -1)
        c[: n // 3] = np.stack([rng.randint(0, W, n // 3),
                                rng.randint(0, H, n // 3)], -1)
        border = np.array([[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]])
        c[n // 3: n // 3 + 4] = border[: len(c[n // 3: n // 3 + 4])]
        uvs.append(torch.from_numpy(c.astype(np.int32)).to(dev))
    total = sum(n for *_, n in TAIL_CASES[case])
    launches = -(-len(imgs) // cuda_gather.MAX_LEVELS) if total else 0
    n0 = cuda_build.LAUNCHES["tail_fused"]
    got = cuda_tail.tail_fused_multi(imgs, uvs)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["tail_fused"] == n0 + launches
    want = cuda_tail.tail_fused_multi_plain(imgs, uvs)
    assert len(got) == len(want) == len(imgs)
    for (ang, desc), (ang_p, desc_p), uv in zip(got, want, uvs):
        assert ang.shape == (uv.shape[0],) and desc.shape == (uv.shape[0], 8)
        assert desc.dtype == torch.int32
        assert torch.equal(desc, desc_p)
        if uv.shape[0]:
            assert float((ang - ang_p).abs().max()) <= 1e-6


def test_tail_fused_rejects_bad_arguments(dev):
    img = torch.zeros((60, 80), device=dev)
    uv = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_tail.tail_fused_multi([img], [uv.long()])
    with pytest.raises(ValueError):
        cuda_tail.tail_fused_multi([img.T], [uv])
    with pytest.raises(ValueError):
        cuda_tail.tail_fused_multi([img], [uv.cpu()])


def test_kernels_on_every_gpu(dev):
    """B1-B5 on each visible GPU while cuda:0 stays the current device:
    the wrappers make the tensors' device current around each launch (the
    libraries launch on the current device), so each card computes its
    own shard and answers as the plain version does."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more GPUs to launch away from the "
                    f"current device; {n} visible")
    rng = np.random.RandomState(9)
    img = rng.rand(61, 97).astype(np.float32) * 220 + 10
    centers = np.stack([rng.randint(0, 97, 50), rng.randint(0, 61, 50)],
                       -1).astype(np.int32)
    a, b = descriptors(rng, 40, 20), descriptors(rng, 300, 100)
    mask = rng.rand(40, 300) < 0.3
    uv_b = (rng.rand(300, 2) * [97, 61]).astype(np.float32)
    uv_a = uv_b[rng.randint(0, 300, 40)] + rng.randn(40, 2).astype(
        np.float32) * 4
    for i in range(n):
        d = torch.device("cuda", i)
        x, c = torch.from_numpy(img).to(d), torch.from_numpy(centers).to(d)
        ta, tb = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
        proj = [ta, tb, torch.from_numpy(uv_a).to(d),
                torch.full((40,), 15.0, device=d),
                torch.zeros(40, dtype=torch.int32, device=d),
                torch.ones(40, dtype=torch.bool, device=d),
                torch.from_numpy(uv_b).to(d),
                torch.zeros(300, dtype=torch.int32, device=d),
                torch.ones(300, dtype=torch.bool, device=d), 1]
        with torch.cuda.device(0):
            got = [cuda_fast.fast_nms_blend(x, 20.0, 7.0),
                   cuda_gather.gather_patches(x, c, 15),
                   *cm.fused_best2(ta, tb, torch.from_numpy(mask).to(d)),
                   *cm.fused_projection_best2(*proj),
                   *cuda_tail.tail_fused_multi([x], [c])[0]]
        torch.cuda.synchronize(d)
        want = [cuda_fast.fast_nms_blend_plain(x, 20.0, 7.0),
                cuda_gather.gather_patches_plain(x, c, 15),
                *cm.fused_best2_plain(ta, tb, torch.from_numpy(mask).to(d)),
                *cm.fused_projection_best2_plain(*proj),
                *cuda_tail.tail_fused_multi_plain([x], [c])[0]]
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.device == d, (i, k)
            if k == len(got) - 2:           # B5's angles: 1e-6 rad
                assert float((g - w).abs().max()) <= 1e-6, (i, k)
            else:
                assert torch.equal(g, w), (i, k)
