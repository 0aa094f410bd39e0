"""The port's keypoint tails (ops/orb.py, ops/cuda_tail.py; kernel B5
through its plain version on the CPU) against the JAX package on the same
seeded numpy inputs.

Tolerances and why:
  - B5's plain version vs the Pallas tail kernel (interpret mode) and vs
    the XLA fused tail: angles within 2e-4 rad (the ~700-term moment sums
    reduce in three different orders and atan2 of nearly cancelling
    moments magnifies an ulp), descriptor bits differing in <= 0.1 % (a
    bit flips only where an ulp of cos/sin moves a tap across a rounding
    boundary or at a blur tie) -- the bounds tests/test_orb.py gives the
    Pallas kernel itself.
  - The plain version's moment tree against an f64 sum: rtol 1e-5 plus
    atol 0.05 (f32 rounding of ~700 terms of size up to 255 * 15).
  - extract_orb_batch vs stacked extract_orb: exact (the same operations
    on the same per-image, per-level tensors).
  - Kernel B5's moment order (per-lane register sums, then warp shuffles)
    and its column blur taken only at the BRIEF taps, emulated in numpy
    f32, against the plain version's halving tree and full blur: exact.
  - Unfused tail vs the JAX package's unfused branch: angles 2e-4, bits
    <= 0.5 % (blur ties, as tests/test_torch_orb.py states for the fused
    tail).
  - TAIL_KERNEL_MODE "on" vs "off" through extract_orb on the CPU: same
    keypoints, angles 2e-4, bits <= 0.1 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.ops import pallas_tail
from vieo_slam_tpu_torch.ops import cuda_build, cuda_tail
from vieo_slam_tpu_torch.ops import orb as torb

from test_torch_orb import textured_image

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)


def bit_flips(a, b):
    return int(np.unpackbits(np.ascontiguousarray(a ^ b).view(np.uint8)).sum())


def as_i32(desc):
    return np.asarray(desc, np.uint32).view(np.int32)


def tail_inputs():
    """Three levels, 32 centers each, the last two on the valid border
    (the inputs of tests/test_orb.py TestPallasTail)."""
    rng = np.random.RandomState(4)
    imgs = [(rng.rand(h, w).astype(np.float32) * 255)
            for h, w in ((120, 160), (100, 133), (83, 111))]
    uvs = []
    for im in imgs:
        H, W = im.shape
        uvs.append(np.concatenate([
            np.stack([rng.randint(19, W - 19, 30),
                      rng.randint(19, H - 19, 30)], -1),
            [[19, 19], [W - 20, H - 20]]]).astype(np.int32))
    return imgs, uvs


@pytest.fixture
def jax_exact_gather(monkeypatch):
    monkeypatch.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    monkeypatch.setattr(jorb, "_use_mxu_gather", lambda: False)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_fused"])
def test_tail_plain_matches_jax(jax_exact_gather, reference):
    imgs, uvs = tail_inputs()
    got = cuda_tail.tail_fused_multi_plain(
        [torch.from_numpy(im) for im in imgs],
        [torch.from_numpy(uv) for uv in uvs])
    if reference == "pallas_interpret":
        want = pallas_tail.tail_fused_multi_kernel(
            [jnp.asarray(im) for im in imgs], [jnp.asarray(uv) for uv in uvs],
            interpret=True)
    else:
        want = [jorb.extract_tail_fused(jnp.asarray(im), jnp.asarray(uv))
                for im, uv in zip(imgs, uvs)]
    flips = n_bits = 0
    for (ang_t, desc_t), (ang_j, desc_j) in zip(got, want):
        assert ang_t.shape == (32,) and desc_t.shape == (32, 8)
        assert desc_t.dtype == torch.int32
        np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j),
                                   atol=2e-4)
        flips += bit_flips(desc_t.numpy(), as_i32(desc_j))
        n_bits += desc_t.numel() * 32
    assert flips <= 0.001 * n_bits, (flips, n_bits)


def test_tail_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (and counts no
    launch); the one-level entry point equals the multi-level one; an
    empty level and an empty list are answered."""
    imgs, uvs = tail_inputs()
    ti = [torch.from_numpy(im) for im in imgs]
    tu = [torch.from_numpy(uv) for uv in uvs]
    tu[1] = tu[1][:0]
    n0 = cuda_build.LAUNCHES["tail_fused"]
    got = cuda_tail.tail_fused_multi(ti, tu)
    want = cuda_tail.tail_fused_multi_plain(ti, tu)
    assert cuda_build.LAUNCHES["tail_fused"] == n0
    assert got[1][0].shape == (0,) and got[1][1].shape == (0, 8)
    for (a, d), (a2, d2) in zip(got, want):
        assert torch.equal(a, a2) and torch.equal(d, d2)
    assert cuda_tail.tail_fused_multi([], []) == []
    one, = cuda_tail.tail_fused_multi_plain(ti[:1], tu[:1])
    assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[0][1])
    with pytest.raises(ValueError):
        cuda_tail.tail_fused_multi(ti, tu[:2])


def test_moment_tree_and_rotation():
    """The fixed halving tree sums the disc moments (against f64), and
    cos/sin from the moments are a unit vector along the angle."""
    rng = np.random.RandomState(0)
    big = rng.rand(40, 53, 53).astype(np.float32) * 255
    m10, m01 = cuda_tail.moments_plain(torch.from_numpy(big))
    mask = torb._disc_mask(15).astype(np.float64)
    c = np.arange(-15, 16, dtype=np.float64)
    cen = big[:, 11:42, 11:42].astype(np.float64)
    np.testing.assert_allclose(m10.numpy(), (cen * mask * c[None, :])
                               .sum((1, 2)), rtol=1e-5, atol=0.05)
    np.testing.assert_allclose(m01.numpy(), (cen * mask * c[:, None])
                               .sum((1, 2)), rtol=1e-5, atol=0.05)
    x = torch.arange(16, dtype=torch.float32)[None] * 0.37
    assert float(cuda_tail._tree_sum(x)) == pytest.approx(float(x.sum()))
    ang, desc = cuda_tail.tail_from_big_plain(torch.from_numpy(big))
    np.testing.assert_allclose(ang.numpy(), np.arctan2(m01.numpy(),
                                                       m10.numpy()),
                               rtol=0, atol=5e-7)   # an ulp of atan2 at pi
    # a flat window has zero moments: cos 1, sin 0, angle 0, and every
    # comparison of equal taps is false
    ang0, desc0 = cuda_tail.tail_from_big_plain(torch.full((1, 53, 53), 7.0))
    assert float(ang0) == 0.0 and not desc0.any()


def lane_strided_tree(p):
    """The moment sum of kernel B5, emulated in numpy f32: lane l holds the
    products i = l + 32 k (k < 32), sums them in registers as the halving
    steps 512 .. 32 pair them (subtree T(k, s) = T(k, 2s) + T(k + s, 2s)),
    then shuffles down by 16 .. 1."""
    lanes = p.reshape(*p.shape[:-1], 32, 32)          # [..., k, lane]

    def subtree(k, step):
        if step == 32:
            return lanes[..., k, :]
        return subtree(k, 2 * step) + subtree(k + step, 2 * step)

    s = subtree(0, 1)
    for half in (16, 8, 4, 2, 1):
        s = np.concatenate([s[..., :half] + s[..., half:2 * half],
                            s[..., half:]], -1)
    return s[..., 0]


def test_lane_strided_moment_tree_is_the_halving_tree():
    """Kernel B5 sums each lane's 32 products in registers and then across
    the warp; that is the halving tree of `_tree_sum` to the bit, on the
    real moment products of random windows and on values of mixed
    magnitude and sign."""
    rng = np.random.RandomState(1)
    big = rng.rand(64, 53, 53).astype(np.float32) * 255
    cen = big[:, 11:42, 11:42].reshape(64, -1)
    mask = torb._disc_mask(15)
    coords = np.arange(-15, 16, dtype=np.float32)
    prods = [np.pad(cen * (mask * w).reshape(-1), ((0, 0), (0, 1024 - 961)))
             for w in (coords[None, :], coords[:, None])]
    mixed = (rng.randn(64, 1024) * 10.0 ** rng.randint(-3, 4, (64, 1024))
             ).astype(np.float32)
    for p in prods + [mixed]:
        assert p.dtype == np.float32
        want = cuda_tail._tree_sum(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(lane_strided_tree(p).view(np.int32),
                                      want.view(np.int32))


def test_column_blur_at_the_taps_is_the_full_blur():
    """Kernel B5 blurs the columns only at the 512 rotated taps, straight
    from the row-blurred patch, 7 taps top to bottom: the full 47x47 pass
    of `_blur7_patch` holds the same bits there, for random windows and
    rotations."""
    rng = np.random.RandomState(2)
    n = 48
    big = rng.rand(n, 53, 53).astype(np.float32) * 255
    k = np.asarray(torb._gauss7(), np.float32)
    rows = big[:, :, 0:47] * k[0]
    for j in range(1, 7):
        rows = rows + big[:, :, j:j + 47] * k[j]          # [n, 53, 47]
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ca, sa = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    pat = torb.BRIEF_PATTERN.astype(np.float32)
    px, py = pat[..., 0], pat[..., 1]                     # [256, 2]
    ix = np.clip(np.rint(ca * px - sa * py).astype(np.int64) + 23, 0, 46)
    iy = np.clip(np.rint(sa * px + ca * py).astype(np.int64) + 23, 0, 46)
    nn = np.arange(n)[:, None, None]
    at_taps = rows[nn, iy, ix] * k[0]
    for j in range(1, 7):
        at_taps = at_taps + rows[nn, iy + j, ix] * k[j]
    full = torb._blur7_patch(torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(at_taps.view(np.int32),
                                  full[nn, iy, ix].view(np.int32))


def test_extract_tail_fused_single_level(jax_exact_gather):
    imgs, uvs = tail_inputs()
    ang_t, desc_t = torb.extract_tail_fused(torch.from_numpy(imgs[0]),
                                            torch.from_numpy(uvs[0]))
    ang_j, desc_j = jorb.extract_tail_fused(jnp.asarray(imgs[0]),
                                            jnp.asarray(uvs[0]))
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=2e-4)
    assert bit_flips(desc_t.numpy(), as_i32(desc_j)) <= 0.005 * 32 * 256


def test_gaussian_blur7_and_brief_descriptors(jax_exact_gather):
    imgs, uvs = tail_inputs()
    im, uv = imgs[1], uvs[1]
    blur_j = jorb.gaussian_blur7(jnp.asarray(im))
    blur_t = torb.gaussian_blur7(torch.from_numpy(im))
    np.testing.assert_allclose(blur_t.numpy(), np.asarray(blur_j), rtol=1e-6)
    batch = torb.gaussian_blur7(torch.from_numpy(np.stack([im, im[::-1]])))
    assert torch.equal(batch[0], blur_t)
    ang = np.linspace(-3.0, 3.0, len(uv)).astype(np.float32)
    want = jorb.brief_descriptors(blur_j, jnp.asarray(uv), jnp.asarray(ang))
    got = torb.brief_descriptors(torch.from_numpy(np.asarray(blur_j)),
                                 torch.from_numpy(uv), torch.from_numpy(ang))
    assert bit_flips(got.numpy(), as_i32(want)) <= 0.001 * 32 * 256


def test_extract_orb_unfused_tail(monkeypatch, jax_exact_gather):
    monkeypatch.setattr(jorb, "_use_fused_tail", lambda: False)
    monkeypatch.setattr(torb, "FUSED_TAIL_MODE", "off")
    img = textured_image(seed=3)
    cfg = jorb.OrbConfig(300, 4)
    want = jax.jit(lambda im: jorb.extract_orb(im, cfg))(jnp.asarray(img))
    got = torb.extract_orb(img, torb.OrbConfig(300, 4), device="cpu")
    valid = np.asarray(want.valid)
    assert valid.sum() > 180
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_allclose(got.angle.numpy()[valid],
                               np.asarray(want.angle)[valid], atol=2e-4)
    flips = bit_flips(got.desc.numpy()[valid], as_i32(want.desc)[valid])
    assert flips <= 0.005 * valid.sum() * 256, flips


@pytest.mark.parametrize("tail", ["fused", "unfused", "kernel"])
def test_extract_orb_batch_equals_stacked(monkeypatch, tail):
    monkeypatch.setattr(torb, "FUSED_TAIL_MODE",
                        "off" if tail == "unfused" else "auto")
    monkeypatch.setattr(torb, "TAIL_KERNEL_MODE",
                        "on" if tail == "kernel" else "auto")
    cfg = torb.OrbConfig(300, 4)
    imgs = np.stack([textured_image(seed=5), textured_image(seed=6)])
    batch = torb.extract_orb_batch(imgs, cfg, device="cpu")
    singles = [torb.extract_orb(im, cfg, device="cpu") for im in imgs]
    for name in torb.OrbFeatures._fields:
        got = getattr(batch, name)
        assert got.shape[0] == 2
        for b in range(2):
            assert torch.equal(got[b], getattr(singles[b], name)), (name, b)
    with pytest.raises(ValueError):
        torb.extract_orb_batch(imgs[0], cfg, device="cpu")


def test_extract_orb_tail_kernel_mode_on_vs_off(monkeypatch):
    img = textured_image(seed=7)
    cfg = torb.OrbConfig(400, 4)
    assert torb.TAIL_KERNEL_MODE == "auto" and not torb._use_tail_kernel()
    off = torb.extract_orb(img, cfg, device="cpu")
    monkeypatch.setattr(torb, "TAIL_KERNEL_MODE", "on")
    assert torb._use_tail_kernel()
    on = torb.extract_orb(img, cfg, device="cpu")
    valid = off.valid.numpy()
    assert valid.sum() > 240
    for name in ("uv", "level", "score", "valid"):
        assert torch.equal(getattr(on, name), getattr(off, name))
    np.testing.assert_allclose(on.angle.numpy()[valid],
                               off.angle.numpy()[valid], atol=2e-4)
    flips = bit_flips(on.desc.numpy()[valid], off.desc.numpy()[valid])
    assert flips <= 0.001 * valid.sum() * 256, flips


def test_env_mode_rejects_typos(monkeypatch):
    monkeypatch.setenv("ORB_TAIL_KERNEL", "ON ")
    assert torb._env_mode("ORB_TAIL_KERNEL") == "on"
    monkeypatch.setenv("ORB_TAIL_KERNEL", "true")
    with pytest.raises(ValueError, match="ORB_TAIL_KERNEL"):
        torb._env_mode("ORB_TAIL_KERNEL")
