"""The port's ORB extraction (ops/orb.py, kernels B1 and B2 through their
plain versions on the CPU) against the JAX package on the same seeded
numpy images.

Tolerances and why:
  - FAST + NMS + blend (B1): bit-exact, against both the Pallas kernel in
    interpret mode and the XLA composition -- the same f32 adds in the
    same order, no multiplies.
  - Patch gather (B2), one entry or all levels of a stereo pair in one
    call: exact -- every output is a copied input pixel.
  - Pyramid: exact against the JAX package with x64 off (its System's
    mode; the suite turns x64 on, under which JAX computes the resize
    weights in f64): ops/xla_f32.py resizes with XLA's own weights and
    contraction order.
  - Keypoint selection on identical score maps: exact (stable sorts give
    lax.top_k's lowest-index tie order).
  - extract_orb against the JAX package's own CPU program (x64 off, its
    unfused tail): every field exact, in tests/test_torch_xla_exact.py.
  - extract_orb against JAX's fused tail (a TPU-only path, x64 off):
    keypoints and levels equal, scores rtol 1e-6;
    angles within 2e-4 rad (its moments sum ~700 terms in another order,
    and atan2 of nearly cancelling moments magnifies that -- the bound
    tests/test_orb.py gives the tail kernel for its moment order);
    descriptor bits may differ in <= 0.5% (the bound tests/test_orb.py
    gives FMA-contraction ties in the Gaussian blur; its in-patch blur also
    differs from the whole-image blur at taps past the image edge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.ops import pallas_fast, pallas_gather
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.ops import cuda_build, cuda_fast, cuda_gather
from vieo_slam_tpu_torch.ops import orb as torb

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)


@pytest.fixture
def jax_fused_tail(monkeypatch):
    """Route the JAX package through the fused tail with the exact f32
    gather: the path the TPU runs and the port follows."""
    monkeypatch.setattr(jorb, "_use_fused_tail", lambda: True)
    monkeypatch.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    monkeypatch.setattr(jorb, "_use_mxu_gather", lambda: False)


def textured_image(h=240, w=320, seed=0):
    """Smooth random texture with strong blob corners plus faint noise
    (the noise keeps flat areas from holding exact ties)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(h // 8, w // 8).astype(np.float32)
    img = np.asarray(jax.image.resize(jnp.asarray(img), (h, w), "bilinear"))
    img = img * 120.0 + 60.0
    for _ in range(150):
        y, x = rng.randint(20, h - 20), rng.randint(20, w - 20)
        img[y - 2:y + 3, x - 2:x + 3] = 255.0 if rng.rand() > 0.5 else 5.0
    return (img + rng.rand(h, w)).astype(np.float32)


def corner_image(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w).astype(np.float32) * 220 + 10
    img[rng.randint(2, h - 2, 120), rng.randint(2, w - 2, 120)] = 255.0
    return img


def test_constants_equal_jax():
    np.testing.assert_array_equal(torb.FAST_CIRCLE, jorb.FAST_CIRCLE)
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    for r in (15, 26):
        np.testing.assert_array_equal(torb._disc_mask(r), jorb._disc_mask(r))
    for cfg in ((1200, 8), (600, 4), (300, 4)):
        np.testing.assert_array_equal(
            torb.OrbConfig(*cfg).features_per_level,
            jorb.OrbConfig(*cfg).features_per_level)
        assert convert.orb_config_from_jax(jorb.OrbConfig(*cfg)) \
            == torb.OrbConfig(*cfg)
    assert (torb._TAIL_R, torb.BRIEF_R) == (jorb._TAIL_R, jorb.BRIEF_R)


@pytest.mark.parametrize("shape", [(120, 160), (67, 93), (25, 40)])
def test_fast_nms_blend_bit_exact(shape):
    img = corner_image(*shape, seed=sum(shape))
    want_xla = np.asarray(jorb._blended_score(jnp.asarray(img),
                                              jorb.OrbConfig()))
    want_pallas = np.asarray(pallas_fast.fast_nms_blend(
        jnp.asarray(img), 20.0, 7.0, interpret=True))
    got = cuda_fast.fast_nms_blend(torch.from_numpy(img), 20.0, 7.0).numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    assert (got > 1e4).any() and ((got > 0) & (got < 1e4)).any()
    s_hi, s_lo = cuda_fast.fast_score_maps(torch.from_numpy(img), (20.0, 7.0))
    j_hi, j_lo = jorb.fast_score_maps(jnp.asarray(img), (20.0, 7.0))
    np.testing.assert_array_equal(s_hi.numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(s_lo.numpy(), np.asarray(j_lo))


@pytest.mark.parametrize("n_images,n_levels", [(1, 3), (2, 3), (1, 8),
                                               (2, 8)])
def test_fast_nms_blend_multi_bit_exact(n_images, n_levels):
    """All levels of all images in one call: each map equals the Pallas
    kernel in interpret mode and the XLA composition on that level."""
    cfg = torb.OrbConfig(n_levels=n_levels)
    levels = []
    for b in range(n_images):
        img = corner_image(96, 128, seed=10 * n_levels + b)
        levels += torb.build_pyramid(torch.from_numpy(img), cfg)
    assert len(levels) == n_images * n_levels
    got = cuda_fast.fast_nms_blend_multi(levels, 20.0, 7.0)
    assert len(got) == len(levels)
    for im, g in zip(levels, got):
        x = jnp.asarray(im.numpy())
        assert g.shape == im.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            jorb._blended_score(x, jorb.OrbConfig())))
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            pallas_fast.fast_nms_blend(x, 20.0, 7.0, interpret=True)))
    assert (got[0] > 1e4).any()
    assert cuda_fast.fast_nms_blend_multi([], 20.0, 7.0) == []


@pytest.mark.parametrize("tail,n_features,n_levels", [
    pytest.param("fused", 300, 3, id="300-3"),
    pytest.param("fused", 600, 8, id="600-8"),
    pytest.param("unfused", 300, 3, id="unfused-300-3"),
    pytest.param("kernel", 600, 8, id="kernel-600-8"),
])
def test_extract_orb_batch_equals_per_image(monkeypatch, tail, n_features,
                                            n_levels):
    """The stereo pair through one multi-level FAST call and, on the
    default fused tail, one patch gather for both images, equals the two
    images extracted one by one, bit for bit, whichever tail runs."""
    monkeypatch.setattr(torb, "FUSED_TAIL_MODE",
                        "off" if tail == "unfused" else "auto")
    monkeypatch.setattr(torb, "TAIL_KERNEL_MODE",
                        "on" if tail == "kernel" else "auto")
    gathers = []

    def counted(level_imgs, level_uvs, radius):
        gathers.append(len(level_imgs))
        return cuda_gather.gather_patches_flat(level_imgs, level_uvs, radius)

    monkeypatch.setattr(torb, "gather_patches_flat", counted)
    cfg = torb.OrbConfig(n_features, n_levels)
    pair = np.stack([textured_image(seed=3), textured_image(seed=4)])
    both = torb.extract_orb_batch(pair, cfg, device="cpu")
    assert gathers == ([2 * n_levels] if tail == "fused" else [])
    for b in range(2):
        one = torb.extract_orb(pair[b], cfg, device="cpu")
        assert int(one.valid.sum()) > 0.5 * n_features
        for f_both, f_one in zip(both, one):
            assert torch.equal(f_both[b], f_one)


@pytest.mark.parametrize("radius", [15, 26])
def test_gather_patches_exact(radius):
    rng = np.random.RandomState(3)
    img = rng.rand(120, 160).astype(np.float32) * 255
    centers = np.concatenate([
        np.stack([rng.randint(0, 160, 60), rng.randint(0, 120, 60)], -1),
        [[0, 0], [159, 119], [3, 119], [159, 2], [19, 19], [140, 100]],
    ]).astype(np.int32)
    got = cuda_gather.gather_patches(torch.from_numpy(img),
                                     torch.from_numpy(centers), radius).numpy()
    np.testing.assert_array_equal(got, pallas_gather._np_reference(
        img, centers, radius))
    np.testing.assert_array_equal(got, np.asarray(
        pallas_gather.gather_patches_kernel(
            jnp.asarray(img), jnp.asarray(centers), radius, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jorb.gather_patches(
        jnp.asarray(img), jnp.asarray(centers), radius, mxu=False)))


def multi_gather_entries(case):
    """(level images, centers) of a multi-entry gather: centers inside,
    on the image corners and up to 30 pixels off the image; one entry
    empty."""
    rng = np.random.RandomState(len(case))
    if case == "stereo_pair":
        cfg = torb.OrbConfig(n_levels=8)
        imgs = [lv for seed in (11, 12) for lv in torb.build_pyramid(
            torch.from_numpy(corner_image(96, 128, seed)), cfg)]
    else:   # more entries than one launch takes
        shapes = [(40, 50), (23, 61), (70, 33)]
        imgs = [torch.from_numpy(rng.rand(*shapes[i % 3]).astype(np.float32)
                                 * 255) for i in range(35)]
    uvs = []
    for i, im in enumerate(imgs):
        H, W = im.shape
        n = 0 if i == 5 else 12
        c = np.stack([rng.randint(-30, W + 30, n),
                      rng.randint(-30, H + 30, n)], -1)
        c[:4] = np.array([[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]])[:n]
        c[4:8] = np.stack([rng.randint(0, W, 4), rng.randint(0, H, 4)],
                          -1)[:max(n - 4, 0)]
        c[8:10] = np.array([[-7, H // 2], [W + 5, -9]])[:max(n - 8, 0)]
        uvs.append(torch.from_numpy(c.astype(np.int32)))
    return imgs, uvs


@pytest.mark.parametrize("case", ["stereo_pair", "more_than_32"])
def test_gather_patches_multi_exact(case):
    """All entries of a frame in one call: each entry equals the Pallas
    kernel in interpret mode, and, at its in-image centers, the JAX
    gather_patches(mxu=False) (off the image the Pallas kernel and the port
    clamp the center first, the XLA gather does not); the flat buffer is
    the entries one after another; the CPU counts no launch."""
    imgs, uvs = multi_gather_entries(case)
    n0 = cuda_build.LAUNCHES["gather_patches"]
    got = cuda_gather.gather_patches_multi(imgs, uvs, 26)
    flat = cuda_gather.gather_patches_flat(imgs, uvs, 26)
    assert cuda_build.LAUNCHES["gather_patches"] == n0
    assert len(got) == len(imgs)
    assert torch.equal(flat, torch.cat(got))
    for im, uv, g in zip(imgs, uvs, got):
        H, W = im.shape
        assert g.shape == (uv.shape[0], 53, 53)
        if not uv.shape[0]:
            continue
        x, c = jnp.asarray(im.numpy()), uv.numpy()
        np.testing.assert_array_equal(g.numpy(), np.asarray(
            pallas_gather.gather_patches_kernel(x, jnp.asarray(c), 26,
                                                interpret=True)))
        inside = (c[:, 0] >= 0) & (c[:, 0] < W) & (c[:, 1] >= 0) \
            & (c[:, 1] < H)
        assert inside.sum() >= 8 and (~inside).any()
        np.testing.assert_array_equal(g.numpy()[inside], np.asarray(
            jorb.gather_patches(x, jnp.asarray(c[inside]), 26, mxu=False)))
    assert torch.equal(cuda_gather.gather_patches(imgs[3], uvs[3], 26),
                       got[3])
    assert cuda_gather.gather_patches_multi([], [], 26) == []
    with pytest.raises(ValueError):
        cuda_gather.gather_patches_multi(imgs, uvs[:-1], 26)


def test_build_pyramid():
    img = textured_image(seed=1)
    cfg_j, cfg_t = jorb.OrbConfig(n_levels=8), torb.OrbConfig(n_levels=8)
    with jax.enable_x64(False):
        want = jax.jit(lambda im: jorb.build_pyramid(im, cfg_j))(
            jnp.asarray(img))
    got = torb.build_pyramid(torch.from_numpy(img), cfg_t)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


def test_select_keypoints_exact():
    img = textured_image(seed=2)
    cfg_j, cfg_t = jorb.OrbConfig(n_levels=4), torb.OrbConfig(n_levels=4)
    for lv, im in enumerate(jorb.build_pyramid(jnp.asarray(img), cfg_j)):
        score = np.array(jorb._blended_score(im, cfg_j))
        n = int(cfg_j.features_per_level[lv])
        uv_j, s_j, v_j = jorb.select_keypoints(jnp.asarray(score), n, cfg_j)
        uv_t, s_t, v_t = torb.select_keypoints(torch.from_numpy(score), n,
                                               cfg_t)
        np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_select_keypoints_ties_lowest_index():
    """Equal scores everywhere: both pick the lowest flat indices."""
    score = np.zeros((70, 90), np.float32)
    score[::3, ::2] = 5.0
    cfg_j, cfg_t = jorb.OrbConfig(), torb.OrbConfig()
    uv_j, _, v_j = jorb.select_keypoints(jnp.asarray(score), 40, cfg_j)
    uv_t, _, v_t = torb.select_keypoints(torch.from_numpy(score), 40, cfg_t)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("seed,n_features,n_levels",
                         [(0, 300, 4), (1, 600, 8)])
def test_extract_orb_matches_fused_tail(jax_fused_tail, seed, n_features,
                                        n_levels):
    img = textured_image(seed=seed)
    cfg = jorb.OrbConfig(n_features, n_levels)
    with jax.enable_x64(False):
        want = jax.jit(lambda im: jorb.extract_orb(im, cfg))(
            jnp.asarray(img))
    got = torb.extract_orb(img, torb.OrbConfig(n_features, n_levels),
                           device="cpu")
    valid = np.asarray(want.valid)
    assert valid.sum() > 0.6 * n_features
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(want.level))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=1e-6)
    np.testing.assert_allclose(got.angle.numpy()[valid],
                               np.asarray(want.angle)[valid], atol=2e-4)
    want_desc = np.asarray(want.desc, np.uint32).view(np.int32)
    flips = np.unpackbits((got.desc.numpy() ^ want_desc)[valid]
                          .view(np.uint8)).sum()
    assert flips <= 0.005 * valid.sum() * 256, flips
