"""The port's ORB extraction stages (ops/xla_f32.py, the CPU build of
csrc/xla_f32.cuh and csrc/libm_f32.cuh) bit for bit against the JAX package
as its System runs them: XLA's CPU backend with x64 off.

tests/conftest.py turns x64 on for the suite, and under x64 JAX computes the
resize weights in f64; every JAX side here runs under
`jax.enable_x64(False)`, the rows' mode and JAX's default.  Every comparison
is on the f32 (or int32) bits: no tolerance.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu_torch.loop.vocabulary import train_vocabulary
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.ops import xla_f32

from test_torch_orb import textured_image

torch.set_num_threads(1)

SIZES = {"320x240": (240, 320), "640x480": (480, 640), "752x480": (480, 752)}
CLOSURE_NPZ = "tests/data/stereo_loop_752_seed0_closure.npz"


def bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def assert_bits(got, want):
    got, want = bits(got), bits(want)
    assert got.shape == want.shape
    n = int((got != want).sum())
    assert n == 0, f"{n} of {got.size} differ"


def xla_weights(in_size: int, out_size: int) -> np.ndarray:
    """The weights the jitted resize uses: the resize of an identity matrix
    along one axis (a dot with a one-hot row is exact)."""
    eye = np.eye(in_size, dtype=np.float32)
    with jax.enable_x64(False):
        r = jax.jit(lambda m: jax.image.resize(
            m, (out_size, in_size), "bilinear"))(eye)
    return np.asarray(r).T


def level_pairs(h: int, w: int, n_levels: int = 8):
    a, b = h, w
    for lv in range(1, n_levels):
        na, nb = round(h / 1.2 ** lv), round(w / 1.2 ** lv)
        yield a, na
        yield b, nb
        a, b = na, nb


@pytest.mark.parametrize("size", list(SIZES))
def test_resize_weights_bit_exact(size):
    for a, b in level_pairs(*SIZES[size]):
        assert_bits(xla_f32.resize_weights(a, b), xla_weights(a, b))


def test_pyramid_bit_exact_752():
    """The port's pyramid (extract_orb's) against JAX's build_pyramid,
    jitted alone and as the stereo frame's program runs it (both images in
    one program)."""
    cfg_j, cfg_t = jorb.OrbConfig(1200, 8), torb.OrbConfig(1200, 8)
    left, right = textured_image(480, 752, 5), textured_image(480, 752, 6)
    with jax.enable_x64(False):
        alone = jax.jit(lambda im: jorb.build_pyramid(im, cfg_j))(left)
        both = jax.jit(lambda l, r: (jorb.build_pyramid(l, cfg_j),
                                     jorb.build_pyramid(r, cfg_j)))(left, right)
    got_l = torb.build_pyramid(torch.from_numpy(left), cfg_t)
    got_r = torb.build_pyramid(torch.from_numpy(right), cfg_t)
    for lv in range(8):
        assert_bits(got_l[lv], alone[lv])
        assert_bits(got_l[lv], both[0][lv])
        assert_bits(got_r[lv], both[1][lv])


def test_moments_and_angles_bit_exact():
    rng = np.random.RandomState(3)
    patches = (rng.rand(2000, 31, 31) * 255).astype(np.float32)
    patches[:50] = np.round(patches[:50] / 64) * 64     # ties and cancellation
    patches[50:60] = 0.0                                # all-zero moments
    mask = jnp.asarray(jorb._disc_mask(15))
    coords = jnp.arange(-15, 16, dtype=jnp.float32)

    def moments(p):
        w = p * mask
        m10 = jnp.einsum("nyx,x->n", w, coords)
        m01 = jnp.einsum("nyx,y->n", w, coords)
        return m01, m10, jnp.arctan2(m01, m10)

    with jax.enable_x64(False):
        m01, m10, ang_m = jax.jit(moments)(patches)
        ang = jax.jit(jorb.ic_angle)(patches)
    got, mom = xla_f32.ic_angle(torch.from_numpy(patches), moments=True)
    assert_bits(mom[:, 0], m01)
    assert_bits(mom[:, 1], m10)
    assert_bits(got, ang)
    assert_bits(got, ang_m)
    # A view into 53x53 patches (the fused tail's crop) gives the same.
    big = np.zeros((2000, 53, 53), np.float32)
    big[:, 11:42, 11:42] = patches
    assert_bits(xla_f32.ic_angle(torch.from_numpy(big)[:, 11:42, 11:42]), ang)


def libm_inputs():
    rng = np.random.RandomState(7)
    n = 100_000
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-45, -1e-45,
                        1e-40, 1e-38, 1.2e-38, 3e38, -3e38, 0.5, 1e-30, 1e30,
                        120.0, 119.99, 0.7853982, 1e-12, 2.5e-4, 1e5, np.pi,
                        -np.pi / 2], np.float32)
    y = np.concatenate([(rng.randn(n) * 300).astype(np.float32),
                        (rng.randn(n) * 1e-3).astype(np.float32),
                        np.repeat(special, len(special))])
    x = np.concatenate([(rng.randn(n) * 300).astype(np.float32),
                        (rng.randn(n) * 1e6).astype(np.float32),   # |y| >> |x|
                        np.tile(special, len(special))])
    v = np.concatenate([(rng.rand(n) * 8 - 4).astype(np.float32),
                        (rng.randn(n) * 1e4).astype(np.float32),
                        (rng.randn(2000) * 1e30).astype(np.float32),
                        (rng.rand(2000) * 2e-38).astype(np.float32), special])
    return y, x, v


def glibc(name, *args):
    libm = ctypes.CDLL("libm.so.6")
    f = getattr(libm, name)
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float] * len(args)
    return np.array([f(*map(float, a)) for a in zip(*args)], np.float32)


def same_or_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    both_nan = np.isnan(got) & np.isnan(want)
    bad = (bits(got) != bits(want)) & ~both_nan
    assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])


def test_atan2_against_glibc_and_xla():
    y, x, _ = libm_inputs()
    same_or_nan(xla_f32.atan2_glibc_host(y, x), glibc("atan2f", y, x))
    with jax.enable_x64(False):
        want = jax.jit(jnp.arctan2)(y, x)
    same_or_nan(xla_f32.atan2(torch.from_numpy(y), torch.from_numpy(x)), want)


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_sin_cos_against_glibc_and_xla(fn):
    _, _, v = libm_inputs()
    got = getattr(xla_f32, fn)(torch.from_numpy(v))
    same_or_nan(got, glibc(fn + "f", v))
    with jax.enable_x64(False):
        alone = jax.jit(getattr(jnp, fn))(v)
        fused = jax.jit(lambda a: (jnp.sin(a), jnp.cos(a)))(v)   # sincosf
    same_or_nan(got, alone)
    same_or_nan(got, fused[0] if fn == "sin" else fused[1])


def test_blur_and_brief_bit_exact():
    rng = np.random.RandomState(11)
    im = (rng.rand(90, 130) * 255).astype(np.float32)
    with jax.enable_x64(False):
        blur_j = jax.jit(jorb.gaussian_blur7)(im)
    blur_t = torb.gaussian_blur7(torch.from_numpy(im))
    assert_bits(blur_t, blur_j)
    uv = np.stack([rng.randint(0, 130, 200), rng.randint(0, 90, 200)],
                  -1).astype(np.int32)
    ang = (rng.rand(200) * 2 * np.pi - np.pi).astype(np.float32)
    with jax.enable_x64(False):
        want = jax.jit(jorb.brief_descriptors)(blur_j, uv, ang)
    got = torb.brief_descriptors(blur_t, torch.from_numpy(uv),
                                 torch.from_numpy(ang))
    assert_bits(got, np.asarray(want, np.uint32))


@pytest.fixture(scope="module")
def jax_extract_752():
    """The JAX package's extract_orb at 752x480 (call it under x64 off)."""
    cfg = jorb.OrbConfig(1200, 8)
    f = jax.jit(lambda im: jorb.extract_orb(im, cfg))
    return lambda img: jax.tree.map(np.asarray, f(jnp.asarray(img)))


@pytest.mark.parametrize("tail", ["fused", "unfused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_orb_bit_exact_752(jax_extract_752, monkeypatch, seed, tail):
    """extract_orb at 752x480, 1200 features on 8 levels, either tail,
    against the JAX package's CPU program (its unfused tail): every field
    of every row."""
    monkeypatch.setattr(torb, "FUSED_TAIL_MODE",
                        "off" if tail == "unfused" else "auto")
    img = textured_image(480, 752, seed)
    with jax.enable_x64(False):
        want = jax_extract_752(img)
    got = torb.extract_orb(img, torb.OrbConfig(1200, 8), device="cpu")
    assert int(want.valid.sum()) > 1000
    assert np.array_equal(got.valid.numpy(), want.valid)
    for name in ("uv", "level", "score", "angle"):
        assert_bits(getattr(got, name), getattr(want, name))
    assert_bits(got.desc, np.asarray(want.desc, np.uint32))


def test_stereo_loop_keyframes_and_vocabulary():
    """stereo_loop at noise seed 0, 752x480: the left images of frames 0, 1
    and 5 (keyframe slots 0-2 of the JAX run's closure state) give the JAX
    package's features, and the vocabulary trained from their 3067 valid
    descriptors is the JAX run's, node for node."""
    from vieo_slam_tpu_torch.examples.evaluate_ntimes import Row
    z = np.load(CLOSURE_NPZ)
    assert list(z["map_kf_frame_id"][:3]) == [0, 1, 5]
    row = Row("stereo_loop", 0, 360, device="cpu", width=752,
              n_features=1200, n_levels=8)
    left = {}
    for i in range(6):          # the noise stream runs frame by frame
        images = row.prepare(i)
        left[i] = images[0]
    cfg = torb.OrbConfig(1200, 8)
    descs = []
    for slot, i in enumerate((0, 1, 5)):
        f = torb.extract_orb(left[i], cfg, device="cpu")
        valid = z["map_kf_kp_valid"][slot]
        assert np.array_equal(f.valid.numpy(), valid)
        assert_bits(f.uv, z["map_kf_uv"][slot])
        assert np.array_equal(f.level.numpy(), z["map_kf_level"][slot])
        assert_bits(f.desc, z["map_kf_desc"][slot])
        descs.append(f.desc.numpy().view(np.uint32)[valid])
    assert sum(map(len, descs)) == 3067
    lc = dict(zip(("k", "L"), z["voc_kL"].tolist()))
    voc = train_vocabulary(np.concatenate(descs), k=lc["k"], L=lc["L"],
                           seed=0)
    assert np.array_equal(voc.node_desc, z["voc_node_desc"])
    assert_bits(voc.idf, z["voc_idf"])
