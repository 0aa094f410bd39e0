"""The port's reproduction of the JAX package's random draws
(vieo_slam_tpu_torch/utils/prng.py) against jax.random, and the port's
RANSAC solvers keyed as the JAX package keys them.

The draws are held at the seeds 0, 1, 8, 14, 2**31 - 1 and a relocalization
timestamp seed, at the solvers' shapes (two-view init (256, 8, N), 3D-3D PnP
(1024, 3, 512), DLT PnP (2048, 6, 512), Sim3 (128, 3, 512)), with part of
the rows valid, all and none, with x64 off (the rows' mode) and on (the
suite's).  The port draws the f32 stream only, the one the JAX PnP solvers
draw in either mode; with x64 on the JAX side is handed f32 logits too.

Tolerances: key words, random bits, uniforms and categorical indices equal
in every element; Gumbel values within 1e-6: XLA's log and torch's differ in
the last bit, which the draw, an argmax, does not see.  Solvers, given the
same key as the JAX functions (x64 off): inlier masks and counts equal, R
and t within 1e-4; the two-view init's good points agree on 99 % of the rows
and their count within 3, as in test_torch_mono_rgbd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.solvers import initializer as jinit
from vieo_slam_tpu.solvers import pnp_solver as jpnp
from vieo_slam_tpu.solvers import sim3_solver as jsim3
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.frontend.relocalization import timestamp_seed
from vieo_slam_tpu_torch.solvers import initializer as tinit
from vieo_slam_tpu_torch.solvers import pnp_solver as tpnp
from vieo_slam_tpu_torch.solvers import sim3_solver as tsim3
from vieo_slam_tpu_torch.utils import prng

from test_torch_loop_components import pnp_problem, sim3_pairs
from test_torch_mono_rgbd import two_view_case

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
SEEDS = [0, 1, 8, 14, 2 ** 31 - 1, timestamp_seed(16.3)]
# name: (sample shape, rows)
SHAPES = {"init": ((256, 8), 600), "pnp_3d3d": ((1024, 3), 512),
          "pnp": ((2048, 6), 512), "sim3": ((128, 3), 512)}
VALIDITY = ["part", "all", "none"]


@pytest.fixture(params=[False, True], ids=["x64_off", "x64_on"])
def x64(request):
    jax.config.update("jax_enable_x64", request.param)
    yield request.param
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def x64_off():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def mask(kind, n, seed=0):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    return np.random.RandomState(seed).rand(n) < 0.7


def test_jax_stream_layout():
    """The module reproduces the partitionable threefry layout."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == tuple(int(v) for v in np.asarray(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel(seed, x64):
    key, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    f32 = jnp.float32
    for shape in [(7,), (3, 5), (64, 8, 33)]:
        np.testing.assert_array_equal(
            prng.random_bits(k, shape).numpy(),
            np.asarray(jax.random.bits(key, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            prng.uniform(k, shape).numpy(),
            np.asarray(jax.random.uniform(key, shape, f32)))
        np.testing.assert_array_equal(
            prng.uniform(k, shape, -2.0, 3.0).numpy(),
            np.asarray(jax.random.uniform(key, shape, f32, -2.0, 3.0)))
        np.testing.assert_allclose(
            prng.gumbel(k, shape).numpy(),
            np.asarray(jax.random.gumbel(key, shape, f32)),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("validity", VALIDITY)
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed, name, validity, x64):
    shape, n = SHAPES[name]
    valid = mask(validity, n, seed % 97)
    logits = jnp.where(J(valid), 0.0, -1e9).astype(jnp.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                             logits, shape=shape))
    got = prng.categorical_valid(prng.prng_key(seed), T(valid), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    if validity == "none":
        assert not want.any()              # JAX's index 0 everywhere
    else:
        assert valid[want].all()


@pytest.mark.parametrize("validity", VALIDITY)
@pytest.mark.parametrize("seed,shape,n", [(3, (256, 8), 600),
                                          (5, (2048, 6), 512)])
def test_valid_path_equals_full_path(validity, seed, shape, n):
    valid = T(mask(validity, n, seed))
    logits = torch.where(valid, 0.0, prng.INVALID_LOGIT)
    key = prng.prng_key(seed)
    torch.testing.assert_close(
        prng.categorical_valid(key, valid, shape),
        prng.categorical(key, logits, shape), rtol=0, atol=0)


def test_timestamp_seed_matches_jax_frames(x64_off):
    """The relocalization seed of every row timestamp equals the JAX
    frame's (an f32 timestamp with x64 off); the f64 product would not."""
    ts = np.arange(720) * 0.1
    want = [int(jnp.asarray(t, jnp.float64) * 1e3) & 0x7FFFFFFF
            for t in ts]
    assert [timestamp_seed(t) for t in ts] == want
    f64 = [int(t * 1e3) & 0x7FFFFFFF for t in ts]
    assert f64 != want


# ---------------------------------------------------------------------------
# The solvers, keyed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["general", "planar"])
def test_monocular_init_keyed(name, x64_off):
    uv1, uv2, seed, *_ = two_view_case(name)
    valid = np.ones(300, bool)
    valid[-7:] = False
    jcam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    want = jinit.monocular_init(J(uv1), J(uv2), J(valid), jcam,
                                jax.random.PRNGKey(seed))
    got = tinit.monocular_init(T(uv1), T(uv2), T(valid),
                               convert.camera_from_jax(jcam),
                               prng.prng_key(seed))
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(got.R21.numpy(), np.asarray(want.R21),
                               atol=1e-4)
    np.testing.assert_allclose(got.t21.numpy(), np.asarray(want.t21),
                               atol=1e-4)
    assert (got.good.numpy() == np.asarray(want.good)).mean() >= 0.99
    assert abs(int(got.n_good) - int(want.n_good)) <= 3


def test_pnp_ransac_keyed(x64_off):
    rays, pw, valid, _, _, _ = pnp_problem(10, purity=0.7)
    want = jpnp.pnp_ransac(J(rays), J(pw), J(valid), jax.random.PRNGKey(5),
                           n_hyp=512, thresh=2.0 / 400.0, min_inliers=10)
    got = tpnp.pnp_ransac(T(rays), T(pw), T(valid), prng.prng_key(5),
                          n_hyp=512, thresh=2.0 / 400.0, min_inliers=10)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)


def test_pnp_ransac_3d3d_keyed(x64_off):
    rays, pw, valid, p_cam, valid3d, _ = pnp_problem(12, purity=0.4)
    want = jpnp.pnp_ransac_3d3d(J(p_cam), J(rays), J(pw), J(valid3d),
                                J(valid), jax.random.PRNGKey(7), n_hyp=256,
                                thresh=3.0 / 400.0, min_inliers=10)
    got = tpnp.pnp_ransac_3d3d(T(p_cam), T(rays), T(pw), T(valid3d),
                               T(valid), prng.prng_key(7), n_hyp=256,
                               thresh=3.0 / 400.0, min_inliers=10)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)


@pytest.mark.parametrize("with_scale", [True, False])
def test_sim3_ransac_keyed(with_scale, x64_off):
    p_src, p_dst, valid = sim3_pairs(5, with_scale=with_scale)
    want = jsim3.sim3_ransac(J(p_src), J(p_dst), J(valid),
                             jax.random.PRNGKey(11), inlier_thresh=0.05,
                             with_scale=with_scale)
    got = tsim3.sim3_ransac(T(p_src), T(p_dst), T(valid), prng.prng_key(11),
                            inlier_thresh=0.05, with_scale=with_scale)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    for a, b in ((got.R, want.R), (got.t, want.t), (got.s, want.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
