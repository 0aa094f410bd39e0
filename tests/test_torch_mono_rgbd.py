"""The port's RGB-D and monocular paths against the JAX package: the
two-view initializer, the build_*_frame functions, the renderer's depth and
photometric options, the depth-free cases of the solvers, and the RGB-D
System over a short rendered sequence (the monocular System is in
tests/test_torch_mono_system.py).

Tolerances and why:
  - monocular_init with the sample indices JAX drew: R21 and t21 within
    1e-4, `good` equal on >= 99 % of the matches, `ok` equal.  Both sides
    run f32 LAPACK SVDs of the same matrices; singular-vector signs differ
    by library, which the outputs do not depend on.
  - build_*_frame: keypoints, levels, validity equal; angles 2e-4 and
    descriptor bits <= 0.5 % (tests/test_torch_orb.py gives the reasons);
    RGB-D depth and right-u equal wherever both have a reading (the depth
    map is sampled at the same pixel).
  - Depth-free pose optimization and local BA: the bounds of
    tests/test_torch_solvers.py (poses 1e-4, identical inlier sets).
  - RGB-D System: identical track states and keyframe counts, poses within
    1e-3 m and 1e-3 rad per frame, as tests/test_torch_system.py states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.solvers import initializer as jinit
from vieo_slam_tpu.solvers import local_ba as jlba
from vieo_slam_tpu.solvers import motion_ba as jmba
from vieo_slam_tpu.system import SensorMode as JSensorMode
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.io.evaluate import ate, umeyama_alignment
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.solvers import initializer as tinit
from vieo_slam_tpu_torch.solvers import local_ba as tlba
from vieo_slam_tpu_torch.solvers import motion_ba as tmba
from vieo_slam_tpu_torch.system import SensorMode, System
from vieo_slam_tpu_torch.utils import prng

from test_torch_solvers import CAM_ARGS, ba_problem, pose_problem
from test_torch_system import rot_angle

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
CAM = (200.0, 200.0, 160.0, 120.0, 320, 240)
BF = 200.0 * 0.2
WORLD = dict(n_landmarks=1800, seed=3, extent=(6.0, 4.5, 3.0))


def circle(n, omega=0.25):
    ts = np.arange(n) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=omega,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    return ts, Rcw, tcw, twc


@pytest.fixture
def jax_fused_tail(monkeypatch):
    monkeypatch.setattr(jorb, "_use_fused_tail", lambda: True)
    monkeypatch.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    monkeypatch.setattr(jorb, "_use_mxu_gather", lambda: False)


# ---------------------------------------------------------------------------
# Two-view initializer
# ---------------------------------------------------------------------------


def two_view_case(name):
    """The three scenes of tests/test_mono.py: (uv1, uv2, key seed, R21, t21,
    mismatches)."""
    cam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)

    def proj(p):
        return np.array(jcm.project(cam, jnp.asarray(p, jnp.float32)))

    if name == "general":
        rng = np.random.RandomState(0)
        pw = rng.randn(300, 3).astype(np.float32) * [2, 1.5, 1] + [0, 0, 5]
        xi, n_bad, seed = [0.05, -0.02, 0.08, 0.2, -0.1, 0.05], 60, 1
    elif name == "planar":
        rng = np.random.RandomState(4)
        xy = rng.randn(300, 2).astype(np.float32) * [2.0, 1.5]
        z = 4.0 + 0.3 * xy[:, 0] + 0.1 * xy[:, 1]
        pw = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        xi, n_bad, seed = [0.04, -0.03, 0.06, 0.25, -0.12, 0.08], 45, 3
    else:
        rng = np.random.RandomState(1)
        pw = rng.randn(300, 3).astype(np.float32) * [2, 1.5, 1] + [0, 0, 5]
        R21 = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.1, 0.02])))
        return (proj(pw).astype(np.float32),
                proj(pw @ R21.T).astype(np.float32), 2, R21, None, 0)
    R21, t21 = jlie.se3_exp(jnp.asarray(xi, jnp.float32))
    t21 = np.asarray(t21 / jnp.linalg.norm(t21))
    R21 = np.asarray(R21)
    uv1 = proj(pw) + rng.randn(300, 2) * 0.3
    uv2 = proj(pw @ R21.T + t21) + rng.randn(300, 2) * 0.3
    uv2[:n_bad] = rng.rand(n_bad, 2) * [640, 480]
    return uv1.astype(np.float32), uv2.astype(np.float32), seed, R21, t21, \
        n_bad


@pytest.mark.parametrize("name", ["general", "planar", "pure_rotation"])
def test_monocular_init_matches_jax(name):
    uv1, uv2, seed, R21, t21, n_bad = two_view_case(name)
    valid = np.ones(300, bool)
    valid[-7:] = False                   # capacity padding, never sampled
    key = jax.random.PRNGKey(seed)
    jcam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    want = jinit.monocular_init(J(uv1), J(uv2), J(valid), jcam, key)
    idx = np.asarray(jax.random.categorical(
        key, jnp.where(J(valid), 0.0, -1e9), shape=(256, 8)))
    assert valid[idx].all()
    got = tinit.monocular_init_from_indices(
        T(uv1), T(uv2), T(valid), convert.camera_from_jax(jcam),
        T(idx.astype(np.int64)))
    assert bool(got.ok) == bool(want.ok)
    if name == "pure_rotation":
        assert not bool(got.ok)          # no parallax: rejected
        return
    assert bool(got.ok)
    np.testing.assert_allclose(got.R21.numpy(), np.asarray(want.R21),
                               atol=1e-4)
    np.testing.assert_allclose(got.t21.numpy(), np.asarray(want.t21),
                               atol=1e-4)
    good_j = np.asarray(want.good)
    assert (got.good.numpy() == good_j).mean() >= 0.99
    assert abs(int(got.n_good) - int(want.n_good)) <= 3
    both = good_j & got.good.numpy()
    np.testing.assert_allclose(got.pw.numpy()[both], np.asarray(want.pw)[both],
                               rtol=2e-3, atol=2e-3)
    # and the answer is the scene's motion
    assert rot_angle(got.R21.numpy(), R21) < 0.02
    assert abs(float(got.t21.numpy() @ t21)) > 0.99
    assert got.good.numpy()[:n_bad].mean() < 0.2
    assert not got.good.numpy()[-7:].any()
    back = convert.mono_init_result_from_jax(want)
    assert isinstance(back, tinit.MonoInitResult) and bool(back.ok)


def test_monocular_init_draws_from_generator():
    """The key decides the samples (the JAX package's threefry stream,
    `utils.prng`): same key, same result; only valid matches are
    drawn."""
    uv1, uv2, *_ = two_view_case("general")
    valid = np.ones(300, bool)
    valid[::3] = False
    cam = tcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    idx = tinit.draw_hypotheses(T(valid), prng.prng_key(5))
    assert idx.shape == (256, 8) and valid[idx.numpy()].all()
    a = tinit.monocular_init(T(uv1), T(uv2), T(valid), cam,
                             prng.prng_key(5))
    b = tinit.monocular_init(T(uv1), T(uv2), T(valid), cam,
                             prng.prng_key(5))
    assert bool(a.ok) and torch.equal(a.R21, b.R21) \
        and torch.equal(a.good, b.good)
    assert not a.good.numpy()[::3].any()


# ---------------------------------------------------------------------------
# Depth-free solver cases
# ---------------------------------------------------------------------------


def test_pose_optimization_mono_only():
    _, obs, R0, t0 = pose_problem(2)
    obs["ur"] = np.full_like(obs["ur"], -1.0)
    want = jmba.pose_optimization(
        J(R0), J(t0), jmba.PoseObs(**{k: J(v) for k, v in obs.items()}),
        jcm.make_pinhole(*CAM_ARGS), 0.0, mode="plm")
    got = tmba.pose_optimization(
        T(R0), T(t0), tmba.PoseObs(**{k: T(v) for k, v in obs.items()}),
        tcm.make_pinhole(*CAM_ARGS), 0.0, mode="plm")
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) > 120


def test_local_ba_mono_only():
    _, fields = ba_problem(seed=1)
    fields["obs_ur"] = np.full_like(fields["obs_ur"], -1.0)
    # Without depth one fixed pose leaves the scale free, and the two
    # sides would drift along it by their rounding; two fixed poses pin it.
    fields["fixed"][1] = True
    want = jlba.local_ba(jlba.BAProblem(**{k: J(v) for k, v in
                                           fields.items()}),
                         jcm.make_pinhole(*CAM_ARGS), 0.0)
    got = tlba.local_ba(tlba.BAProblem(**{k: T(v) for k, v in
                                          fields.items()}),
                        tcm.make_pinhole(*CAM_ARGS), 0.0)
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.pw.numpy(), np.asarray(want.pw),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.obs_inlier.numpy(),
                                  np.asarray(want.obs_inlier))


# ---------------------------------------------------------------------------
# Renderer, evaluation, frame construction
# ---------------------------------------------------------------------------


def test_renderer_depth_noise_gain_bias_match_jax():
    world_j = jworld.SyntheticWorld(jworld.WorldConfig(**WORLD))
    world_t = tworld.SyntheticWorld(tworld.WorldConfig(**WORLD))
    _, Rcw, tcw, _ = circle(3)
    for i in range(3):
        kw = dict(return_depth=True, depth_outlier_frac=0.07 * i,
                  noise_sigma=2.0, gain=1.0 + 0.05 * i, bias=3.0 - 2 * i)
        img_j, depth_j = world_j.render_view(
            jcm.make_pinhole(*CAM), Rcw[i], tcw[i],
            rng=np.random.RandomState(11 + i), **kw)
        img_t, depth_t = world_t.render_view(
            tcm.make_pinhole(*CAM), Rcw[i], tcw[i],
            rng=np.random.RandomState(11 + i), **kw)
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(depth_t, depth_j)
        assert (depth_t > 0).mean() > 0.2 and (depth_t == 0).any()
    plain = world_t.render_view(tcm.make_pinhole(*CAM), Rcw[0], tcw[0])
    np.testing.assert_array_equal(plain, world_j.render_view(
        jcm.make_pinhole(*CAM), Rcw[0], tcw[0]))


def test_ate_with_scale():
    from vieo_slam_tpu.io import evaluate as jeval
    rng = np.random.RandomState(2)
    gt = rng.randn(40, 3)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.5])), np.float64)
    est = (gt @ R.T + [1.0, -2.0, 0.5]) / 2.5 + rng.randn(40, 3) * 1e-3
    ts = np.arange(40) * 0.1
    for with_scale in (False, True):
        got = ate(ts, est, ts, gt, with_scale=with_scale)
        want = jeval.ate(ts, est, ts, gt, with_scale=with_scale)
        assert got == pytest.approx(want)
    assert got["scale"] == pytest.approx(2.5, rel=1e-2) and got["rmse"] < 0.01
    s, R_, t_ = umeyama_alignment(est, gt, with_scale=True)
    np.testing.assert_allclose(s * est @ R_.T + t_, gt, atol=0.02)
    assert ate(ts[:2], est[:2], ts[:2], gt[:2])["scale"] == 1.0


def rendered(i=0, depth=False):
    world = jworld.SyntheticWorld(jworld.WorldConfig(**WORLD))
    _, Rcw, tcw, _ = circle(i + 1)
    out = world.render_view(jcm.make_pinhole(*CAM), Rcw[i], tcw[i],
                            return_depth=depth)
    rng = np.random.RandomState(5 + i)
    if depth:
        return (out[0] + rng.rand(*out[0].shape)).astype(np.float32), out[1]
    return (out + rng.rand(*out.shape)).astype(np.float32)


def assert_features_agree(tf, jf):
    valid = np.asarray(jf.valid)
    assert valid.sum() > 200
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    np.testing.assert_array_equal(tf.uv.numpy(), np.asarray(jf.uv))
    np.testing.assert_array_equal(tf.level.numpy(), np.asarray(jf.level))
    np.testing.assert_allclose(tf.angle.numpy()[valid],
                               np.asarray(jf.angle)[valid], atol=2e-4)
    want = np.asarray(jf.desc, np.uint32).view(np.int32)
    flips = np.unpackbits((tf.desc.numpy() ^ want)[valid].view(np.uint8)).sum()
    assert flips <= 0.005 * valid.sum() * 256
    assert float(np.asarray(jf.timestamp, np.float64)) == tf.timestamp


def test_build_mono_frame_matches_jax(jax_fused_tail):
    img = rendered()
    cfg_j, cfg_t = jorb.OrbConfig(400, 4), torb.OrbConfig(400, 4)
    # The JAX package's features as its System computes them (x64 off), with
    # the f64 timestamp that x64 keeps (x64 off rounds it to f32).
    with jax.enable_x64(False):
        jf = jax.jit(lambda im: jframe.build_mono_frame(
            im, cfg_j, timestamp=0.3))(J(img))
    jf = jf._replace(timestamp=jnp.asarray(0.3, jnp.float64))
    tf = tframe.build_mono_frame(img, cfg_t, timestamp=0.3, device="cpu")
    assert_features_agree(tf, jf)
    for name in ("ur", "depth"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
        assert (getattr(tf, name) == -1).all()
    tf2 = tframe.make_mono_frame(img, cfg_t, 0.3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tf[:-1], tf2[:-1]))
    assert tf2.timestamp == 0.3


def test_build_rgbd_frame_matches_jax(jax_fused_tail):
    img, depth = rendered(depth=True)
    cfg_j, cfg_t = jorb.OrbConfig(400, 4), torb.OrbConfig(400, 4)
    with jax.enable_x64(False):     # the JAX System's mode
        jf = jax.jit(lambda im, d: jframe.build_rgbd_frame(
            im, d, cfg_j, bf=BF, depth_scale=0.5, timestamp=1.5))(
                J(img), J(depth))
    tf = tframe.build_rgbd_frame(img, depth, cfg_t, bf=BF, depth_scale=0.5,
                                 timestamp=1.5, device="cpu")
    assert_features_agree(tf, jf)
    np.testing.assert_array_equal(tf.depth.numpy(), np.asarray(jf.depth))
    np.testing.assert_allclose(tf.ur.numpy(), np.asarray(jf.ur), rtol=1e-6)
    has = tf.depth.numpy() > 0
    assert has.sum() > 150 and (~has).any()
    assert (tf.ur.numpy()[~has] == -1).all()


# ---------------------------------------------------------------------------
# Systems
# ---------------------------------------------------------------------------

N_RGBD = 8


@pytest.fixture(scope="module")
def rgbd_runs(request):
    """Both Systems over the same noisy rendered RGB-D frames."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jorb, "_use_fused_tail", lambda: True)
    mp.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    mp.setattr(jorb, "_use_mxu_gather", lambda: False)
    request.addfinalizer(mp.undo)
    world = jworld.SyntheticWorld(jworld.WorldConfig(**WORLD))
    ts, Rcw, tcw, _ = circle(N_RGBD)
    jcam = jcm.make_pinhole(*CAM)
    cfg_j, cfg_t = jorb.OrbConfig(400, 4), torb.OrbConfig(400, 4)
    build = jax.jit(lambda im, d, t: jframe.build_rgbd_frame(
        im, d, cfg_j, bf=BF, timestamp=t))
    jcfg = JSystemConfig(sensor=JSensorMode.RGBD,
                         tracker=JTrackerConfig(use_predicted_scale=True))
    js = JSystem(jcm.make_pinhole(*CAM), BF, jcfg)
    pcfg = convert.system_config_from_jax(jcfg)
    assert pcfg.tracker == TrackerConfig(use_predicted_scale=True)
    assert pcfg.sensor is SensorMode.RGBD
    ps = System(tcm.make_pinhole(*CAM), BF, pcfg, device="cpu")
    rng = np.random.RandomState(5)
    rows = []
    for i in range(N_RGBD):
        img, depth = world.render_view(jcam, Rcw[i], tcw[i],
                                       return_depth=True)
        img = (img + rng.rand(*img.shape)).astype(np.float32)
        jf = build(J(img), J(depth), jnp.asarray(ts[i], jnp.float64))
        tf = tframe.build_rgbd_frame(img, depth, cfg_t, bf=BF,
                                     timestamp=float(ts[i]), device="cpu")
        rows.append((js.track_frame(jf), ps.track_frame(tf),
                     js.map.n_keyframes(), ps.map.n_keyframes()))
    return js, ps, rows


def test_rgbd_system_states_and_keyframes(rgbd_runs):
    js, ps, rows = rgbd_runs
    for i, (sj, st, kj, kt) in enumerate(rows):
        assert sj.name == st.name == "OK", (i, sj, st)
        assert kj == kt, (i, kj, kt)
    assert rows[-1][2] >= 2
    np.testing.assert_array_equal(ps.map.keyframe_ids(), js.map.keyframe_ids())
    assert abs(ps.map.n_landmarks() - js.map.n_landmarks()) \
        <= 0.02 * js.map.n_landmarks()


def test_rgbd_system_poses(rgbd_runs):
    js, ps, _ = rgbd_runs
    assert len(ps.tracker.trajectory) == N_RGBD
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert a[0] == b[0] and a[3] == b[3]
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3, i
    for a, b in zip(js.trajectory(), ps.trajectory()):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3


def test_new_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((240, 320), np.float32)
    cfg = torb.OrbConfig(n_features=100, n_levels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.build_mono_frame(img, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.build_rgbd_frame(img, img, cfg, bf=BF)
    with pytest.raises(RuntimeError, match="CUDA"):
        torb.extract_orb_batch(img[None], cfg)
