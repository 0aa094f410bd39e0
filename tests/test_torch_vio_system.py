"""The port's stereo VIO front end against the JAX package's, end to end
at feature level: the same features (the JAX package's world.observe) and
the same IMU stream go through both VioFrontends over a short circle, with
init thresholds small enough that the provisional init, the final init
(the PRV keyframe backend and its init global BA) and fused tracking all
happen inside the run, and three blanked frames after the init that the
ODOMOK bridge carries.  Then one fused frame from the JAX front end's
state carried across by convert.vio_frontend_from_jax.

Tolerances: identical track states, keyframe counts and init frames;
per-frame poses within 2e-3 m and 2e-3 rad (the fused solve and the
backend's window BA run f32 LM iterations whose accumulations differ in
order); gravity within 2e-3 m/s^2, biases within 1e-3; the port's IMU
synthesis equals the JAX package's within 1e-5.
"""

import numpy as np
import pytest
import torch

from vieo_slam_tpu import native as jnative
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu.vio.frontend import VioConfig as JVioConfig
from vieo_slam_tpu.vio.frontend import VioFrontend as JVioFrontend
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.vio.frontend import VioConfig, VioFrontend

from test_torch_system import rot_angle

torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2
BG = np.array([0.01, -0.02, 0.015], np.float32)
BA = np.array([0.05, 0.03, -0.04], np.float32)
N_FRAMES = 40
DROP = range(31, 34)        # blanked frames, after the final init
VIO_CFG = dict(init_min_kfs=6, init_min_span=1.5, init_final_span=2.5)
SLAB = 1024


def scenario(n):
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=3, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(n) * 0.1
    Rwc, twc, v_w, a_w = jworld.circle_trajectory(
        ts, radius=1.0, omega=0.25, look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    imu = jworld.make_imu_samples(ts, Rwc.astype(np.float64), v_w, a_w,
                                  rate_hz=200.0, bg=BG, ba=BA, noise_g=1e-4,
                                  noise_a=1e-3, seed=5)
    rng = np.random.RandomState(11)
    cam = jcm.make_pinhole(*CAM)
    obs = []
    for i in range(n):
        o = world.observe(Rcw[i], tcw[i], cam, bf=BF, n_kp=400,
                          pixel_noise=0.25, bit_flips=4, clutter=30, rng=rng,
                          max_depth=10.0)
        if i in DROP:
            o = dict(o, valid=np.zeros_like(o["valid"]))     # lens covered
        obs.append(o)
    return ts, (Rwc, twc, v_w, a_w), imu, obs


def drive(vio, maker, ts, imu, obs, start=0, after=None, **kw):
    """Feed the IMU up to each frame's time, then the frame (from frame
    `start` on, the samples up to the frame before it already fed), then
    call `after`."""
    t_imu, gyro, acc = imu
    states, init_at = [], None
    i_imu = int(np.searchsorted(t_imu, ts[start - 1], side="right")) \
        if start else 0
    for i in range(start, len(ts)):
        while i_imu < len(t_imu) and t_imu[i_imu] <= ts[i]:
            vio.track_odom(t_imu[i_imu], gyro[i_imu], acc[i_imu])
            i_imu += 1
        o = obs[i]
        f = maker(o["uv"], o["level"], o["angle"], o["desc"], o["valid"],
                  ur=o["ur"], depth=o["depth"], timestamp=float(ts[i]), **kw)
        states.append(vio.track_frame(f).name)
        if vio.inited and init_at is None:
            init_at = i
        if after is not None:
            after()
    return states, init_at


@pytest.fixture(scope="module")
def runs(request):
    # The JAX front end's odometry ring on its numpy fallback, so that
    # convert.vio_frontend_from_jax can read its samples.
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    request.addfinalizer(mp.undo)
    ts, traj, imu, obs = scenario(N_FRAMES + 1)
    ts_run = ts[:N_FRAMES]
    js = JSystem(jcm.make_pinhole(*CAM), BF, JSystemConfig(
        tracker=JTrackerConfig(local_landmark_cap=SLAB)))
    jvio = JVioFrontend(js, cfg=JVioConfig(**VIO_CFG))
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    pvio = VioFrontend(ps, cfg=VioConfig(**VIO_CFG))
    sj, ij = drive(jvio, jframe.make_frame_from_features, ts_run, imu, obs)
    st, it = drive(pvio, tframe.make_frame_from_features, ts_run, imu, obs,
                   device="cpu")
    return dict(js=js, jvio=jvio, ps=ps, pvio=pvio, sj=sj, st=st, ij=ij,
                it=it, ts=ts, traj=traj, imu=imu, obs=obs)


def test_vio_run_matches_jax(runs):
    r = runs
    assert r["sj"] == r["st"], (r["sj"], r["st"])
    assert r["ij"] == r["it"] is not None and r["it"] < min(DROP)
    assert r["jvio"].final_inited and r["pvio"].final_inited
    assert r["pvio"].backend is not None
    assert r["js"].map.n_keyframes() == r["ps"].map.n_keyframes()
    for i, (a, b) in enumerate(zip(r["js"].tracker.trajectory,
                                   r["ps"].tracker.trajectory)):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 2e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 2e-3, i
    np.testing.assert_allclose(r["pvio"].gw, r["jvio"].gw, atol=2e-3)
    np.testing.assert_allclose(r["pvio"].bg, r["jvio"].bg, atol=1e-3)
    np.testing.assert_allclose(r["pvio"].ba, r["jvio"].ba, atol=1e-3)
    ns_j, ns_t = r["jvio"].ns_last, r["pvio"].ns_last
    for name in ("p", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(ns_t, name).numpy(),
                                   np.asarray(getattr(ns_j, name)),
                                   atol=2e-3)


def test_odomok_bridges_the_blanked_frames(runs):
    states = runs["st"]
    assert "LOST" not in states
    assert [states[i] for i in DROP] == ["ODOMOK"] * len(DROP)
    assert all(s == "OK" for s in states[max(DROP) + 1:])
    assert runs["ps"].tracker.odomok_frames == 0


def test_imu_synthesis_matches_jax(runs):
    Rwc, twc, v_w, a_w = runs["traj"]
    ts = runs["ts"]
    got = tworld.make_imu_samples(ts, Rwc.astype(np.float64), v_w, a_w,
                                  rate_hz=200.0, bg=BG, ba=BA, noise_g=1e-4,
                                  noise_a=1e-3, seed=5)
    for g, w in zip(got, runs["imu"]):
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_allclose(
        tworld.body_rates_from_poses(Rwc.astype(np.float64), ts),
        jworld.body_rates_from_poses(Rwc.astype(np.float64), ts), atol=1e-6)


def test_one_fused_frame_from_converted_state(runs):
    """Start a port front end from the JAX front end's state (map, tracker,
    NavState, prior, rings, init flags) and compare one fused frame."""
    r = runs
    js, jvio = r["js"], r["jvio"]
    assert jvio.inited and jvio.prior_info is not None
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    ps.map = convert.map_from_jax(js.map)
    ps.tracker.map = ps.mapper.map = ps.map
    for name in ("Rcw", "tcw", "velocity", "_prev_vel_rot", "last_kf_id",
                 "frames_since_kf", "frame_id", "ref_tracked",
                 "odomok_frames"):
        setattr(ps.tracker, name, getattr(js.tracker, name))
    ps.tracker.state = type(ps.tracker.state)[js.tracker.state.name]
    ps.mapper.skip_local_ba = js.mapper.skip_local_ba
    pvio = convert.vio_frontend_from_jax(jvio, ps)
    assert pvio.final_inited and pvio.backend is not None
    np.testing.assert_array_equal(
        pvio.ring.window(0.0, r["ts"][N_FRAMES - 1], 8192)[0],
        jvio.ring.window(0.0, r["ts"][N_FRAMES - 1], 8192)[0])
    sj, _ = drive(jvio, jframe.make_frame_from_features, r["ts"], r["imu"],
                  r["obs"], start=N_FRAMES)
    st, _ = drive(pvio, tframe.make_frame_from_features, r["ts"], r["imu"],
                  r["obs"], start=N_FRAMES, device="cpu")
    assert sj == st == ["OK"]
    a, b = js.tracker.trajectory[-1], ps.tracker.trajectory[-1]
    assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3
    assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3
    np.testing.assert_allclose(pvio.ns_last.v.numpy(),
                               np.asarray(jvio.ns_last.v), atol=1e-3)
    np.testing.assert_allclose(
        pvio.prior_info, np.asarray(jvio.prior_info),
        atol=2e-3 * np.abs(np.asarray(jvio.prior_info)).max())
