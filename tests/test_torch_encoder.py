"""The port's wheel-encoder path against the JAX package's: the encoder
and feature-level world synthesis, the prior-augmented motion solve, the
VEO prediction in both covariance modes (test_encoder_cov.py's case), and
feature-level VEO and VIEO runs (the JAX package's world.observe features,
the same wheel and IMU streams) with blanked frames the encoder carries.

Tolerances:
- synthesis (make_encoder_samples, figure_eight_trajectory, observe):
  equal (both are the same numpy code on the same generator);
- pose_optimization_with_prior: translation within 1e-4 m, rotation
  matrix entries within 1e-5, inliers equal (f32 LM iterations, sums in
  another order);
- EncoderFrontend._predict: pose within 1e-5, the information within 1e-3
  relative to its largest entry (f32 SE(2) preintegration on each side,
  the 6x6 inverse in float64 on the host);
- VEO and VIEO runs: identical track states and keyframe counts, and
  per-frame poses within 2e-3 m and 2e-3 rad (the fused solves run f32
  LM iterations whose accumulations differ in order); both trajectories
  within 2 cm of the truth (ATE RMSE).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vieo_slam_tpu import native as jnative
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.io.evaluate import ate
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.solvers import motion_ba as jmba
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu.vio.encoder_frontend import EncoderConfig as JEncoderConfig
from vieo_slam_tpu.vio.encoder_frontend import (
    EncoderFrontend as JEncoderFrontend)
from vieo_slam_tpu.vio.frontend import VioConfig as JVioConfig
from vieo_slam_tpu.vio.frontend import VioFrontend as JVioFrontend
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.solvers import motion_ba as tmba
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.vio.encoder_frontend import (EncoderConfig,
                                                      EncoderFrontend)
from vieo_slam_tpu_torch.vio.frontend import VioConfig, VioFrontend

from test_torch_system import rot_angle

torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2
BG = np.array([0.01, -0.02, 0.015], np.float32)
BA = np.array([0.05, 0.03, -0.04], np.float32)
SLAB = 1024
# test_encoder_cov.py's encoder axes in camera coordinates.
RBE_COV = np.array([[0.0, -1.0, 0.0],
                    [0.0, 0.0, -1.0],
                    [1.0, 0.0, 0.0]], np.float64)
T = torch.from_numpy


def circle(n, omega):
    ts = np.arange(n) * 0.1
    Rwc, twc, v_w, a_w = jworld.circle_trajectory(
        ts, radius=1.0, omega=omega, look_outward=True)
    # The encoder frame: x along the travel, z up (constant on a circle).
    x_e = Rwc[0].T @ (v_w[0] / np.linalg.norm(v_w[0]))
    z_e = Rwc[0].T @ np.array([0.0, 0.0, 1.0])
    Rbe = np.stack([x_e, np.cross(z_e, x_e), z_e], axis=-1).astype(
        np.float64)
    return ts, (Rwc, twc, v_w, a_w), Rbe


def test_synthesis_matches_jax():
    ts, (Rwc, twc, v_w, a_w), Rbe = circle(30, 0.4)
    args = (ts, Rwc.astype(np.float64), twc.astype(np.float64), Rbe,
            np.array([0.05, 0.0, -0.1]))
    kw = dict(rate_hz=100.0, half_track=0.28, noise_v=2e-3, seed=7)
    for g, w in zip(tworld.make_encoder_samples(*args, **kw),
                    jworld.make_encoder_samples(*args, **kw)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for heading in ("tangent", (0.5, -0.2, 0.0)):
        for g, w in zip(tworld.figure_eight_trajectory(ts, a=3.0, b=1.0,
                                                       heading=heading),
                        jworld.figure_eight_trajectory(ts, a=3.0, b=1.0,
                                                       heading=heading)):
            np.testing.assert_array_equal(g, w)
    wcfg = dict(n_landmarks=600, seed=3, extent=(6.0, 4.5, 3.0),
                dynamic_frac=0.02)
    wj = jworld.SyntheticWorld(jworld.WorldConfig(**wcfg))
    wt = tworld.SyntheticWorld(tworld.WorldConfig(**wcfg))
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    cj, ct = jcm.make_pinhole(*CAM), tcm.make_pinhole(*CAM)
    for i in range(3):
        kw = dict(bf=BF, n_kp=300, pixel_noise=0.25, clutter=30)
        oj = wj.observe(Rcw[i], tcw[i], cj, rng=np.random.RandomState(i),
                        **kw)
        ot = wt.observe(Rcw[i], tcw[i], ct, rng=np.random.RandomState(i),
                        **kw)
        assert oj.keys() == ot.keys()
        for k in oj:
            np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
        assert ot["valid"].sum() > 100
    # the world's own generator, drawn in the same order
    for _ in range(2):
        oj = wj.observe(Rcw[0], tcw[0], cj, n_kp=200)
        ot = wt.observe(Rcw[0], tcw[0], ct, n_kp=200)
        np.testing.assert_array_equal(ot["uv"], oj["uv"])


def _prior_problem(seed, bias):
    """test_encoder_cov.py's fused problem: 20 points seen from a camera
    shifted `bias` along x, the prior at the identity."""
    rng = np.random.RandomState(seed)
    n = 20
    pw = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4.0, 20.0, n)], -1).astype(np.float32)
    cam = tcm.make_pinhole(*CAM)
    uv = tcm.project(cam, T(pw + np.float32([bias, 0.0, 0.0]))).numpy()
    uv[3] += 40.0                                   # one outlier
    ur = np.full(n, -1.0, np.float32)
    ur[::3] = uv[::3, 0] - BF / pw[::3, 2]          # some stereo points
    return dict(pw=pw, uv=uv, ur=ur, inv_sigma2=np.ones(n, np.float32),
                valid=np.ones(n, bool))


@pytest.mark.parametrize("full_cov", [True, False])
def test_pose_optimization_with_prior_matches_jax(full_cov):
    info = _predict(JEncoderFrontend, jcm, full_cov)[2]
    p = _prior_problem(1, 0.03)
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.float32([0.01, -0.005, 0.02])
    jout = jmba.pose_optimization_with_prior(
        jnp.asarray(R0), jnp.asarray(t0),
        jmba.PoseObs(**{k: jnp.asarray(v) for k, v in p.items()}),
        jcm.make_pinhole(*CAM), jnp.asarray(BF, jnp.float32),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.asarray(info), rounds=2, iters_per_round=4)
    tout = tmba.pose_optimization_with_prior(
        T(R0), T(t0), tmba.PoseObs(**{k: T(v) for k, v in p.items()}),
        tcm.make_pinhole(*CAM), BF, torch.eye(3), torch.zeros(3),
        T(np.asarray(info, np.float32)), rounds=2, iters_per_round=4)
    np.testing.assert_allclose(tout.tcw.numpy(), np.asarray(jout.tcw),
                               atol=1e-4)
    np.testing.assert_allclose(tout.Rcw.numpy(), np.asarray(jout.Rcw),
                               atol=1e-5)
    np.testing.assert_array_equal(tout.inliers.numpy(),
                                  np.asarray(jout.inliers))
    assert not bool(tout.inliers[3])
    # the prior pulls the pose off vision's 3 cm lateral vote
    assert abs(float(tout.tcw[0])) < 0.03


def _predict(frontend_cls, cmod, full_cov, **sys_kw):
    """test_encoder_cov.py's prediction: one frame window of straight
    driving at 1 m/s under per-wheel slip noise."""
    system_cls, cfg_cls, sys_cfg = (
        (JSystem, JEncoderConfig, JSystemConfig) if cmod is jcm
        else (System, EncoderConfig, SystemConfig))
    sys_ = system_cls(cmod.make_pinhole(*CAM), BF, sys_cfg(), **sys_kw)
    fe = frontend_cls(sys_, cfg=cfg_cls(
        enc_half_track=0.28, enc_sigma_v=0.15, enc_Rbe=RBE_COV,
        enc_tbe=np.zeros(3), full_cov=full_cov))
    fe._last_body = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    for i in range(10):
        fe.track_encoder(i * 0.01, 1.0, 1.0)
    pred = fe._predict(-0.005, 0.095)
    assert pred is not None
    return pred


@pytest.mark.parametrize("full_cov", [True, False])
def test_encoder_prediction_matches_jax(full_cov):
    Rj, tj, ij = _predict(JEncoderFrontend, jcm, full_cov)
    Rt, tt, it = _predict(EncoderFrontend, tcm, full_cov, device="cpu")
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    ij = np.asarray(ij)
    assert it.dtype == np.float32
    np.testing.assert_allclose(it, ij, atol=1e-3 * np.abs(ij).max())
    if full_cov:        # lateral (camera x) tight, along the travel loose
        assert it[0, 0] > 20.0 * it[2, 2]
    else:
        assert np.allclose(it, np.diag(np.diag(it)))


def observations(n, omega, drop, Rwc, twc):
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=3, extent=(6.0, 4.5, 3.0)))
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    rng = np.random.RandomState(11)
    cam = jcm.make_pinhole(*CAM)
    obs = []
    for i in range(n):
        o = world.observe(Rcw[i], tcw[i], cam, bf=BF, n_kp=400,
                          pixel_noise=0.25, bit_flips=4, clutter=30, rng=rng,
                          max_depth=10.0)
        if i in drop:
            o = dict(o, valid=np.zeros_like(o["valid"]))     # lens covered
        obs.append(o)
    return obs


def drive(front, maker, ts, obs, enc, imu=None, **kw):
    """Feed the wheel (and IMU) samples up to each frame's time, then the
    frame; returns the track states."""
    states, i_enc, i_imu = [], 0, 0
    for i in range(len(ts)):
        while imu is not None and i_imu < len(imu[0]) \
                and imu[0][i_imu] <= ts[i]:
            front.track_odom(imu[0][i_imu], imu[1][i_imu], imu[2][i_imu])
            i_imu += 1
        while i_enc < len(enc[0]) and enc[0][i_enc] <= ts[i]:
            front.track_encoder(enc[0][i_enc], enc[1][i_enc], enc[2][i_enc])
            i_enc += 1
        o = obs[i]
        f = maker(o["uv"], o["level"], o["angle"], o["desc"], o["valid"],
                  ur=o["ur"], depth=o["depth"], timestamp=float(ts[i]), **kw)
        states.append(front.track_frame(f).name)
    return states


def _systems():
    js = JSystem(jcm.make_pinhole(*CAM), BF, JSystemConfig(
        tracker=JTrackerConfig(local_landmark_cap=SLAB)))
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    return js, ps


def _same_runs(js, ps, sj, st, ts, twc):
    assert sj == st, (sj, st)
    assert js.map.n_keyframes() == ps.map.n_keyframes()
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 2e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 2e-3, i
    for s in (js, ps):
        traj = s.tracker.trajectory
        p = np.asarray([-(np.asarray(x[1]).T @ np.asarray(x[2]))
                        for x in traj])
        assert ate(np.asarray([x[0] for x in traj]), p, ts,
                   twc)["rmse"] < 0.02


VEO_N = 24
VEO_DROP = range(14, 18)


@pytest.fixture(scope="module")
def veo_runs(request):
    # The JAX front end's wheel ring on its numpy fallback, so that
    # convert.encoder_frontend_from_jax can read its samples.
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    request.addfinalizer(mp.undo)
    ts, (Rwc, twc, _, _), Rbe = circle(VEO_N + 1, 0.4)
    enc = jworld.make_encoder_samples(
        ts, Rwc.astype(np.float64), twc.astype(np.float64), Rbe,
        np.zeros(3), rate_hz=100.0, half_track=0.28, noise_v=2e-3, seed=7)
    obs = observations(VEO_N + 1, 0.4, VEO_DROP, Rwc, twc)
    cfg = dict(enc_half_track=0.28, enc_sigma_v=5e-3, enc_Rbe=Rbe,
               enc_tbe=np.zeros(3))
    js, ps = _systems()
    jf = JEncoderFrontend(js, cfg=JEncoderConfig(**cfg))
    pf = EncoderFrontend(ps, cfg=EncoderConfig(**cfg))
    sj = drive(jf, jframe.make_frame_from_features, ts[:VEO_N], obs, enc)
    st = drive(pf, tframe.make_frame_from_features, ts[:VEO_N], obs, enc,
               device="cpu")
    return dict(js=js, ps=ps, jf=jf, pf=pf, sj=sj, st=st, ts=ts, twc=twc,
                enc=enc, obs=obs)


def test_veo_run_matches_jax(veo_runs):
    r = veo_runs
    _same_runs(r["js"], r["ps"], r["sj"], r["st"], r["ts"][:VEO_N],
               r["twc"])
    # fused from the second frame on; the blanked frames bridged
    assert r["st"][0] == "OK" and "LOST" not in r["st"]
    assert [r["st"][i] for i in VEO_DROP] == ["ODOMOK"] * len(VEO_DROP)
    assert r["pf"].enc_ring.native and r["pf"].enc_ring.size() > 200
    # the body pose stored on the keyframes (map save/load carries it)
    m = r["ps"].map
    k = m.keyframe_ids()[-1]
    np.testing.assert_allclose(m.kf_pwb[k], np.asarray(
        r["js"].map.kf_pwb[k]), atol=2e-3)


def test_one_veo_frame_from_converted_state(veo_runs):
    """A port front end started from the JAX front end's state (map,
    tracker, ring contents, last time and body pose) tracks the next frame
    as the JAX one does."""
    r = veo_runs
    js, jf = r["js"], r["jf"]
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    ps.map = convert.map_from_jax(js.map)
    ps.tracker.map = ps.mapper.map = ps.map
    for name in ("Rcw", "tcw", "velocity", "_prev_vel_rot", "last_kf_id",
                 "frames_since_kf", "frame_id", "ref_tracked",
                 "odomok_frames"):
        setattr(ps.tracker, name, getattr(js.tracker, name))
    ps.tracker.state = type(ps.tracker.state)[js.tracker.state.name]
    pf = convert.encoder_frontend_from_jax(jf, ps)
    assert pf.last_t == jf.last_t and pf.enc_ring.native
    t1 = float(r["ts"][VEO_N])
    np.testing.assert_array_equal(pf.enc_ring.window(0.0, t1, 4096)[0],
                                  jf.enc_ring.window(0.0, t1, 4096)[0])
    ts, obs, enc = r["ts"], r["obs"], r["enc"]
    keep = (enc[0] > ts[VEO_N - 1]) & (enc[0] <= ts[VEO_N])
    tail = tuple(x[keep] for x in enc)
    sj = drive(jf, jframe.make_frame_from_features, ts[VEO_N:],
               obs[VEO_N:], tail)
    st = drive(pf, tframe.make_frame_from_features, ts[VEO_N:], obs[VEO_N:],
               tail, device="cpu")
    assert sj == st == ["OK"]
    a, b = js.tracker.trajectory[-1], ps.tracker.trajectory[-1]
    assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3
    assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3


VIEO_N = 26
VIEO_DROP = range(21, 23)


def test_vieo_run_matches_jax():
    """VioFrontend(use_encoder=True): the IMU and wheel streams together,
    init thresholds small enough that the init and fused tracking happen
    inside the run, blanked frames after the init."""
    ts, (Rwc, twc, v_w, a_w), Rbe = circle(VIEO_N, 0.25)
    imu = jworld.make_imu_samples(ts, Rwc.astype(np.float64), v_w, a_w,
                                  rate_hz=200.0, bg=BG, ba=BA, noise_g=1e-4,
                                  noise_a=1e-3, seed=5)
    enc = jworld.make_encoder_samples(
        ts, Rwc.astype(np.float64), twc.astype(np.float64), Rbe,
        np.zeros(3), rate_hz=100.0, half_track=0.28, noise_v=2e-3, seed=7)
    obs = observations(VIEO_N, 0.25, VIEO_DROP, Rwc, twc)
    cfg = dict(init_min_kfs=5, init_min_span=1.2, init_final_span=100.0,
               use_encoder=True, enc_half_track=0.28, enc_sigma_v=5e-3,
               enc_Rbe=Rbe, enc_tbe=np.zeros(3))
    js, ps = _systems()
    jv = JVioFrontend(js, cfg=JVioConfig(**cfg))
    pv = VioFrontend(ps, cfg=VioConfig(**cfg))
    sj = drive(jv, jframe.make_frame_from_features, ts, obs, enc, imu)
    st = drive(pv, tframe.make_frame_from_features, ts, obs, enc, imu,
               device="cpu")
    _same_runs(js, ps, sj, st, ts, twc)
    assert jv.inited and pv.inited
    assert pv.enc_ring.native and pv.enc_ring.size() > 200
    assert [st[i] for i in VIEO_DROP] == ["ODOMOK"] * len(VIEO_DROP)
    np.testing.assert_allclose(pv.gw, jv.gw, atol=2e-3)
    np.testing.assert_allclose(pv.bg, jv.bg, atol=1e-3)
