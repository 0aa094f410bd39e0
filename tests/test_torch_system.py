"""The port's synchronous stereo System against the JAX package's, end to
end from pixels, plus the port's own guarantees: its renderer reproduces
the JAX renderer, it imports no JAX, and its entry points refuse to fall
back to the CPU.

Tolerances: per-frame poses within 1e-3 m and 1e-3 rad, identical track
states and keyframe counts.  The two extractions agree to the pyramid's
f32 ulps (tests/test_torch_orb.py), so a handful of matches may differ;
the images carry faint sensor noise so that flat background holds no
exact descriptor ties for those ulps to flip.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend.loop_closing import LoopCloser
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.io.odom_ring import OdomRing
from vieo_slam_tpu_torch.map.map_state import MapConfig, MapState
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.vio.backend import VioBackend

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

BASELINE = 0.2
CAM = (200.0, 200.0, 160.0, 120.0, 320, 240)
BF = 200.0 * BASELINE
N_FRAMES = 8


def rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def sequence(n):
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=1800, seed=3, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(n) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    return world, ts, Rcw, tcw


@pytest.fixture(scope="module")
def two_runs(request):
    """Both Systems over the same noisy rendered stereo frames, and the
    jitted JAX frame builder (reused so that it compiles once)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jorb, "_use_fused_tail", lambda: True)
    mp.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    mp.setattr(jorb, "_use_mxu_gather", lambda: False)
    request.addfinalizer(mp.undo)

    world, ts, Rcw, tcw = sequence(N_FRAMES)
    jcam = jcm.make_pinhole(*CAM)
    cfg_j = jorb.OrbConfig(n_features=400, n_levels=4)
    cfg_t = torb.OrbConfig(n_features=400, n_levels=4)
    build = jax.jit(lambda l, r, t: jframe.build_stereo_frame(
        l, r, cfg_j, bf=BF, min_depth=0.3, max_depth=15.0, timestamp=t))
    js = JSystem(jcm.make_pinhole(*CAM), BF, JSystemConfig(
        tracker=JTrackerConfig(use_predicted_scale=True)))
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(use_predicted_scale=True)), device="cpu")
    rng = np.random.RandomState(5)
    rows = []
    for i in range(N_FRAMES):
        left, right = world.render_stereo(jcam, Rcw[i], tcw[i], BASELINE)
        left = (left + rng.rand(*left.shape)).astype(np.float32)
        right = (right + rng.rand(*right.shape)).astype(np.float32)
        jf = build(jnp.asarray(left), jnp.asarray(right),
                   jnp.asarray(ts[i], jnp.float64))
        tf = tframe.build_stereo_frame(left, right, cfg_t, bf=BF,
                                       min_depth=0.3, max_depth=15.0,
                                       timestamp=float(ts[i]), device="cpu")
        rows.append((js.track_frame(jf), ps.track_frame(tf),
                     js.map.n_keyframes(), ps.map.n_keyframes(), jf, tf))
    return js, ps, rows, build


def test_frames_agree(two_runs):
    _, _, rows, _ = two_runs
    for *_, jf, tf in rows:
        valid = np.asarray(jf.valid)
        np.testing.assert_array_equal(tf.valid.numpy(), valid)
        np.testing.assert_array_equal(tf.uv.numpy(), np.asarray(jf.uv))
        assert float(np.asarray(jf.timestamp, np.float64)) == tf.timestamp
        stereo_j = np.asarray(jf.ur) >= 0
        stereo_t = tf.ur.numpy() >= 0
        assert (stereo_j != stereo_t).sum() <= 0.01 * valid.sum()
        both = stereo_j & stereo_t
        assert both.sum() > 100
        np.testing.assert_allclose(tf.depth.numpy()[both],
                                   np.asarray(jf.depth)[both], rtol=1e-5)


def test_system_poses_states_keyframes(two_runs):
    js, ps, rows, _ = two_runs
    for i, (sj, st, kj, kt, *_) in enumerate(rows):
        assert sj.name == st.name == "OK", (i, sj, st)
        assert kj == kt, (i, kj, kt)
    assert rows[-1][2] >= 2
    assert abs(ps.map.n_landmarks() - js.map.n_landmarks()) \
        <= 0.02 * js.map.n_landmarks()
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert a[0] == b[0] and a[3] == b[3]
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3, i
    for a, b in zip(js.trajectory(), ps.trajectory()):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3
    tum = ps.trajectory_tum().strip().split("\n")
    assert len(tum) == N_FRAMES and len(tum[0].split()) == 8
    report = ps.metrics_report()
    assert "track" in str(report)


def test_one_step_from_converted_state(two_runs):
    """Start the port from the JAX system's map, tracker state and frame
    (convert.py) and compare one tracking step."""
    js, _, _, build = two_runs
    world, ts, Rcw, tcw = sequence(N_FRAMES + 1)
    ps = System(convert.camera_from_jax(js.cam), BF, SystemConfig(
        tracker=TrackerConfig(use_predicted_scale=True)), device="cpu")
    ps.map = convert.map_from_jax(js.map)
    ps.tracker.map = ps.mapper.map = ps.map
    for name in ("state", "Rcw", "tcw", "velocity", "_prev_vel_rot",
                 "last_kf_id", "frames_since_kf", "frame_id", "ref_tracked"):
        value = getattr(js.tracker, name)
        if name == "state":
            value = type(ps.tracker.state)[value.name]
        setattr(ps.tracker, name, value)
    for name in ("kf_Rcw", "lm_pw", "lm_desc", "kf_lm_idx", "lm_n_obs"):
        np.testing.assert_array_equal(getattr(ps.map, name),
                                      getattr(js.map, name))
    jcam = jcm.make_pinhole(*CAM)
    left, right = world.render_stereo(jcam, Rcw[-1], tcw[-1], BASELINE)
    rng = np.random.RandomState(9)
    left = (left + rng.rand(*left.shape)).astype(np.float32)
    right = (right + rng.rand(*right.shape)).astype(np.float32)
    jf = build(jnp.asarray(left), jnp.asarray(right),
               jnp.asarray(ts[-1], jnp.float64))
    tf = convert.frame_from_jax(jf, device="cpu")
    np.testing.assert_array_equal(tf.desc.numpy(),
                                  np.asarray(jf.desc, np.uint32).view(np.int32))
    sj, st = js.track_frame(jf), ps.track_frame(tf)
    assert sj.name == st.name == "OK"
    assert js.map.n_keyframes() == ps.map.n_keyframes()
    a, b = js.tracker.trajectory[-1], ps.tracker.trajectory[-1]
    assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3
    assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3


def test_renderer_matches_jax():
    world_j = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=900, seed=7, extent=(6.0, 4.5, 3.0)))
    world_t = tworld.SyntheticWorld(tworld.WorldConfig(
        n_landmarks=900, seed=7, extent=(6.0, 4.5, 3.0)))
    np.testing.assert_array_equal(world_t.pw, world_j.pw)
    np.testing.assert_array_equal(world_t.desc, world_j.desc)
    ts = np.arange(3) * 0.3
    want = jworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                    look_outward=True)
    got = tworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                   look_outward=True)
    for g, w in zip(got, want):     # Rwc, twc, v_w, a_w
        np.testing.assert_array_equal(g, w)
    Rwc, twc = want[:2]
    Rwc_t, twc_t = got[:2]
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    Rcw_t, tcw_t = tworld.trajectory_to_tcw(Rwc_t, twc_t)
    np.testing.assert_array_equal(Rcw_t, Rcw)
    np.testing.assert_array_equal(tcw_t, tcw)
    for i in range(3):
        want = world_j.render_stereo(jcm.make_pinhole(*CAM), Rcw[i], tcw[i],
                                     BASELINE)
        got = world_t.render_stereo(tcm.make_pinhole(*CAM), Rcw[i], tcw[i],
                                    BASELINE)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_port_imports_no_jax():
    """Every module of the port imports with JAX made unimportable, and
    none of the JAX package's modules gets loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import vieo_slam_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "vieo_slam_tpu" or m.startswith("vieo_slam_tpu.")
               or m == "jax" and sys.modules[m] is not None
               or m.startswith("jax.") or m.startswith("jaxlib")]
        assert not bad, bad
        assert len(names) > 25, names
        vio = {pkg.__name__ + "." + m for m in (
            "math.navstate", "math.preintegration", "solvers.imu_factors",
            "solvers.vio_ba", "solvers.vio_local_ba", "vio.initialization",
            "vio.backend", "vio.frontend", "io.odom_ring")}
        assert vio <= set(names), vio - set(names)
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = tcm.make_pinhole(*CAM)
    img = np.zeros((240, 320), np.float32)
    cfg = torb.OrbConfig(n_features=100, n_levels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(cam, BF)
    with pytest.raises(RuntimeError, match="CUDA"):
        torb.extract_orb(img, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.build_stereo_frame(img, img, cfg, bf=BF)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoopCloser(cam, BF, MapState(MapConfig()))
    with pytest.raises(RuntimeError, match="CUDA"):
        System(cam, BF, SystemConfig(async_mapping=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        VioBackend(MapState(MapConfig()), cam, BF, OdomRing(), np.eye(3),
                   np.zeros(3))
