"""The port's monocular System against the JAX package over a short
rendered sequence (no depth: two-view initialization, then tracking and
local mapping on depth-free keyframes).

Tolerances and why:
  - Mono System: the port's initializer is given the RANSAC samples JAX
    draws for the same frame (the key of the frame count; under the
    suite's x64 JAX draws with f64 logits, a stream the port's f32 draw
    does not take), so both initialize on the same frame with two
    keyframes and lose no frame afterwards, with poses within 1e-3 m and
    1e-3 rad and the same scale-aligned ATE RMSE (within 1e-3 m; a
    full-size mono sequence with its 0.02 m bar runs on the GPU in
    chip_smoke.py phase 23).
"""

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
from vieo_slam_tpu.system import SensorMode as JSensorMode
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.io.evaluate import ate
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.solvers import initializer as tinit
from vieo_slam_tpu_torch.system import SensorMode, System, SystemConfig

from test_torch_mono_rgbd import CAM, WORLD, circle
from test_torch_system import rot_angle

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
N_MONO = 16


@pytest.fixture(scope="module")
def mono_runs(request):
    """Both Systems over the same rendered monocular frames (no depth)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jorb, "_use_fused_tail", lambda: True)
    mp.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    mp.setattr(jorb, "_use_mxu_gather", lambda: False)

    # The JAX System draws with f64 logits under the suite's x64 (a 64-bit
    # stream); the port draws as JAX does with x64 off.
    def jax_draw(valid, key, n_hyp=256):
        key = jnp.asarray(key, jnp.uint32)
        idx = jax.random.categorical(
            key, jnp.where(J(valid.numpy()), 0.0, -1e9), shape=(n_hyp, 8))
        return T(np.asarray(idx).astype(np.int64))

    mp.setattr(tinit, "draw_hypotheses", jax_draw)
    request.addfinalizer(mp.undo)
    world = jworld.SyntheticWorld(jworld.WorldConfig(**WORLD))
    ts, Rcw, tcw, twc = circle(N_MONO, omega=0.35)
    jcam = jcm.make_pinhole(*CAM)
    cfg_j, cfg_t = jorb.OrbConfig(600, 4), torb.OrbConfig(600, 4)
    build = jax.jit(lambda im, t: jframe.build_mono_frame(im, cfg_j,
                                                          timestamp=t))
    js = JSystem(jcm.make_pinhole(*CAM), 0.0, JSystemConfig(
        sensor=JSensorMode.MONOCULAR,
        tracker=JTrackerConfig(use_predicted_scale=True)))
    ps = System(tcm.make_pinhole(*CAM), 0.0, SystemConfig(
        sensor=SensorMode.MONOCULAR,
        tracker=TrackerConfig(use_predicted_scale=True)), device="cpu")
    rng = np.random.RandomState(6)
    rows = []
    for i in range(N_MONO):
        img = world.render_view(jcam, Rcw[i], tcw[i])
        img = (img + rng.rand(*img.shape)).astype(np.float32)
        jf = build(J(img), jnp.asarray(ts[i], jnp.float64))
        tf = tframe.build_mono_frame(img, cfg_t, timestamp=float(ts[i]),
                                     device="cpu")
        rows.append((js.track_frame(jf).name, ps.track_frame(tf).name,
                     js.map.n_keyframes(), ps.map.n_keyframes()))
    return js, ps, rows, ts, twc


def test_mono_system_initializes_like_jax(mono_runs):
    js, ps, rows, _, _ = mono_runs
    states_j = [r[0] for r in rows]
    states_t = [r[1] for r in rows]
    assert states_t == states_j
    first = states_t.index("OK")
    assert first >= 1 and rows[first][2] == rows[first][3] == 2
    assert all(s == "NOT_INITIALIZED" for s in states_t[:first])
    assert all(s == "OK" for s in states_t[first:])
    assert [r[2] for r in rows] == [r[3] for r in rows]
    # keyframe 0 is the held reference frame at the identity
    np.testing.assert_array_equal(ps.map.kf_Rcw[0], np.eye(3))
    assert ps.map.kf_frame_id[0] == first - 1
    assert ps.map.kf_frame_id[1] == first
    assert (ps.map.kf_depth[:2] < 0).all() and (ps.map.kf_ur[:2] < 0).all()
    # the initial map: at least the initializer's 60 points, as many as JAX
    for m in (ps.map, js.map):
        assert (m.kf_lm_idx[0] >= 0).sum() >= 60
    np.testing.assert_array_equal(ps.map.keyframe_ids(), js.map.keyframe_ids())
    assert abs(ps.map.n_landmarks() - js.map.n_landmarks()) \
        <= 0.02 * js.map.n_landmarks()


def test_mono_system_trajectory(mono_runs):
    js, ps, rows, ts, twc = mono_runs
    assert len(ps.tracker.trajectory) == N_MONO
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert a[0] == b[0] and a[3] == b[3]
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3, i
    res = []
    for s in (js, ps):
        traj = [x for x in s.tracker.trajectory if x[3] == "OK"]
        assert len(traj) >= 3
        pos = np.asarray([-(np.asarray(R).T @ np.asarray(t))
                          for _, R, t, _ in traj])
        res.append(ate(np.asarray([x[0] for x in traj]), pos, ts, twc,
                       with_scale=True))
    # a few frames after a low-parallax initialization at 320x240: the
    # error is the JAX system's own, which the port repeats
    assert res[1]["rmse"] == pytest.approx(res[0]["rmse"], abs=1e-3)
    assert res[1]["scale"] == pytest.approx(res[0]["scale"], rel=1e-2)
    assert res[1]["rmse"] < 0.05 and res[1]["scale"] > 0
