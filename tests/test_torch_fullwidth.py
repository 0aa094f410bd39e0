"""The port's stereo System against the JAX package's at full width: the
first frames of chip_smoke.py phase 5's scene (752x480, 1200 features on
8 levels, a 4096-landmark local slab) through both Systems on the CPU, the
port's configuration converted from the JAX one
(convert.system_config_from_jax).  Octaves 4-7 of the pyramid appear only
at this size; tests/test_torch_system.py runs 320x240 with 4 levels.

Tolerances: equal keypoint counts on every level of every frame, identical
track states and keyframe counts, per-frame poses within 1e-3 m and 1e-3
rad.  The images carry faint sensor noise, as in test_torch_system.py, so
that flat background holds no exact descriptor ties for the pyramid's f32
ulps to flip.
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
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.system import System

# One intra-op thread: the suite runs several worker processes at once.
torch.set_num_threads(1)

WIDTH, N_FEATURES, N_LEVELS = 752, 1200, 8
BASELINE = 0.2
FX = 400.0 * WIDTH / 640.0
CAM = (FX, FX, WIDTH / 2.0, 240.0, WIDTH, 480)
BF = FX * BASELINE
N_FRAMES = 4


def rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def level_counts(levels, valid):
    return np.bincount(np.asarray(levels)[np.asarray(valid)],
                       minlength=N_LEVELS)


@pytest.fixture(scope="module")
def two_runs(request):
    """Both Systems over the same noisy rendered stereo frames of phase 5's
    world and circle (chip_smoke.scene)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jorb, "_use_fused_tail", lambda: True)
    mp.setattr(jorb, "_use_gather_kernel", lambda *_: False)
    mp.setattr(jorb, "_use_mxu_gather", lambda: False)
    request.addfinalizer(mp.undo)

    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=1800, seed=3, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(N_FRAMES) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    jcam = jcm.make_pinhole(*CAM)
    cfg_j = jorb.OrbConfig(n_features=N_FEATURES, n_levels=N_LEVELS)
    cfg_t = torb.OrbConfig(n_features=N_FEATURES, n_levels=N_LEVELS)
    build = jax.jit(lambda l, r, t: jframe.build_stereo_frame(
        l, r, cfg_j, bf=BF, min_depth=0.3, max_depth=15.0, timestamp=t))
    jcfg = JSystemConfig(tracker=JTrackerConfig(use_predicted_scale=True,
                                                local_landmark_cap=4096))
    js = JSystem(jcam, BF, jcfg)
    ps = System(convert.camera_from_jax(jcam), BF,
                convert.system_config_from_jax(jcfg), device="cpu")
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
        rows.append(dict(
            states=(js.track_frame(jf).name, ps.track_frame(tf).name),
            kfs=(js.map.n_keyframes(), ps.map.n_keyframes()),
            levels=(level_counts(jf.level, jf.valid),
                    level_counts(tf.level.numpy(), tf.valid.numpy()))))
    return js, ps, rows


def test_keypoints_per_level(two_runs):
    _, _, rows = two_runs
    for i, row in enumerate(rows):
        lj, lt = row["levels"]
        np.testing.assert_array_equal(lt, lj, err_msg=f"frame {i}")
    # the upper octaves are populated at this size
    assert all(row["levels"][0][4:].sum() > 0 for row in rows)


def test_states_keyframes_poses(two_runs):
    js, ps, rows = two_runs
    for i, row in enumerate(rows):
        assert row["states"] == ("OK", "OK"), (i, row["states"])
        assert row["kfs"][0] == row["kfs"][1], (i, row["kfs"])
    assert rows[-1]["kfs"][0] >= 2
    assert len(js.tracker.trajectory) == len(ps.tracker.trajectory) \
        == N_FRAMES
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert a[3] == b[3]
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3, i
