"""Relocalization of the port's System against the JAX package's on a
feature-level stereo sequence: both Systems, each with a loop closer,
track the same frames (the JAX world's `observe`, converted with
convert.frame_from_jax), then the camera is kidnapped back to an early
view.

Both must go LOST on the same frame and relocalize on the same frame; the
recovered poses agree within 1e-3 m and 1e-3 rad, and the tracker's
`just_relocalized` is set.  Each candidate's PnP RANSAC draws the JAX
package's hypotheses (the key of the frame's timestamp, `utils.prng`), so
the two packages make the same RANSAC calls with identical inlier sets and
counts, their poses within 1e-4.  The frames tracked after the recovery
(the first of them without a motion model, as in the JAX package) agree to
the same tolerance as the recovered pose.
"""

import numpy as np
import pytest
import torch

from vieo_slam_tpu.backend.loop_closing import LoopCloser as JLoopCloser
from vieo_slam_tpu.backend.loop_closing import (
    LoopClosingConfig as JLoopClosingConfig,
)
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import relocalization as jreloc
from vieo_slam_tpu.frontend.frame import make_frame_from_features
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu.utils.metrics import metrics as jmetrics
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend.loop_closing import LoopCloser
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import relocalization as treloc
from vieo_slam_tpu_torch.frontend.relocalization import try_relocalize
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.utils.metrics import metrics

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2
N_TRACK = 10          # frames tracked before the kidnap
KIDNAP = (2, 3, 4)    # the early views the camera is thrown back to
SLAB = 1536           # the tracker's local landmark slab (both systems)


def rot_angle(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def recording(calls, name, fn):
    """fn, with each call's (solver, inliers, count, ok, R, t) kept."""
    def spy(*args, **kw):
        res = fn(*args, **kw)
        calls.append((name, np.asarray(res.inliers), int(res.n_inliers),
                      bool(res.ok), np.asarray(res.Rcw), np.asarray(res.tcw)))
        return res
    return spy


@pytest.fixture(scope="module")
def kidnap_runs():
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=6, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(N_TRACK) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.8,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    jcam = jcm.make_pinhole(*CAM)
    js = JSystem(jcam, BF, JSystemConfig(
        tracker=JTrackerConfig(local_landmark_cap=SLAB)))
    js.loop_closer = JLoopCloser(jcam, BF, js.map, JLoopClosingConfig())
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    ps.loop_closer = LoopCloser(ps.cam, BF, ps.map, device="cpu")
    rng = np.random.RandomState(31)
    jmetrics.reset()
    metrics.reset()
    views = list(range(N_TRACK)) + list(KIDNAP)
    rows = []
    calls = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    for side, mod in (("jax", jreloc), ("port", treloc)):
        for name in ("pnp_ransac", "pnp_ransac_3d3d"):
            mp.setattr(mod, name, recording(calls[side], name,
                                            getattr(mod, name)))
    for n, i in enumerate(views):
        obs = world.observe(Rcw[i], tcw[i], jcam, bf=BF, n_kp=500,
                            pixel_noise=0.25, bit_flips=4, clutter=40,
                            rng=rng, max_depth=10.0)
        jf = make_frame_from_features(
            obs["uv"], obs["level"], obs["angle"], obs["desc"], obs["valid"],
            ur=obs["ur"], depth=obs["depth"], timestamp=0.1 * n)
        tf = convert.frame_from_jax(jf, device="cpu")
        rows.append((i, js.track_frame(jf), ps.track_frame(tf),
                     js.tracker.Rcw.copy(), js.tracker.tcw.copy(),
                     ps.tracker.Rcw.copy(), ps.tracker.tcw.copy(),
                     ps.tracker.just_relocalized, tf))
    mp.undo()
    return js, ps, rows, (Rcw, tcw), calls


def test_same_states_and_recovery_frame(kidnap_runs):
    js, ps, rows, _, _ = kidnap_runs
    states = [(r[1].name, r[2].name) for r in rows]
    for i, (sj, st) in enumerate(states):
        assert sj == st, (i, states)
    assert all(s == "OK" for s, _ in states[:N_TRACK]), states
    assert ps.loop_closer.db is not None
    np.testing.assert_array_equal(ps.loop_closer.db.present,
                                  js.loop_closer.db.present)
    # the kidnap: the tracker goes LOST and relocalization brings it back
    assert jmetrics.counters["reloc_success"] >= 1
    assert metrics.counters["reloc_success"] \
        == jmetrics.counters["reloc_success"]
    assert metrics.counters["reloc_attempts"] \
        == jmetrics.counters["reloc_attempts"]
    assert states[-1] == ("OK", "OK")


def test_recovered_pose(kidnap_runs):
    js, ps, rows, (Rcw, tcw), _ = kidnap_runs
    recovered = [r for r in rows[N_TRACK:] if r[2].name == "OK"]
    assert recovered
    i, _, _, Rj, tj, Rp, tp, flag, _ = recovered[0]
    assert flag
    assert np.abs(tp - tj).max() < 1e-3
    assert rot_angle(Rp, Rj) < 1e-3
    # and near the truth in the map frame (KF 0 at the identity)
    Rg = Rcw[i] @ Rcw[0].T
    tg = tcw[i] - Rg @ tcw[0]
    assert np.linalg.norm(tp - tg) < 0.05
    assert rot_angle(Rp, Rg) < 0.02


def test_same_ransac_inlier_sets(kidnap_runs):
    """Every candidate's PnP RANSAC sees the same hypotheses in both
    packages: the same calls, the same inlier sets and counts."""
    *_, calls = kidnap_runs
    assert calls["jax"]
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]]
    for (_, inl_p, n_p, ok_p, R_p, t_p), (_, inl_j, n_j, ok_j, R_j, t_j) \
            in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(inl_p, inl_j)
        assert (n_p, ok_p) == (n_j, ok_j)
        np.testing.assert_allclose(R_p, R_j, atol=1e-4)
        np.testing.assert_allclose(t_p, t_j, atol=1e-4)


def test_relocalize_needs_keypoints(kidnap_runs):
    """An all-invalid frame (a blacked-out image) returns early."""
    _, ps, rows, _, _ = kidnap_runs
    tf = rows[-1][-1]
    dark = tf._replace(valid=torch.zeros_like(tf.valid))
    assert not try_relocalize(ps, ps.loop_closer, dark)


def test_frames_after_recovery(kidnap_runs):
    """The frames tracked after the recovery land where the JAX package's
    do, and near the truth."""
    js, ps, rows, (Rcw, tcw), _ = kidnap_runs
    at = next(n for n in range(N_TRACK, len(rows))
              if rows[n][2].name == "OK")
    after = rows[at + 1:]
    assert after
    for i, sj, st, Rj, tj, Rp, tp, _, _ in after:
        assert (sj.name, st.name) == ("OK", "OK")
        assert np.abs(tp - tj).max() < 1e-3
        assert rot_angle(Rp, Rj) < 1e-3
        Rg = Rcw[i] @ Rcw[0].T
        tg = tcw[i] - Rg @ tcw[0]
        assert np.linalg.norm(tp - tg) < 0.05
        assert rot_angle(Rp, Rg) < 0.02
