"""Place recognition of the port on a monocular map against the JAX
package's: the free-scale loop closure (LoopClosingConfig.fix_scale=False:
the Sim3 RANSAC with scale, optimize_sim3 with scale and the 7-DoF pose
graph), the hierarchical pose-graph skeleton that a small
max_pose_graph_kfs selects, and a monocular relocalization.

A feature-level monocular out-and-back sequence (no stereo, no depth)
runs through the JAX System with a loop closer; its map and closer cross
into the port (convert.map_from_jax, convert.loop_closer_from_jax); then
both closers verify and correct the loop between the last keyframe and
the second, the port handed the Sim3 RANSAC samples the JAX package
draws.  For the relocalization a port System takes over the JAX
System's map, closer and tracker, and both are thrown back to early
views: they go LOST and relocalize on the same frames (the PnP draws
differ; the pose is decided by the pose optimization on the harvested
matches).

Tolerances: accepted identically, equal SearchAndFuse counts; S_ck
(rotation, translation, scale) and the corrected keyframe poses within
1e-4; relocalized poses within 1e-3 m and 1e-3 rad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.backend.loop_closing import LoopCloser as JLoopCloser
from vieo_slam_tpu.backend.loop_closing import (
    LoopClosingConfig as JLoopClosingConfig,
)
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend.frame import make_frame_from_features
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu.utils.metrics import metrics as jmetrics
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend import loop_closing as tlc
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.solvers.sim3_solver import sim3_ransac_from_indices
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.utils.metrics import metrics

from test_torch_system import rot_angle

torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
OUT = 8               # frames out; the camera then retraces them
KIDNAP = (2, 3)       # early views the relocalization case jumps back to
SLAB = 1536


def mono_frame(obs, t):
    return make_frame_from_features(obs["uv"], obs["level"], obs["angle"],
                                    obs["desc"], obs["valid"], timestamp=t)


@pytest.fixture(scope="module")
def mono_map():
    """The JAX monocular System after the out-and-back, its views and the
    observations of the kidnap frames."""
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=4, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(OUT) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.8,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    jcam = jcm.make_pinhole(*CAM)
    js = JSystem(jcam, 0.0, JSystemConfig(
        tracker=JTrackerConfig(local_landmark_cap=SLAB)))
    js.loop_closer = JLoopCloser(jcam, 0.0, js.map,
                                 JLoopClosingConfig(fix_scale=False))
    rng = np.random.RandomState(21)
    views = list(range(OUT)) + list(range(OUT - 1, -1, -1))
    states = []
    for n, i in enumerate(views):
        obs = world.observe(Rcw[i], tcw[i], jcam, bf=0.0, n_kp=500,
                            pixel_noise=0.25, bit_flips=4, clutter=40,
                            rng=rng, max_depth=10.0)
        states.append(js.track_frame(mono_frame(obs, 0.1 * n)).name)
    assert states[-1] == "OK", states
    kidnap = [world.observe(Rcw[i], tcw[i], jcam, bf=0.0, n_kp=500,
                            pixel_noise=0.25, bit_flips=4, clutter=40,
                            rng=rng, max_depth=10.0) for i in KIDNAP]
    return js, len(views), kidnap


def close_both(js, max_pose_graph_kfs):
    """Convert the JAX map and closer (twice: one map for each package's
    closure) and let both close the loop from the last keyframe."""
    jmap = convert.map_from_jax(js.map)
    jlc = JLoopCloser(js.loop_closer.cam, 0.0, None, JLoopClosingConfig(
        fix_scale=False, max_pose_graph_kfs=max_pose_graph_kfs))
    for name in ("voc", "kf_bow", "db", "_pending", "last_loop_kf",
                 "loop_edges", "n_loops_closed", "total_fuse_count"):
        setattr(jlc, name, getattr(js.loop_closer, name))
    # The JAX closer works on a copy of the map too (a numpy MapState of
    # the same layout): keep the fixture's System untouched.
    jlc.map = type(js.map)(js.map.cfg)
    for name, value in jmap.__dict__.items():
        if name not in ("lock", "_covis_cache"):
            setattr(jlc.map, name, np.copy(value)
                    if isinstance(value, np.ndarray) else value)
    cam = convert.camera_from_jax(js.loop_closer.cam)
    plc = convert.loop_closer_from_jax(jlc, cam, jmap, device="cpu")
    kfs = jmap.keyframe_ids()
    # The last keyframe (back at the first view) against the second one:
    # between two keyframes at one pose the scale of S_ck would not be
    # observable, and any difference would decide it.
    k, c = int(kfs[-1]), int(kfs[1])
    seen = {}
    for name, lc in (("jax", jlc), ("port", plc)):
        def hook(k_, c_, S_ck, lc=lc, name=name,
                 orig=type(lc)._correct_loop):
            seen[name] = tuple(np.array(x, np.float64) for x in S_ck)
            orig(lc, k_, c_, S_ck)
        lc._correct_loop = hook

    def jax_draws(src, dst, valid, key, **kw):
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        idx = jax.random.categorical(jax.random.PRNGKey(k), logits,
                                     shape=(128, 3))
        return sim3_ransac_from_indices(
            src, dst, valid, torch.from_numpy(np.array(idx)).long(), **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tlc, "sim3_ransac", jax_draws)
    try:
        ok = (jlc._try_close(k, c), plc._try_close(k, c))
    finally:
        mp.undo()
    return jlc, plc, ok, seen, kfs


@pytest.mark.parametrize("max_pose_graph_kfs", [512, 4],
                         ids=["full_pose_graph", "skeleton"])
def test_free_scale_closure_matches_jax(mono_map, max_pose_graph_kfs):
    js, _, _ = mono_map
    assert js.map.n_keyframes() > max_pose_graph_kfs or \
        max_pose_graph_kfs == 512
    jlc, plc, (ok_j, ok_p), seen, kfs = close_both(js, max_pose_graph_kfs)
    assert ok_j == ok_p
    assert ok_j, "the forced closure should verify"
    assert plc.last_fuse_count == jlc.last_fuse_count > 0
    sj, sp = seen["jax"], seen["port"]
    for a, b in zip(sp, sj):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert abs(float(sj[2]) - 1.0) > 1e-6     # a scale was estimated
    jm, pm = jlc.map, plc.map
    np.testing.assert_allclose(pm.kf_Rcw[kfs], jm.kf_Rcw[kfs], atol=1e-4)
    np.testing.assert_allclose(pm.kf_tcw[kfs], jm.kf_tcw[kfs], atol=1e-4)
    np.testing.assert_array_equal(pm.lm_valid, jm.lm_valid)
    np.testing.assert_allclose(pm.lm_pw[jm.lm_valid], jm.lm_pw[jm.lm_valid],
                               rtol=1e-4, atol=1e-4)


def test_mono_relocalization_matches_jax(mono_map):
    js, n_views, kidnap = mono_map
    ps = System(convert.camera_from_jax(js.cam), 0.0, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB)), device="cpu")
    ps.map = convert.map_from_jax(js.map)
    ps.tracker.map = ps.mapper.map = ps.map
    ps.loop_closer = convert.loop_closer_from_jax(js.loop_closer, ps.cam,
                                                  ps.map, device="cpu")
    for name in ("Rcw", "tcw", "velocity", "_prev_vel_rot", "last_kf_id",
                 "frames_since_kf", "frame_id", "ref_tracked"):
        setattr(ps.tracker, name, getattr(js.tracker, name))
    ps.tracker.state = type(ps.tracker.state)[js.tracker.state.name]
    jmetrics.reset()
    metrics.reset()
    rows = []
    for n, obs in enumerate(kidnap):
        jf = mono_frame(obs, 0.1 * (n_views + n))
        tf = convert.frame_from_jax(jf, device="cpu")
        rows.append((js.track_frame(jf).name, ps.track_frame(tf).name,
                     js.tracker.Rcw.copy(), js.tracker.tcw.copy(),
                     ps.tracker.Rcw.copy(), ps.tracker.tcw.copy()))
    assert [r[:2] for r in rows] == [(a, a) for a, _ in
                                     (r[:2] for r in rows)]
    assert jmetrics.counters.get("reloc_success", 0) >= 1
    assert metrics.counters.get("reloc_success", 0) \
        == jmetrics.counters["reloc_success"]
    for sj, st, Rj, tj, Rp, tp in rows:
        if sj == "OK":
            assert np.abs(tp - tj).max() < 1e-3
            assert rot_angle(Rp, Rj) < 1e-3
