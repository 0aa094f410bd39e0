"""The port's loop closer and global BA against the JAX package's, from
one state: a feature-level stereo out-and-back sequence runs through the
JAX System with a loop closer; its map and closer cross into the port
(convert.map_from_jax, convert.loop_closer_from_jax); then both closers
are made to verify and correct the loop between the last keyframe and
the first (`_try_close`), the port handed the Sim3 RANSAC samples the JAX
package draws.  Then both run a global BA from one state, the JAX map
after its closure (converted for the port): the two closures leave maps
1e-4 apart, which 20 f32 BA iterations in the map's flat directions
would carry into the comparison of the BA itself.

Global BA's asynchronous hooks are held against the JAX package's too: an
abort event set before the solve or between its chunks discards the
result, and the write-back re-anchors a keyframe created while the solve
ran and hands each correction sink the newest keyframe's old and new
pose.

Checks: accepted or not identically; S_ck and the corrected keyframe
poses within 1e-4; equal SearchAndFuse counts; landmark ids and positions
within 1e-4 after the correction; GBA poses and the landmarks with a
stereo observation within the local-BA tolerances of
tests/test_torch_solvers.py (1e-4), mono-only landmarks in pixels.
"""

import copy

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
from vieo_slam_tpu.map.map_state import MapState as JMapState
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend import loop_closing as tlc
from vieo_slam_tpu_torch.backend.local_mapping import LocalMapper
from vieo_slam_tpu_torch.solvers.sim3_solver import sim3_ransac_from_indices

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2
OUT = 6               # frames out; the camera then retraces them


@pytest.fixture(scope="module")
def closed():
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=4, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(OUT) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.8,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    jcam = jcm.make_pinhole(*CAM)
    js = JSystem(jcam, BF, JSystemConfig(
        tracker=JTrackerConfig(local_landmark_cap=1536)))
    js.loop_closer = JLoopCloser(jcam, BF, js.map, JLoopClosingConfig())
    rng = np.random.RandomState(21)
    views = list(range(OUT)) + list(range(OUT - 1, -1, -1))
    for n, i in enumerate(views):
        obs = world.observe(Rcw[i], tcw[i], jcam, bf=BF, n_kp=500,
                            pixel_noise=0.25, bit_flips=4, clutter=40,
                            rng=rng, max_depth=10.0)
        js.track_frame(make_frame_from_features(
            obs["uv"], obs["level"], obs["angle"], obs["desc"], obs["valid"],
            ur=obs["ur"], depth=obs["depth"], timestamp=0.1 * n))
    jlc = js.loop_closer
    assert jlc.voc is not None and jlc.n_loops_closed == 0

    cam = convert.camera_from_jax(jcam)
    pmap = convert.map_from_jax(js.map)
    plc = convert.loop_closer_from_jax(jlc, cam, pmap, device="cpu")
    kfs = js.map.keyframe_ids()
    k, c = int(kfs[-1]), int(kfs[0])

    # record the S_ck each closer corrects with
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
    ok_j = jlc._try_close(k, c)
    ok_p = plc._try_close(k, c)
    mp.undo()
    after = (js.map.kf_Rcw.copy(), js.map.kf_tcw.copy(),
             pmap.kf_Rcw.copy(), pmap.kf_tcw.copy(),
             js.map.lm_valid.copy(), pmap.lm_valid.copy(),
             js.map.lm_pw.copy(), pmap.lm_pw.copy())
    # GBA from one state: the JAX map after its closure, converted
    gmap = convert.map_from_jax(js.map)
    gba_j = js.mapper.run_global_ba()
    gba_p = LocalMapper(cam, BF, gmap, device="cpu").run_global_ba()
    return dict(js=js, jlc=jlc, pmap=pmap, gmap=gmap, plc=plc,
                ok=(ok_j, ok_p),
                seen=seen, after=after, gba=(gba_j, gba_p), kfs=kfs)


def test_closure_accepted_identically(closed):
    ok_j, ok_p = closed["ok"]
    assert ok_j == ok_p
    assert ok_j, "the forced closure should verify"
    assert closed["plc"].n_loops_closed == closed["jlc"].n_loops_closed == 1
    assert closed["plc"].last_fuse_count == closed["jlc"].last_fuse_count
    assert closed["jlc"].last_fuse_count > 0


def test_sim3_and_corrected_poses(closed):
    sj, sp = closed["seen"]["jax"], closed["seen"]["port"]
    for a, b in zip(sp, sj):
        np.testing.assert_allclose(a, b, atol=1e-4)
    Rj, tj, Rp, tp, vj, vp, pj, pp = closed["after"]
    kfs = closed["kfs"]
    np.testing.assert_allclose(Rp[kfs], Rj[kfs], atol=1e-4)
    np.testing.assert_allclose(tp[kfs], tj[kfs], atol=1e-4)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(pp[vj], pj[vj], rtol=1e-4, atol=1e-4)
    (a, b, R_, t_), = closed["plc"].loop_edges
    (a2, b2, R2, t2), = closed["jlc"].loop_edges
    assert (a, b) == (a2, b2)
    np.testing.assert_allclose(R_, np.asarray(R2), atol=1e-4)


def test_global_ba(closed):
    assert closed["gba"] == (True, True)
    jm, pm = closed["js"].map, closed["gmap"]
    kfs = closed["kfs"]
    np.testing.assert_allclose(pm.kf_Rcw[kfs], jm.kf_Rcw[kfs], atol=1e-4)
    np.testing.assert_allclose(pm.kf_tcw[kfs], jm.kf_tcw[kfs], atol=1e-4)
    np.testing.assert_array_equal(pm.lm_valid, jm.lm_valid)
    ids = np.nonzero(jm.lm_valid)[0]
    obs_kf, obs_kp = jm.landmark_observations(ids)
    has = obs_kf >= 0
    kc, ic = np.clip(obs_kf, 0, None), np.clip(obs_kp, 0, None)
    stereo = (has & (jm.kf_ur[kc, ic] >= 0)).any(1)
    assert stereo.sum() > 0.8 * len(ids)
    np.testing.assert_allclose(pm.lm_pw[ids[stereo]], jm.lm_pw[ids[stereo]],
                               rtol=1e-4, atol=1e-4)
    # A landmark seen only by mono observations from nearby keyframes has
    # no well-determined depth in f32; it is compared where it is
    # determined, in its observations' pixels: 0.1 px is the 1e-4 m pose
    # tolerance seen from 0.4 m at fx = 400.
    mono = ids[~stereo]

    def pixels(m):
        pc = np.einsum("moij,mj->moi", m.kf_Rcw[kc[~stereo]], m.lm_pw[mono]) \
            + m.kf_tcw[kc[~stereo]]
        return CAM[0] * pc[..., :2] / pc[..., 2:]

    h = has[~stereo]
    np.testing.assert_allclose(pixels(pm)[h], pixels(jm)[h], atol=0.1)
    assert pm.big_change_idx == jm.big_change_idx >= 2


def clone_jax_map(jm):
    """An independent copy of a JAX package map, with its own lock."""
    m = JMapState(jm.cfg)
    for name, value in jm.__dict__.items():
        if name not in ("lock", "_covis_cache"):
            setattr(m, name, copy.deepcopy(value))
    return m


class AbortAfter:
    """A stand-in for threading.Event that reads as set from its n-th
    is_set() on (n = 0: set from the start)."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


class Sink:
    def __init__(self):
        self.pushed = []

    def push_correction(self, *poses):
        self.pushed.append(tuple(np.array(p) for p in poses))


@pytest.mark.parametrize("after", [0, 1], ids=["before_the_solve",
                                               "between_chunks"])
def test_global_ba_abort(closed, after):
    """An aborted GBA returns False and writes no pose or point back, in
    the port as in the JAX package (the moving-landmark cull before the
    solve stands in both)."""
    js = closed["js"]
    jm = clone_jax_map(js.map)
    pm = convert.map_from_jax(js.map)
    before = (pm.kf_Rcw.copy(), pm.kf_tcw.copy(), pm.lm_pw.copy())
    ja, pa = AbortAfter(after), AbortAfter(after)
    ok_j = type(js.mapper)(js.mapper.cam, BF, jm).run_global_ba(abort=ja)
    ok_p = LocalMapper(closed["plc"].cam, BF, pm, device="cpu") \
        .run_global_ba(abort=pa)
    assert (ok_j, ok_p) == (False, False)
    assert ja.calls == pa.calls == after + 1
    np.testing.assert_array_equal(pm.lm_valid, jm.lm_valid)
    np.testing.assert_array_equal(pm.kf_Rcw, before[0])
    np.testing.assert_array_equal(pm.kf_tcw, before[1])
    np.testing.assert_array_equal(pm.lm_pw[pm.lm_valid],
                                  before[2][pm.lm_valid])


def test_gba_write_back_reanchors_and_notifies(closed):
    """The write-back of a solve that did not see the newest keyframe (as
    when it was created during the solve): the solved keyframes and
    landmarks take the result, the newest keyframe and the landmarks
    outside the solved set follow their anchors, and every sink gets the
    newest keyframe's old and new pose -- equal to the JAX package's."""
    js = closed["js"]
    jm = clone_jax_map(js.map)
    pm = convert.map_from_jax(js.map)
    kfs = pm.keyframe_ids()
    solved, newest = kfs[:-1], int(kfs[-1])
    lm_ids = pm.landmarks_in_keyframes(solved[:1])
    lm_ids = lm_ids[pm.lm_valid[lm_ids]]
    kf_order = np.concatenate([solved[1:], solved[:1]])
    # The result: the map moved by a small rigid motion of the world.
    c, s_ = np.cos(0.02), np.sin(0.02)
    Rd = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    td = np.array([0.01, -0.02, 0.005], np.float32)
    Rcw = (pm.kf_Rcw[kf_order] @ Rd.T).astype(np.float32)
    tcw = (pm.kf_tcw[kf_order]
           - np.einsum("kij,j->ki", Rcw, td)).astype(np.float32)
    pw = (pm.lm_pw[lm_ids] @ Rd.T + td).astype(np.float32)
    new_before = pm.kf_Rcw[newest].copy(), pm.kf_tcw[newest].copy()
    sj, sp = Sink(), Sink()
    args = (kf_order, lm_ids, Rcw, tcw, pw)
    kw = dict(n_free=len(solved) - 1, snap_next_kf=newest)
    ok_j = type(js.mapper)(js.mapper.cam, BF, jm)._apply_gba_result(
        *args, correction_sinks=[sj], **kw)
    ok_p = LocalMapper(closed["plc"].cam, BF, pm, device="cpu") \
        ._apply_gba_result(*args, correction_sinks=[sp], **kw)
    assert ok_j and ok_p
    # the newest keyframe was re-anchored: it moved with the world
    np.testing.assert_allclose(pm.kf_Rcw[newest], new_before[0] @ Rd.T,
                               atol=1e-5)
    np.testing.assert_allclose(
        pm.kf_tcw[newest], new_before[1] - pm.kf_Rcw[newest] @ td,
        atol=1e-5)
    np.testing.assert_allclose(pm.kf_Rcw[kfs], jm.kf_Rcw[kfs], atol=1e-6)
    np.testing.assert_allclose(pm.kf_tcw[kfs], jm.kf_tcw[kfs], atol=1e-6)
    np.testing.assert_array_equal(pm.lm_valid, jm.lm_valid)
    np.testing.assert_allclose(pm.lm_pw[pm.lm_valid], jm.lm_pw[jm.lm_valid],
                               atol=1e-5)
    assert len(sp.pushed) == len(sj.pushed) == 1
    for a, b in zip(sp.pushed[0], sj.pushed[0]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(sp.pushed[0][0], new_before[0], atol=0)
    np.testing.assert_allclose(sp.pushed[0][2], pm.kf_Rcw[newest], atol=0)
    assert pm.big_change_idx == jm.big_change_idx
