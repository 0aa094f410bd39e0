"""The port's async mapping pipeline: the worker thread, its correction
sinks, the supersedable background GBA, the System's reset and shutdown
around them, and a VIO front end over an async System (keyframe dispatch
deferred to the front end, the PRV window BA as the worker's post-hook).

The parity case runs both packages in lockstep async mode (the worker's
queue joined after every frame, as tests/test_async_pipeline.py does) on
the same features, from the JAX package's world.observe into each
package's make_frame_from_features: per-frame poses within 1e-3 m and
1e-3 rad, identical track states and keyframe counts.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.utils.metrics import metrics

from test_torch_system import rot_angle

torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2


def features(n_frames, seed=11, n_kp=400):
    """Per-frame observe() dicts of the JAX package's feature-level world
    along an outward circle, with their timestamps and the true
    positions."""
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=3000, seed=3, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(n_frames) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    cam = jcm.make_pinhole(*CAM)
    rng = np.random.RandomState(seed)
    obs = [world.observe(Rcw[i], tcw[i], cam, bf=BF, n_kp=n_kp,
                         pixel_noise=0.25, bit_flips=4, clutter=30, rng=rng,
                         max_depth=10.0) for i in range(n_frames)]
    return obs, ts, twc


def frames_of(obs, ts, maker, **kw):
    return [maker(o["uv"], o["level"], o["angle"], o["desc"], o["valid"],
                  ur=o["ur"], depth=o["depth"], timestamp=float(t), **kw)
            for o, t in zip(obs, ts)]


def run_lockstep(system, frames):
    states = []
    for f in frames:
        states.append(system.track_frame(f).name)
        system._kf_queue.join()
    system.wait_idle()
    return states


@pytest.fixture(scope="module")
def lockstep_runs():
    obs, ts, _ = features(14)
    js = JSystem(jcm.make_pinhole(*CAM), BF,
                 JSystemConfig(async_mapping=True))
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(async_mapping=True),
                device="cpu")
    sj = run_lockstep(js, frames_of(obs, ts, jframe.make_frame_from_features))
    st = run_lockstep(ps, frames_of(obs, ts, tframe.make_frame_from_features,
                                    device="cpu"))
    yield js, ps, sj, st
    js.shutdown()
    ps.shutdown()


def test_lockstep_async_matches_jax(lockstep_runs):
    js, ps, sj, st = lockstep_runs
    assert sj == st and set(st) == {"OK"}
    assert js.map.n_keyframes() == ps.map.n_keyframes() >= 4
    # The worker ran local BA on every keyframe.
    assert ps.map.version > ps.map.n_keyframes()
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 1e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 1e-3, i
    kfs = ps.map.keyframe_ids()
    np.testing.assert_array_equal(kfs, js.map.keyframe_ids())
    assert np.abs(ps.map.kf_tcw[kfs] - js.map.kf_tcw[kfs]).max() < 1e-3


def test_worker_error_surfaces_on_wait_idle():
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(async_mapping=True),
                device="cpu")

    def boom(k):
        raise RuntimeError("worker exploded")

    ps.mapper.process_keyframe = boom
    ps._kf_queue.put((0, None))
    with pytest.raises(RuntimeError, match="worker exploded"):
        ps.wait_idle()
    ps.wait_idle()              # raised once, then cleared
    ps.shutdown()


class Sink:
    def __init__(self):
        self.calls = []

    def push_correction(self, R_old, t_old, R_new, t_new):
        self.calls.append((R_old, t_old, R_new, t_new))


@pytest.fixture(scope="module")
def small_async_map():
    obs, ts, twc = features(12, seed=2)
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(async_mapping=True),
                device="cpu")
    for f in frames_of(obs, ts, tframe.make_frame_from_features,
                       device="cpu"):
        ps.track_frame(f)
    ps.wait_idle()
    yield ps
    ps.shutdown()


def test_aborted_gba_leaves_map_untouched(small_async_map):
    ps = small_async_map
    m = ps.map
    before = (m.kf_Rcw.copy(), m.kf_tcw.copy(), m.lm_pw.copy(), m.version)
    ev = threading.Event()
    ev.set()
    assert ps.mapper.run_global_ba(abort=ev) is False
    np.testing.assert_array_equal(m.kf_Rcw, before[0])
    np.testing.assert_array_equal(m.kf_tcw, before[1])
    np.testing.assert_array_equal(m.lm_pw, before[2])
    assert m.version == before[3]


def test_superseded_gba_writes_nothing_and_the_last_notifies(
        small_async_map):
    """Two background GBA requests in a row: the first is aborted by the
    second and writes nothing back; the second runs on the newer map,
    writes its result and notifies every correction sink."""
    ps = small_async_map
    m = ps.map
    sink = Sink()
    ps.correction_sinks.append(sink)
    results = []
    orig = ps.mapper.run_global_ba

    def recorded(**kw):
        ok = orig(**kw)
        results.append(ok)
        return ok

    ps.mapper.run_global_ba = recorded
    aborted0 = metrics.counters.get("gba_aborted", 0)
    big0 = m.big_change_idx
    try:
        # Hold the map so that the first solve cannot start before the
        # second request supersedes it.
        with m.lock:
            ps._request_gba()
            first = ps._gba_thread
            ps._request_gba()
        ps.wait_idle()
    finally:
        ps.mapper.run_global_ba = orig
        ps.correction_sinks.remove(sink)
    assert not first.is_alive()
    assert results == [False, True]
    assert metrics.counters.get("gba_aborted", 0) == aborted0 + 1
    assert m.big_change_idx == big0 + 1
    assert len(sink.calls) == 1
    last = int(m.keyframe_ids()[-1])
    np.testing.assert_array_equal(sink.calls[0][2], m.kf_Rcw[last])
    assert ps.tracker.pending_correction is not None


def test_reset_repoints_sinks_and_shutdown_joins_worker():
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(async_mapping=True),
                device="cpu")
    extra = Sink()
    ps.correction_sinks.append(extra)
    old_tracker, worker = ps.tracker, ps._worker
    ps.deferred_kf = 3
    ps.reset()
    assert ps.tracker is not old_tracker
    assert ps.correction_sinks == [ps.tracker, extra]
    assert ps.deferred_kf is None
    assert worker.is_alive()
    ps.shutdown()
    assert not worker.is_alive()
    assert ps._worker is None and ps._kf_queue is None


def test_free_running_under_fast_thread_switching():
    """Tracking and the worker share the map under map.lock: a
    free-running run with a 10 us switch interval loses no frame, raises
    no worker error, and leaves every keyframe's landmark references
    pointing at valid landmarks."""
    obs, ts, _ = features(10, seed=4)
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(async_mapping=True),
                device="cpu")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        states = [ps.track_frame(f).name for f in frames_of(
            obs, ts, tframe.make_frame_from_features, device="cpu")]
        ps.wait_idle()
    finally:
        sys.setswitchinterval(before)
        ps.shutdown()
    assert states == ["OK"] * len(ts)
    m = ps.map
    assert m.version > m.n_keyframes() >= 3
    for k in m.keyframe_ids():
        ids = m.kf_lm_idx[k][m.kf_lm_idx[k] >= 0]
        assert m.lm_valid[ids].all(), k


def test_vio_over_async_mapping():
    """The VIO front end over an async System, in lockstep: it takes over
    keyframe dispatch, the PRV window BA runs on the worker as the
    post-hook once the init is final, the worker's corrections reach the
    front end, and the run stays on the truth."""
    from vieo_slam_tpu_torch.io.evaluate import ate
    from vieo_slam_tpu_torch.vio import backend as tbackend
    from vieo_slam_tpu_torch.vio.frontend import VioConfig, VioFrontend

    from test_torch_vio_system import SLAB, VIO_CFG, drive, scenario

    ts, (_, twc, _, _), imu, obs = scenario(36)
    ps = System(tcm.make_pinhole(*CAM), BF, SystemConfig(
        tracker=TrackerConfig(local_landmark_cap=SLAB), async_mapping=True),
        device="cpu")
    vio = VioFrontend(ps, cfg=VioConfig(**VIO_CFG))
    assert ps.defer_kf_dispatch and ps.correction_sinks == [ps.tracker, vio]
    threads, pushed = [], []
    run_local_ba = tbackend.VioBackend.run_local_ba

    def on_worker(self, k):
        threads.append(threading.current_thread().name)
        return run_local_ba(self, k)

    push = vio.push_correction
    vio.push_correction = lambda *a: (pushed.append(a), push(*a))
    mp = pytest.MonkeyPatch()
    mp.setattr(tbackend.VioBackend, "run_local_ba", on_worker)
    try:
        states, _ = drive(vio, tframe.make_frame_from_features, ts, imu,
                          obs, after=ps._kf_queue.join, device="cpu")
        ps.wait_idle()
    finally:
        mp.undo()
        ps.shutdown()
    assert "LOST" not in states
    assert vio.final_inited and threads
    assert set(threads) == {"local-mapping"}
    assert pushed
    traj = ps.tracker.trajectory
    p_est = np.asarray([-(x[1].T @ x[2]) for x in traj])
    assert ate(np.asarray([x[0] for x in traj]), p_est, ts,
               twc)["rmse"] < 0.02
