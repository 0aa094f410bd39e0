"""System facade: the public entry point of the port.

Port of vieo_slam_tpu/system.py for the three vision sensor modes
(stereo, RGB-D, monocular; the frame's depth decides how the tracker
initializes).  Tracking runs per frame.  Keyframe processing (local
mapping, loop closing, a global BA after a closed loop) runs either
inline at keyframe insertion, after which the tracker rebases its pose on
the corrected keyframe, or, with SystemConfig.async_mapping, on a worker
thread fed through a bounded queue: the worker holds map.lock for its
short host mutations, publishes each keyframe's pose change to the
correction sinks (the tracker, and a VIO front end), and runs the global
BA after a loop as a supersedable background task.  Both threads enqueue
on the card's default stream, so the device work of the two serializes
in the order the host enqueued it; they also share the GIL.  CUDA graphs
are captured on the caller's thread only (utils/cuda_graph.py).  Place
recognition is entered by attaching a `backend.loop_closing.LoopCloser`
to `System.loop_closer`.  A map saved with `save_map` (io/serialization:
the JAX package's file format) is reused by `load_map` into a fresh
System, which then relocalizes against it; `set_localization_mode` stops
keyframe processing (tracking only).
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
from typing import Optional

import torch

from .backend.local_mapping import LocalMapper, LocalMappingConfig
from .cameras import models as cm
from .frontend.frame import Frame
from .frontend.tracking import Tracker, TrackerConfig, TrackState  # noqa: F401
from .map.map_state import MapConfig, MapState
from .utils.cuda_graph import capture_lock, capture_pending, no_capture
from .utils.device import resolve_device
from .utils.metrics import metrics


class SensorMode(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclasses.dataclass
class SystemConfig:
    sensor: SensorMode = SensorMode.STEREO
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapper: LocalMappingConfig = dataclasses.field(
        default_factory=LocalMappingConfig)
    # Tracking only: keyframes the tracker creates get no local mapping,
    # loop closing or global BA.
    localization_only: bool = False
    # Keyframe processing on a worker thread while tracking goes on; the
    # worker's corrections reach the tracker at the next frame boundary.
    async_mapping: bool = False
    # Keyframes tracking may run ahead of the worker before the queue
    # blocks it (one in flight and one queued).
    kf_queue_depth: int = 2


class System:
    """Visual SLAM on one device (default: the GPU)."""

    def __init__(self, cam: cm.Camera, bf: float,
                 cfg: Optional[SystemConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or SystemConfig()
        self.cam = cam
        self.bf = float(bf)
        self.map = MapState(self.cfg.map)
        self.tracker = Tracker(cam, bf, self.map, self.cfg.tracker)
        self.mapper = LocalMapper(cam, bf, self.map, self.cfg.mapper,
                                  device=self.device)
        # A backend.loop_closing.LoopCloser over self.map, or None.
        self.loop_closer = None
        self._kf_queue = None
        self._worker = None
        self._worker_error = None
        # Map-gauge correction listeners: each gets push_correction(R_old,
        # t_old, R_new, t_new) under map.lock when the worker moves a
        # keyframe (the tracker; a VIO front end adds itself).
        self.correction_sinks = [self.tracker]
        # Set by a VIO front end in async mode: track_frame then keeps a
        # new keyframe in `deferred_kf` until the front end has stored its
        # fused state on it and calls dispatch_keyframe().
        self.defer_kf_dispatch = False
        self.deferred_kf = None
        # The background global BA (async mode) and its abort flag.
        self._gba_lock = threading.Lock()
        self._gba_thread = None
        self._gba_abort = None
        if self.cfg.async_mapping:
            self._start_worker()

    # ------------------------------------------------------------------

    def _start_worker(self):
        self._kf_queue = queue.Queue(maxsize=self.cfg.kf_queue_depth)
        self._worker = threading.Thread(
            target=self._worker_loop, name="local-mapping", daemon=True)
        self._worker.start()

    def _worker_loop(self):
        """Local mapping and loop closing of each queued keyframe, then
        its post-hook (a VIO front end's window BA); the keyframe's pose
        change goes to every correction sink."""
        while True:
            item = self._kf_queue.get()
            if item is None:
                self._kf_queue.task_done()
                return
            k, post_hook = item
            try:
                with self.map.lock:
                    R_old = self.map.kf_Rcw[k].copy()
                    t_old = self.map.kf_tcw[k].copy()
                # No CUDA-graph capture overlaps the stage, and the stage
                # captures none itself (utils/cuda_graph.py).
                with capture_lock, no_capture():
                    self._process_keyframe_stage(k)
                    if post_hook is not None:
                        post_hook(k)
                with self.map.lock:
                    R_new = self.map.kf_Rcw[k].copy()
                    t_new = self.map.kf_tcw[k].copy()
                    for sink in self.correction_sinks:
                        sink.push_correction(R_old, t_old, R_new, t_new)
            except Exception as e:       # raised by the next track call
                self._worker_error = e
            finally:
                self._kf_queue.task_done()

    def wait_idle(self):
        """Block until the worker has drained its queue and the background
        global BA has finished; raise a worker error."""
        if self._kf_queue is not None:
            self._kf_queue.join()
        with self._gba_lock:
            t = self._gba_thread
        if t is not None:
            t.join()
        self._raise_worker_error()

    def _raise_worker_error(self):
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def _process_keyframe_stage(self, new_kf: int):
        """Backend work for one keyframe: local mapping, loop closing and,
        after a closed loop, a global BA (in the background in async
        mode)."""
        with metrics.timer("local_mapping"):
            self.mapper.process_keyframe(new_kf)
        if self.loop_closer is not None:
            with metrics.timer("loop_closing"):
                closed = self.loop_closer.process_keyframe(new_kf)
            if closed:
                metrics.count("loops_closed")
                if self._kf_queue is not None:
                    self._request_gba()
                else:
                    with metrics.timer("gba"):
                        self.mapper.run_global_ba()

    def _request_gba(self):
        """Start the background global BA, superseding one in flight: the
        newer request aborts the older solve, which discards its result,
        and runs after it on the newer map."""
        with self._gba_lock:
            if self._gba_abort is not None:
                self._gba_abort.set()
            abort = threading.Event()
            t = threading.Thread(target=self._gba_worker,
                                 args=(self._gba_thread, abort), name="gba",
                                 daemon=True)
            self._gba_abort = abort
            self._gba_thread = t
            t.start()

    def _gba_worker(self, prev, abort):
        try:
            if prev is not None:
                prev.join()
            if abort.is_set():
                return
            with metrics.timer("gba"), no_capture():
                ok = self.mapper.run_global_ba(
                    abort=abort, correction_sinks=self.correction_sinks)
            if not ok:
                metrics.count("gba_aborted")
        except Exception as e:    # raised by the next track call
            self._worker_error = e

    def track_frame(self, frame: Frame) -> TrackState:
        """Track one Frame (built by frontend.frame on this device)."""
        if frame.uv.device.type != self.device.type:
            raise ValueError(f"frame is on {frame.uv.device}, the system on "
                             f"{self.device}")
        self._raise_worker_error()
        with metrics.timer("frame"):
            capture_pending()   # the background threads' new graph layouts
            with metrics.timer("track"):
                state = self.tracker.track(frame)
            if state == TrackState.LOST and self.loop_closer is not None:
                from .frontend.relocalization import try_relocalize

                with metrics.timer("relocalize"), self.map.lock:
                    if try_relocalize(self, self.loop_closer, frame):
                        state = self.tracker.state
                        metrics.count("reloc_success")
                metrics.count("reloc_attempts")
            new_kf = self.tracker.last_new_kf
            if new_kf is not None and not self.cfg.localization_only:
                metrics.count("keyframes")
                if self.defer_kf_dispatch:
                    self.deferred_kf = new_kf
                elif self._kf_queue is not None:
                    # A full queue blocks tracking (back-pressure).
                    self._kf_queue.put((new_kf, None))
                else:
                    self._process_keyframe_stage(new_kf)
                    # Local BA may have moved the new KF: rebase the
                    # tracker.
                    self.tracker.rebase_to_keyframe(new_kf)
        metrics.set_gauge("map_keyframes", int(self.map.n_keyframes()))
        metrics.set_gauge("map_landmarks", int(self.map.n_landmarks()))
        metrics.count(f"state_{state.name}")
        return state

    def dispatch_keyframe(self, post_hook=None):
        """Send the deferred keyframe to the backend (the worker in async
        mode, inline otherwise); `post_hook(k)` runs after its local
        mapping and loop closing, in the same stage."""
        k, self.deferred_kf = self.deferred_kf, None
        if k is None:
            return
        if self._kf_queue is not None:
            self._kf_queue.put((k, post_hook))
        else:
            self._process_keyframe_stage(k)
            if post_hook is not None:
                post_hook(k)
            self.tracker.rebase_to_keyframe(k)

    def trajectory(self, optimized: bool = True):
        """Per-frame camera trajectory [(t, Rcw, tcw, state)]; optimized
        poses compose each frame's pose relative to its reference keyframe
        with that keyframe's current pose."""
        if not optimized or not self.tracker.trajectory_rel:
            return self.tracker.trajectory
        out = []
        m = self.map
        for t, ref, R_cr, t_cr, state in self.tracker.trajectory_rel:
            if ref < 0:
                out.append((t, R_cr, t_cr, state))
                continue
            R_ref, t_ref = m.kf_Rcw[ref], m.kf_tcw[ref]
            out.append((t, R_cr @ R_ref, R_cr @ t_ref + t_cr, state))
        return out

    def trajectory_tum(self, optimized: bool = True) -> str:
        """TUM format: t x y z qx qy qz qw of Twc."""
        from .io.serialization import tum_line
        return "".join(tum_line(t, Rcw, tcw) + "\n"
                       for t, Rcw, tcw, _ in self.trajectory(optimized))

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as f:
            f.write(self.trajectory_tum())

    def save_map(self, path: str):
        """Persist the sparse map (after the worker has drained)."""
        from .io.serialization import save_map
        self.wait_idle()
        save_map(self.map, path)

    def load_map(self, path: str):
        """Replace the map with a saved one (map reuse): the loop closer's
        database is rebuilt from the loaded keyframes, and the tracker is
        LOST until the next frames relocalize against the map."""
        from .io.serialization import load_map
        self.wait_idle()
        self.map = load_map(path)
        self.tracker.map = self.map
        self.mapper.map = self.map
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
            self.loop_closer.rebuild_database()
        self.tracker.state = TrackState.LOST
        self.tracker.velocity = None
        self.tracker.last_kf_id = int(self.map.keyframe_ids()[-1]) \
            if self.map.n_keyframes() else -1

    def set_localization_mode(self, on: bool):
        """Tracking only when on: no keyframe processing."""
        self.cfg.localization_only = bool(on)

    def reset(self):
        """A fresh map and tracker (the correction sinks follow it); an
        attached loop closer keeps its vocabulary and drops its
        database."""
        self.wait_idle()
        self.deferred_kf = None
        self.map = MapState(self.cfg.map)
        old_tracker = self.tracker
        self.tracker = Tracker(self.cam, self.bf, self.map, self.cfg.tracker)
        self.correction_sinks = [self.tracker if s is old_tracker else s
                                 for s in self.correction_sinks]
        self.mapper = LocalMapper(self.cam, self.bf, self.map,
                                  self.cfg.mapper, device=self.device,
                                  ba_mesh=self.mapper.ba_mesh)
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
            self.loop_closer.db = None

    def final_global_ba(self):
        """One full-map BA at shutdown."""
        self.wait_idle()
        with metrics.timer("final_gba"):
            self.mapper.run_global_ba(stage_iters=(10, 15))

    def shutdown(self, print_report: bool = False):
        """Drain and join the worker, then wait for the device work
        enqueued so far; optionally print the per-stage timing report
        (the stereo_euroc.cc exit report)."""
        self.wait_idle()
        if self._worker is not None:
            self._kf_queue.put(None)
            self._worker.join(timeout=30.0)
            self._worker = None
            self._kf_queue = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if print_report:
            print(metrics.format_report())

    def metrics_report(self) -> dict:
        """Per-stage timing stats + event counters."""
        return metrics.report()
