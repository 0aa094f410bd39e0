"""System facade: the public entry point of the port.

Port of the synchronous part of vieo_slam_tpu/system.py for the three
vision sensor modes (stereo, RGB-D, monocular; the frame's depth decides
how the tracker initializes): tracking runs per frame; local mapping runs
at keyframe insertion, inline; the tracker then rebases its pose on the
corrected keyframe.  Place recognition is entered by attaching a
`backend.loop_closing.LoopCloser` to `System.loop_closer`: a LOST frame is
then relocalized against its keyframe database, every new keyframe is
checked for a loop, and a closed loop is followed by a global BA, inline.
The async mapping worker and map save/load come with their slices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from .backend.local_mapping import LocalMapper, LocalMappingConfig
from .cameras import models as cm
from .frontend.frame import Frame
from .frontend.tracking import Tracker, TrackerConfig, TrackState  # noqa: F401
from .map.map_state import MapConfig, MapState
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


class System:
    """Synchronous visual SLAM on one device (default: the GPU)."""

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

    def _process_keyframe_stage(self, new_kf: int):
        """Backend work for one keyframe: local mapping, loop closing and,
        after a closed loop, a global BA."""
        with metrics.timer("local_mapping"):
            self.mapper.process_keyframe(new_kf)
        if self.loop_closer is not None:
            with metrics.timer("loop_closing"):
                closed = self.loop_closer.process_keyframe(new_kf)
            if closed:
                metrics.count("loops_closed")
                with metrics.timer("gba"):
                    self.mapper.run_global_ba()

    def track_frame(self, frame: Frame) -> TrackState:
        """Track one Frame (built by frontend.frame on this device)."""
        if frame.uv.device.type != self.device.type:
            raise ValueError(f"frame is on {frame.uv.device}, the system on "
                             f"{self.device}")
        with metrics.timer("frame"):
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
            if new_kf is not None:
                metrics.count("keyframes")
                self._process_keyframe_stage(new_kf)
                # Local BA may have moved the new KF: rebase the tracker.
                self.tracker.rebase_to_keyframe(new_kf)
        metrics.set_gauge("map_keyframes", int(self.map.n_keyframes()))
        metrics.set_gauge("map_landmarks", int(self.map.n_landmarks()))
        metrics.count(f"state_{state.name}")
        return state

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
        from .math import lie
        lines = []
        for t, Rcw, tcw, _ in self.trajectory(optimized):
            Rwc = Rcw.T
            twc = -Rwc @ tcw
            q = lie.quat_from_rotmat(torch.from_numpy(
                np.ascontiguousarray(Rwc))).numpy()
            lines.append(
                f"{t:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
        return "\n".join(lines) + "\n"

    def wait_idle(self):
        """Nothing runs in the background in synchronous mode."""

    def reset(self):
        """A fresh map and tracker; an attached loop closer keeps its
        vocabulary and drops its database."""
        self.map = MapState(self.cfg.map)
        self.tracker = Tracker(self.cam, self.bf, self.map, self.cfg.tracker)
        self.mapper = LocalMapper(self.cam, self.bf, self.map,
                                  self.cfg.mapper, device=self.device)
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
            self.loop_closer.db = None

    def final_global_ba(self):
        """One full-map BA at shutdown."""
        self.wait_idle()
        with metrics.timer("final_gba"):
            self.mapper.run_global_ba(stage_iters=(10, 15))

    def shutdown(self):
        """Wait for the device work enqueued so far."""
        self.wait_idle()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def metrics_report(self) -> dict:
        """Per-stage timing stats + event counters."""
        return metrics.report()
