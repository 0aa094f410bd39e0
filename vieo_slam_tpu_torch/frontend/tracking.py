"""Tracking: per-frame pose estimation state machine.

Port of the vision part of vieo_slam_tpu/frontend/tracking.py (stereo,
RGB-D and monocular): the host runs the small state machine and local-map
selection; the per-frame heavy step -- projecting a fixed-capacity
landmark slab, windowed Hamming association (kernel B4) and motion-only
BA -- runs as tensor code on the frame's device, as does the two-view
monocular initializer (descriptor matching in kernel B3).  A LOST frame
is relocalized by frontend/relocalization.py (System.track_frame calls it
when a loop closer is attached).  An odometry front end (vio/frontend.py)
hands in an external pose prediction; when vision fails on such a frame
the tracker bridges it on that prediction (ODOMOK) instead of going LOST.
Map-gauge corrections from an async mapping worker arrive through
push_correction and apply at the next frame boundary.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cameras import models as cm
from ..map.map_state import MapState
from ..math.lie import normalize_rotation_np
from ..ops import matching
from ..solvers.motion_ba import PoseObs, pose_optimization
from ..utils import prng
from .frame import Frame, desc_to_tensor


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2
    ODOMOK = 3      # dead-reckoning bridge on an odometry prediction


@dataclasses.dataclass
class TrackerConfig:
    local_landmark_cap: int = 4096   # device slab for the local map
    match_radius_coarse: float = 15.0
    match_radius_fine: float = 6.0
    min_matches_track: int = 12
    min_inliers_ok: int = 25
    kf_tracked_ratio: float = 0.9    # NeedNewKeyFrame 90% rule
    kf_min_interval: int = 1         # frames between KFs (min)
    kf_max_interval: int = 4         # force KF after this many frames
    lost_retry_radius: float = 80.0  # wide re-search before giving up
    # Adaptive stage-1 radius under rotational acceleration: the
    # constant-velocity model errs by fx * (change of inter-frame
    # rotation) pixels, so the coarse window widens by that much (capped).
    adaptive_radius_gain: float = 1.5
    adaptive_radius_max: float = 60.0
    odomok_max_frames: int = 50      # dead-reckoning bridge length cap
    use_predicted_scale: bool = False  # PredictScale-driven search radii
    th_depth: float = 4.0            # init/creation depth gate
    # (stage1 rounds, stage1 iters, stage2 rounds, stage2 iters)
    schedule: tuple = (2, 2, 1, 2)
    opt_mode: str = "plm"            # "lm" | "plm" | "gn"


class TrackKernelResult(NamedTuple):
    Rcw: torch.Tensor
    tcw: torch.Tensor
    lm_match: torch.Tensor  # [LC] keypoint idx per local landmark (-1)
    inlier: torch.Tensor    # [LC] inlier flags after pose opt
    n_inliers: torch.Tensor
    in_frustum: torch.Tensor  # [LC] landmark projected into the image


def _track_kernel(Rcw0, tcw0, lm_pw, lm_desc, lm_level, lm_valid,
                  frame: Frame, inv_sigma2_tab, level_scales,
                  radius_coarse, radius_fine, bf, cam: cm.Camera,
                  schedule: tuple = (2, 3, 2, 2), opt_mode: str = "lm"):
    """Two-stage frame tracking against a local-landmark slab.

    Stage 1: project at the predicted pose, wide-radius association,
    pose optimization.  Stage 2: re-project at the refined pose,
    tight-radius association, pose optimization."""

    def associate_and_optimize(Rcw, tcw, radius, level_tol, max_hamming,
                               ratio, rounds, iters):
        pc = torch.einsum("ij,nj->ni", Rcw, lm_pw) + tcw
        uv_proj = cm.project(cam, pc)
        vis = lm_valid & (pc[:, 2] > 0.1) & cm.in_image(cam, uv_proj, 1.0)
        idx, _ = matching.search_by_projection(
            uv_proj, lm_level, lm_desc, vis,
            frame.uv, frame.level, frame.desc, frame.valid,
            radius=radius, level_scales=level_scales,
            max_dist=max_hamming, ratio=ratio, level_tolerance=level_tol)
        kp = idx.clamp_min(0).long()
        lv = frame.level[kp].long().clamp(0, inv_sigma2_tab.shape[0] - 1)
        obs = PoseObs(pw=lm_pw, uv=frame.uv[kp], ur=frame.ur[kp],
                      inv_sigma2=inv_sigma2_tab[lv], valid=idx >= 0)
        res = pose_optimization(Rcw, tcw, obs, cam, bf, rounds=rounds,
                                iters_per_round=iters, mode=opt_mode)
        return res, idx, vis

    s1r, s1i, s2r, s2i = schedule
    res1, _, _ = associate_and_optimize(Rcw0, tcw0, radius_coarse, 8, 75, 0.8,
                                        s1r, s1i)
    res2, idx2, vis2 = associate_and_optimize(res1.Rcw, res1.tcw, radius_fine,
                                              8, 50, 0.8, s2r, s2i)
    return TrackKernelResult(Rcw=res2.Rcw, tcw=res2.tcw, lm_match=idx2,
                             inlier=res2.inliers, n_inliers=res2.n_inliers,
                             in_frustum=vis2)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Tracker:
    """Host-side tracking orchestrator (synchronous; stereo, RGB-D, mono)."""

    def __init__(self, cam: cm.Camera, bf: float, map_state: MapState,
                 cfg: Optional[TrackerConfig] = None):
        self.cam = cam
        self.bf = float(bf)
        self.map = map_state
        self.cfg = cfg or TrackerConfig()
        self.state = TrackState.NOT_INITIALIZED
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self.velocity = None         # (dR, dt): Tcw_k o Tcw_{k-1}^-1
        self._prev_vel_rot = None    # previous frame's dR (rot-accel est)
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.ref_tracked = 0         # inlier count at last KF creation
        self.last_new_kf: Optional[int] = None  # KF created this frame
        self.just_relocalized = False    # set by relocalization, read
                                         # and cleared by a VIO front end
        self.external_prediction = None  # (Rcw, tcw) from odometry
        self._last_pred_external = None  # the prediction used this frame
        self.odomok_frames = 0           # consecutive ODOMOK frames
        self.last_result: Optional[TrackKernelResult] = None
        self.last_slab = None            # (pw, lm_ids) of the last track
        # Async mapping: the worker publishes dT = Tcw_old^-1 Tcw_new of
        # each keyframe it corrected (composed under map.lock when several
        # land between two frames); Tcw <- Tcw dT at the next frame.
        self.pending_correction = None   # (dR [3, 3], dt [3]) or None
        self._mono_init_frame: Optional[Frame] = None  # held reference
        # trajectory log: (timestamp, Rcw, tcw, state)
        self.trajectory = []
        # (timestamp, ref_kf, R_cr, t_cr, state)
        self.trajectory_rel = []

    # ------------------------------------------------------------------

    def _local_landmark_slab(self):
        """Local-map landmarks (covisibility of the last KF + neighbours)
        in a fixed slab; the reference KF's own landmarks first, then
        neighbours by covisibility weight."""
        cap = self.cfg.local_landmark_cap
        m = self.map
        if self.last_kf_id >= 0:
            neigh, _ = m.covisible_keyframes(self.last_kf_id, min_shared=5)
            kfs = np.concatenate([[self.last_kf_id], neigh[:20]])
            lm_all = np.concatenate([
                m.kf_lm_idx[kf][m.kf_kp_valid[kf] & (m.kf_lm_idx[kf] >= 0)]
                for kf in kfs])
            _, first_idx = np.unique(lm_all, return_index=True)
            lm_ids = lm_all[np.sort(first_idx)]
        else:
            lm_ids = np.nonzero(m.lm_valid)[0]
        lm_ids = lm_ids[m.lm_valid[lm_ids]][:cap]
        M = len(lm_ids)
        pw = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        level = np.zeros(cap, np.int32)
        valid = np.zeros(cap, bool)
        pw[:M] = m.lm_pw[lm_ids]
        desc[:M] = m.lm_desc[lm_ids]
        valid[:M] = True
        if self.cfg.use_predicted_scale:
            cam_center = -self.Rcw.T @ self.tcw
            level[:M] = m.predict_scale(lm_ids, cam_center)
        ids = np.full(cap, -1, np.int64)
        ids[:M] = lm_ids
        return pw, desc, level, valid, ids

    def rebase_to_keyframe(self, k: int):
        """Re-read the current pose from the (BA-corrected) keyframe just
        created from this frame."""
        self.Rcw = self.map.kf_Rcw[k].copy()
        self.tcw = self.map.kf_tcw[k].copy()

    def _predict_pose(self):
        """This frame's predicted pose: the external (odometry) prediction
        when one was handed in, else the constant-velocity model."""
        if self.external_prediction is not None:
            R, t = self.external_prediction
            self.external_prediction = None
            self._last_pred_external = (np.asarray(R, np.float32),
                                        np.asarray(t, np.float32))
            return self._last_pred_external
        if self.velocity is None:
            return self.Rcw, self.tcw
        dR, dt = self.velocity
        return dR @ self.Rcw, dR @ self.tcw + dt

    # ------------------------------------------------------------------

    def track(self, frame: Frame) -> TrackState:
        """Main per-frame entry (Tracking::Track)."""
        self.last_new_kf = None
        if self.state == TrackState.NOT_INITIALIZED:
            if int((frame.depth > 0).sum()) >= 100:
                self._stereo_initialization(frame)
            else:
                self._monocular_initialization(frame)
        else:
            self._track_frame(frame)
        self.trajectory.append((float(frame.timestamp), self.Rcw.copy(),
                                self.tcw.copy(), self.state.name))
        ref = self.last_kf_id
        if ref >= 0 and self.map.kf_valid[ref]:
            R_ref, t_ref = self.map.kf_Rcw[ref], self.map.kf_tcw[ref]
            R_cr = self.Rcw @ R_ref.T
            t_cr = self.tcw - R_cr @ t_ref
            self.trajectory_rel.append(
                (float(frame.timestamp), int(ref), R_cr.astype(np.float32),
                 t_cr.astype(np.float32), self.state.name))
        else:
            self.trajectory_rel.append(
                (float(frame.timestamp), -1, self.Rcw.copy(),
                 self.tcw.copy(), self.state.name))
        self.frame_id += 1
        return self.state

    # ------------------------------------------------------------------

    def _stereo_initialization(self, frame: Frame):
        """Tracking::StereoInitialization -- needs >= 100 stereo-depth kps."""
        depth = _np(frame.depth)
        valid = _np(frame.valid)
        good = valid & (depth > 0) & (depth < self.cfg.th_depth)
        if good.sum() < 100:
            good = valid & (depth > 0) & (depth < 2.0 * self.cfg.th_depth)
        if good.sum() < 100:
            return
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        kp_idx = np.nonzero(good)[0]
        uv = _np(frame.uv)[kp_idx]
        rays = _np(cm.unproject(self.cam, torch.from_numpy(uv)))
        pw = rays * depth[kp_idx][:, None]
        lm_ids = self.map.add_landmarks(
            pw.astype(np.float32), _desc_np(frame)[kp_idx], first_kf=0)
        lm_idx_full = np.full(valid.shape[0], -1, np.int32)
        lm_idx_full[kp_idx] = lm_ids
        k = self._insert_keyframe(frame, lm_idx_full)
        self.last_kf_id = k
        self.last_new_kf = k
        self.ref_tracked = len(kp_idx)
        self.state = TrackState.OK

    def _monocular_initialization(self, frame: Frame):
        """Two-view initialization between a held reference frame and the
        current one; on success the map scale is normalized to unit median
        depth, keyframe 0 sits at the identity and keyframe 1 at
        (R21, t21)."""
        from ..solvers.initializer import monocular_init

        if self._mono_init_frame is None:
            if int(frame.valid.sum()) >= 100:
                self._mono_init_frame = frame
            return
        f0 = self._mono_init_frame
        idx, _ = matching.match_descriptors(
            f0.desc, frame.desc, f0.valid, frame.valid, max_dist=60,
            ratio=0.8)
        idx = _np(idx)
        rows = np.nonzero(idx >= 0)[0]
        if rows.size < 100:
            # too little overlap: re-anchor on the current frame
            self._mono_init_frame = frame
            return
        n_cap = f0.uv.shape[0]
        uv1 = np.zeros((n_cap, 2), np.float32)
        uv2 = np.zeros((n_cap, 2), np.float32)
        val = np.zeros(n_cap, bool)
        m = rows.size
        uv1[:m] = _np(f0.uv)[rows]
        uv2[:m] = _np(frame.uv)[idx[rows]]
        val[:m] = True
        dev = frame.uv.device
        res = monocular_init(
            torch.from_numpy(uv1).to(dev), torch.from_numpy(uv2).to(dev),
            torch.from_numpy(val).to(dev), self.cam,
            prng.prng_key(self.frame_id))
        if not bool(res.ok):
            return
        good = _np(res.good)[:m]
        pw = _np(res.pw)[:m]
        # Normalize scale: unit median depth.
        med = float(np.median(pw[good, 2])) if good.any() else 1.0
        if not np.isfinite(med) or med <= 1e-6:
            return
        inv = 1.0 / med
        pw = pw * inv
        R21 = _np(res.R21).astype(np.float32)
        t21 = _np(res.t21).astype(np.float32) * inv

        kp0 = rows[good]
        kp1 = idx[rows][good]
        lm_ids = self.map.add_landmarks(
            pw[good].astype(np.float32), _desc_np(f0)[kp0], first_kf=0)
        lm0 = np.full(n_cap, -1, np.int32)
        lm1 = np.full(frame.uv.shape[0], -1, np.int32)
        lm0[kp0] = lm_ids
        lm1[kp1] = lm_ids
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self._insert_keyframe(f0, lm0, frame_id=self.frame_id - 1)
        self.Rcw = normalize_rotation_np(R21)
        self.tcw = t21
        k1 = self._insert_keyframe(frame, lm1)
        self.last_kf_id = k1
        self.last_new_kf = k1
        self.ref_tracked = int(good.sum())
        self.state = TrackState.OK
        self._mono_init_frame = None

    # ------------------------------------------------------------------

    def _run_kernel(self, frame: Frame, slab, R0, t0, coarse_r):
        pw, desc, level, valid, _ = slab
        dev = frame.uv.device
        f32 = dict(dtype=torch.float32, device=dev)
        return _track_kernel(
            torch.as_tensor(np.asarray(R0, np.float32), **f32),
            torch.as_tensor(np.asarray(t0, np.float32), **f32),
            torch.from_numpy(pw).to(dev), desc_to_tensor(desc, dev),
            torch.from_numpy(level).to(dev), torch.from_numpy(valid).to(dev),
            frame,
            torch.from_numpy(self.map.inv_sigma2).to(dev),
            torch.from_numpy(self.map.level_scales.astype(np.float32)).to(dev),
            torch.tensor(coarse_r, **f32),
            torch.tensor(self.cfg.match_radius_fine, **f32),
            self.bf, self.cam,
            schedule=self.cfg.schedule, opt_mode=self.cfg.opt_mode)

    def push_correction(self, R_old, t_old, R_new, t_new):
        """Record a map-gauge correction dT = T_old^-1 T_new from the
        mapping worker, composed with any not yet applied (call under
        map.lock)."""
        dR = R_old.T @ R_new
        dt = R_old.T @ (t_new - t_old)
        if self.pending_correction is not None:
            Ra, ta = self.pending_correction
            dR, dt = Ra @ dR, Ra @ dt + ta
        self.pending_correction = (dR.astype(np.float32),
                                   dt.astype(np.float32))

    def _apply_pending_correction(self):
        """Tcw <- Tcw dT: keep the frame-to-keyframe relative pose in the
        corrected map gauge (call under map.lock)."""
        corr, self.pending_correction = self.pending_correction, None
        if corr is None:
            return
        dR, dt = corr
        R_cur = self.Rcw
        self.Rcw = normalize_rotation_np(R_cur @ dR)
        self.tcw = (R_cur @ dt + self.tcw).astype(np.float32)

    def _track_frame(self, frame: Frame):
        with self.map.lock:
            self._apply_pending_correction()
            slab = self._local_landmark_slab()
        lm_ids = slab[4]
        used_external = self.external_prediction is not None
        R0, t0 = self._predict_pose()
        # An external prediction tracks rotation directly: its error does
        # not grow with rotational acceleration, so it keeps the tight
        # window.
        coarse_r = self.cfg.match_radius_coarse
        if (not used_external and self.velocity is not None
                and self._prev_vel_rot is not None):
            dacc = self.velocity[0] @ self._prev_vel_rot.T
            cosang = np.clip((np.trace(dacc) - 1.0) / 2.0, -1.0, 1.0)
            ang = float(np.arccos(cosang))
            coarse_r = min(
                coarse_r + self.cfg.adaptive_radius_gain * self.cam.fx * ang,
                self.cfg.adaptive_radius_max)
        res = self._run_kernel(frame, slab, R0, t0, coarse_r)
        n_inl = int(res.n_inliers)
        if n_inl < self.cfg.min_inliers_ok:
            # Wide-radius retries: from the prediction, then from the last
            # known-good pose.  Without a velocity the two are the same
            # pose, and the second call would repeat the first.
            starts = [(R0, t0)]
            if not (np.array_equal(R0, self.Rcw)
                    and np.array_equal(t0, self.tcw)):
                starts.append((self.Rcw, self.tcw))
            for Rr, tr_ in starts:
                res = self._run_kernel(frame, slab, Rr, tr_,
                                       self.cfg.lost_retry_radius)
                n_inl = int(res.n_inliers)
                if n_inl >= self.cfg.min_inliers_ok:
                    break
        if n_inl < self.cfg.min_inliers_ok:
            if (self._last_pred_external is not None
                    and self.odomok_frames < self.cfg.odomok_max_frames):
                self._odomok_bridge(frame)
                return
            self.state = TrackState.LOST
            self.velocity = None
            self._prev_vel_rot = None
            self._last_pred_external = None
            return
        self.odomok_frames = 0
        self._last_pred_external = None
        R_prev, t_prev = self.Rcw.copy(), self.tcw.copy()
        self.Rcw = normalize_rotation_np(_np(res.Rcw))
        self.tcw = _np(res.tcw)
        dR = self.Rcw @ R_prev.T
        dt = self.tcw - dR @ t_prev
        self._prev_vel_rot = self.velocity[0] \
            if self.velocity is not None else None
        self.velocity = (dR.astype(np.float32), dt.astype(np.float32))
        self.state = TrackState.OK
        self.last_result = res
        self.last_slab = (slab[0], lm_ids)
        self.frames_since_kf += 1
        in_frustum = _np(res.in_frustum)
        inlier = _np(res.inlier)
        vis_ids = lm_ids[in_frustum & (lm_ids >= 0)]
        fnd_ids = lm_ids[inlier & (lm_ids >= 0)]
        with self.map.lock:
            np.add.at(self.map.lm_visible, vis_ids, 1)
            np.add.at(self.map.lm_found, fnd_ids, 1)
            if self._need_new_keyframe(n_inl):
                lm_idx_full = self._frame_landmark_assoc(
                    _np(res.lm_match), inlier, lm_ids, _np(frame.valid))
                k = self._insert_keyframe(frame, lm_idx_full)
                self.last_kf_id = k
                self.last_new_kf = k
                self.ref_tracked = n_inl
                self.frames_since_kf = 0

    def _odomok_bridge(self, frame: Frame):
        """Carry the pose through a visual dropout on the odometry
        prediction; each later frame retries vision from it.  Frames with
        enough close stereo depth still become keyframes at the
        dead-reckoned pose, so the territory swept blind gets landmarks."""
        self.Rcw, self.tcw = self._last_pred_external
        self._last_pred_external = None
        self.velocity = None
        self.odomok_frames += 1
        self.state = TrackState.ODOMOK
        depth = _np(frame.depth)
        kp_valid = _np(frame.valid)
        n_close = int((kp_valid & (depth > 0)
                       & (depth < 2.0 * self.cfg.th_depth)).sum())
        if self.frames_since_kf >= 2 and n_close > 70:
            with self.map.lock:
                k = self._insert_keyframe(
                    frame, np.full(kp_valid.shape[0], -1, np.int32))
                self.last_kf_id = k
                self.last_new_kf = k
                self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1

    # ------------------------------------------------------------------

    def _frame_landmark_assoc(self, lm_match, inlier, lm_ids, kp_valid):
        """[N] landmark id per keypoint from the track result."""
        out = np.full(kp_valid.shape[0], -1, np.int32)
        ok = (lm_match >= 0) & inlier & (lm_ids >= 0)
        ok &= self.map.lm_valid[np.clip(lm_ids, 0, None)]
        out[lm_match[ok]] = lm_ids[ok]
        return out

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """NeedNewKeyFrame: 90% rule + min/max frame intervals."""
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        return n_inliers < self.cfg.kf_tracked_ratio * max(self.ref_tracked, 1)

    def _insert_keyframe(self, frame: Frame, lm_idx_full: np.ndarray,
                         frame_id: Optional[int] = None) -> int:
        """A keyframe of `frame` at the tracker's current pose."""
        f_uv = _np(frame.uv)
        return self.map.add_keyframe(
            Rcw=self.Rcw, tcw=self.tcw, timestamp=float(frame.timestamp),
            frame_id=self.frame_id if frame_id is None else frame_id,
            uv=f_uv, level=_np(frame.level),
            desc=_desc_np(frame), ur=_np(frame.ur), depth=_np(frame.depth),
            kp_valid=_np(frame.valid), lm_idx=lm_idx_full)


def _desc_np(frame: Frame) -> np.ndarray:
    """Frame descriptors as the map's uint32 words."""
    return _np(frame.desc).view(np.uint32)
