"""VIO front end: IMU-fused tracking around the visual System.

Port of vieo_slam_tpu/vio/frontend.py.  Odometry samples go to the
native ring (io.odom_ring.NativeOdomRing); each frame's IMU window is
preintegrated on the system's device, the IMU-propagated state gives the
tracker its pose prediction (and carries the pose through a visual
dropout, ODOMOK), and
after visual tracking the 30D joint motion BA (solvers/vio_ba) fuses
vision and IMU and carries the 15D marginal prior from frame to frame.  VI
initialization (vio/initialization) runs at keyframe cadence until enough
baseline has accumulated; its final acceptance engages the PRV keyframe
backend (vio/backend) and its init global BA.  Wheel-encoder samples ride
the same machinery (a second ring and the encoder factor).

With an async-mapping System the front end owns keyframe dispatch (the
fused state lands on the keyframe before the worker sees it), runs the
PRV window BA as the worker's post-hook, and follows the worker's gauge
corrections like the tracker does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..io.odom_ring import NativeOdomRing, trim_padding
from ..math.lie import normalize_rotation_np
from ..math.navstate import NavState, navstate_from_tcw, tcw_from_navstate
from ..math.preintegration import preintegrate_encoder, preintegrate_imu
from ..solvers.motion_ba import PoseObs
from ..solvers.vio_ba import vio_pose_optimization
from ..system import System
from ..utils.cuda_graph import GraphedCall
from ..utils.metrics import metrics
from .initialization import recompute_bias_navstate, try_init_vio


@dataclasses.dataclass
class VioConfig:
    sigma_g: float = 1.7e-4
    sigma_a: float = 2e-3
    sigma_bg_rw: float = 2e-4
    sigma_ba_rw: float = 2e-3
    window_cap: int = 64            # IMU samples per frame gap
    init_window_cap: int = 512      # IMU samples per keyframe gap at init
    init_min_kfs: int = 12
    init_min_span: float = 4.0      # provisional init span (starts fusion)
    # Final-acceptance span: the init solves re-run on every new keyframe
    # over all keyframes until this much baseline exists; the PRV
    # keyframe backend engages only then.
    init_final_span: float = 15.0
    solve_scale: bool = False       # stereo / RGB-D
    # encoder (VEO / VIEO)
    use_encoder: bool = False
    enc_half_track: float = 0.28
    enc_sigma_v: float = 0.01
    enc_Rbe: object = None          # body-from-encoder extrinsic; None = I
    enc_tbe: object = None
    # keyframe backend (PRV sliding-window local BA + init global BA)
    use_backend: bool = True
    backend_window: int = 10
    run_init_gba: bool = True
    # Initial-bias prior inside the init global BA (off: pinning the first
    # bias to the linear estimate bends the poses instead).
    init_gba_bias_prior: bool = False
    # Wait up to this many wall-clock seconds for odometry covering the
    # frame (free when the caller feeds the samples first); a window
    # still short after it is zero-order-hold filled.
    delay_for_polling: float = 0.02
    odom_gap_tol: float = 0.02      # tail gap (s) before the fill kicks in


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class VioFrontend:
    """System wrapper adding IMU (and optional encoder) fusion."""

    def __init__(self, system: System, Rcb=None, tcb=None,
                 cfg: Optional[VioConfig] = None):
        self.sys = system
        self.device = system.device
        self.cfg = cfg or VioConfig()
        self.Rcb = np.eye(3, dtype=np.float32) if Rcb is None else \
            np.asarray(Rcb, np.float32)
        self.tcb = np.zeros(3, np.float32) if tcb is None else \
            np.asarray(tcb, np.float32)
        self._Rcb_t = self._t(self.Rcb)
        self._tcb_t = self._t(self.tcb)
        self.ring = NativeOdomRing(1 << 16)
        self.enc_ring = NativeOdomRing(1 << 14) if self.cfg.use_encoder \
            else None
        self.Rbe = np.eye(3, dtype=np.float32) if self.cfg.enc_Rbe is None \
            else np.asarray(self.cfg.enc_Rbe, np.float32)
        self.tbe = np.zeros(3, np.float32) if self.cfg.enc_tbe is None \
            else np.asarray(self.cfg.enc_tbe, np.float32)
        self.inited = False             # provisional: per-frame fusion on
        self.final_inited = False       # accepted: PRV backend engaged
        self.gw = np.array([0.0, 0.0, -9.81], np.float32)
        self.bg = np.zeros(3, np.float32)
        self.ba = np.zeros(3, np.float32)
        self.ns_last: Optional[NavState] = None   # tensors on the device
        self.prior_info: Optional[np.ndarray] = None
        self.last_t: Optional[float] = None
        self.kf_times: list[tuple[int, float]] = []   # (kf_id, timestamp)
        self.backend = None             # VioBackend, created at final init
        # Frames (t, Rcw, tcw) tracked vision-only since a relocalization;
        # fusion is suspended while this fills.
        self._reloc_frames: Optional[list] = None
        self.reloc_recompute_n = 20
        self._pending_ns_corr = None    # (dR, dt), guarded by map.lock
        self._Rbe_t = self._t(self.Rbe)
        self._tbe_t = self._t(self.tbe)
        # The joint motion BA and a frame's preintegration, replayed from
        # CUDA graphs on a GPU (the BA's ~77000 operators a frame are host
        # launches otherwise); plain calls on the CPU.
        self._fused = GraphedCall(self._solve)
        self._preint = GraphedCall(self._integrate)
        if system.cfg.async_mapping:
            system.defer_kf_dispatch = True
            system.correction_sinks.append(self)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    # ------------------------------------------------------------------

    def track_odom(self, t: float, gyro, acc):
        """Queue one IMU sample (rad/s, m/s^2, body frame)."""
        self.ring.push(t, np.concatenate([gyro, acc]).astype(np.float32))

    def track_encoder(self, t: float, v_left: float, v_right: float):
        v = np.zeros(6, np.float32)
        v[0], v[1] = v_left, v_right
        self.enc_ring.push(t, v)

    # ------------------------------------------------------------------

    def _preintegrate(self, t0: float, t1: float, cap: int):
        vals, dts, mask, _, lag = self.ring.window_filled(
            t0, t1, cap, tail_tol=self.cfg.odom_gap_tol)
        if lag > 0:
            metrics.count("imu_window_zoh_filled")
        vals, dts, mask = trim_padding(vals, dts, mask)
        # One graph for each trimmed window length.
        return self._preint(
            self._t(vals[:, :3]), self._t(vals[:, 3:]), self._t(dts),
            self._t(self.bg), self._t(self.ba),
            torch.from_numpy(mask).to(self.device))

    def _integrate(self, gyro, acc, dt, bg, ba, mask):
        return preintegrate_imu(gyro, acc, dt, bg, ba, self.cfg.sigma_g,
                                self.cfg.sigma_a, mask=mask)

    def _propagate(self, ns: NavState, pre) -> NavState:
        """IMU state propagation over one preintegrated window."""
        g = self._t(self.gw)
        dt = pre.dt
        dR, dv, dp = pre.corrected(ns.bg + ns.dbg - pre.bg,
                                   ns.ba + ns.dba - pre.ba)
        return ns._replace(R=ns.R @ dR, v=ns.v + g * dt + ns.R @ dv,
                           p=ns.p + ns.v * dt + 0.5 * g * dt * dt
                           + ns.R @ dp)

    def _enc_window(self, t0: float, t1: float):
        ev, edts, emask, n, _ = self.enc_ring.window_filled(
            t0, t1, self.cfg.window_cap, tail_tol=self.cfg.odom_gap_tol)
        return ev, edts, emask, n

    def _preintegrate_enc(self, ev, edts, emask):
        return preintegrate_encoder(
            self._t(ev[:, 0]), self._t(ev[:, 1]), self._t(edts),
            self.cfg.enc_half_track, self.cfg.enc_sigma_v,
            mask=torch.from_numpy(emask).to(self.device))

    def _propagate_enc(self, ns: NavState, t0: float, t1: float):
        """Encoder dead-reckoning of the body pose over [t0, t1]:
        T_w_bj = T_w_bi T_be dT_e T_be^-1.  (R_j, p_j) numpy, or None if
        the window holds no samples."""
        ev, edts, emask, n = self._enc_window(t0, t1)
        if n == 0:
            return None
        enc = self._preintegrate_enc(ev, edts, emask)
        dR_e, dp_e = _np(enc.dR), _np(enc.dp)
        R_i, p_i = _np(ns.R), _np(ns.p)
        Rbe, tbe = self.Rbe, self.tbe
        R_j = R_i @ Rbe @ dR_e @ Rbe.T
        p_j = p_i + R_i @ (tbe + Rbe @ dp_e) - R_j @ tbe
        return R_j.astype(np.float32), p_j.astype(np.float32)

    def _navstate_from_pose(self, Rcw, tcw) -> NavState:
        return navstate_from_tcw(self._t(Rcw), self._t(tcw), self._Rcb_t,
                                 self._tcb_t)

    def _pose_of(self, ns: NavState):
        """(Rcw, tcw) numpy of a NavState."""
        Rcw, tcw = tcw_from_navstate(ns, self._Rcb_t, self._tcb_t)
        return _np(Rcw), _np(tcw)

    # ------------------------------------------------------------------

    def push_correction(self, R_old, t_old, R_new, t_new):
        """Map-gauge correction from the mapping worker (the tracker's
        convention; called under map.lock), applied to the NavState at the
        next frame."""
        dR = R_old.T @ R_new
        dt = R_old.T @ (t_new - t_old)
        if self._pending_ns_corr is not None:
            Ra, ta = self._pending_ns_corr
            dR, dt = Ra @ dR, Ra @ dt + ta
        self._pending_ns_corr = (dR.astype(np.float32),
                                 dt.astype(np.float32))

    def _apply_ns_correction(self):
        """Re-anchor the fused NavState in the worker-corrected gauge; the
        world velocity follows the body rotation, the biases are gauge
        free, and a carried prior is replaced by the rebase prior."""
        with self.sys.map.lock:
            corr, self._pending_ns_corr = self._pending_ns_corr, None
        if corr is None or self.ns_last is None:
            return
        dR, dt = corr
        Rcw, tcw = self._pose_of(self.ns_last)
        ns2 = self._navstate_from_pose(normalize_rotation_np(Rcw @ dR),
                                       Rcw @ dt + tcw)
        W = ns2.R @ self.ns_last.R.T
        self.ns_last = self.ns_last._replace(R=ns2.R, p=ns2.p,
                                             v=W @ self.ns_last.v)
        if self.prior_info is not None:
            self.prior_info = self._fresh_prior()

    def _backend_worker_step(self, k: int):
        """Worker post-hook: the PRV window BA of keyframe k (the worker
        pushes the resulting gauge correction)."""
        self.backend.run_local_ba(k)

    def _dispatch_deferred(self):
        """Hand this frame's new keyframe, if any, to the mapping worker,
        now that the fused NavState is stored on it."""
        if not self.sys.defer_kf_dispatch:
            return
        post = self._backend_worker_step \
            if (self.final_inited and self.backend is not None) else None
        self.sys.dispatch_keyframe(post_hook=post)

    def _keyframe_created(self, k: int, t: float):
        self.kf_times.append((k, t))
        self._store_kf_navstate(k)

    def track_frame(self, frame):
        """Track one frame with IMU prediction and fusion; the samples up to
        its timestamp should have been given to track_odom first."""
        t = float(frame.timestamp)
        tr = self.sys.tracker
        self._apply_ns_correction()
        pre = None
        if self.inited and self.last_t is not None:
            if not self.ring.wait_until(t - self.cfg.odom_gap_tol,
                                        self.cfg.delay_for_polling):
                metrics.count("imu_poll_timeout")
            with metrics.timer("vio.preintegrate"):
                pre = self._preintegrate(self.last_t, t, self.cfg.window_cap)
            ns_pred = self._propagate(self.ns_last, pre)
            if self.cfg.use_encoder and self.enc_ring is not None:
                # Wheel odometry gives the tighter short-horizon pose; keep
                # the IMU-propagated velocity and biases.
                enc_pose = self._propagate_enc(self.ns_last, self.last_t, t)
                if enc_pose is not None:
                    ns_pred = ns_pred._replace(R=self._t(enc_pose[0]),
                                               p=self._t(enc_pose[1]))
            tr.external_prediction = self._pose_of(ns_pred)

        state = self.sys.track_frame(frame)

        if state.name == "ODOMOK" and pre is not None:
            # A visual dropout bridged by dead reckoning: carry the
            # propagated state; ODOMOK keyframes take it too, so the
            # backend's chains stay unbroken across the dropout.
            self.ns_last = ns_pred
            if tr.last_new_kf is not None:
                self._keyframe_created(tr.last_new_kf, t)
            self.last_t = t
            self._dispatch_deferred()
            return state

        if tr.just_relocalized:
            tr.just_relocalized = False
            if self.inited:
                # The stale state and prior are wrong in the relocalized
                # frame: track vision-only for a while, then recompute the
                # biases and the velocity.
                self._reloc_frames = []
                self.prior_info = None

        if state.name == "OK":
            if self._reloc_frames is not None:
                self._reloc_frames.append((t, tr.Rcw.copy(), tr.tcw.copy()))
                # A vision-anchored state keeps ODOMOK and prediction alive.
                self.ns_last = self._navstate_from_pose(tr.Rcw, tr.tcw)\
                    ._replace(v=self._t(np.zeros(3)), bg=self._t(self.bg),
                              ba=self._t(self.ba))
                if tr.last_new_kf is not None:
                    self._keyframe_created(tr.last_new_kf, t)
                if len(self._reloc_frames) >= self.reloc_recompute_n:
                    self._recompute_bias_after_reloc()
                self.last_t = t
                self._dispatch_deferred()
                return state
            if self.inited and pre is not None:
                with metrics.timer("vio.fuse"):
                    self._fuse(frame, pre)
            else:
                # A vision-only NavState (R, p from the pose).
                ns = self._navstate_from_pose(tr.Rcw, tr.tcw)
                v = torch.zeros_like(ns.p) if self.ns_last is None else (
                    (ns.p - self.ns_last.p)
                    / max(t - (self.last_t or t) or 1e-3, 1e-3))
                self.ns_last = ns._replace(v=v, bg=self._t(self.bg),
                                           ba=self._t(self.ba))
            if tr.last_new_kf is not None:
                self._keyframe_created(tr.last_new_kf, t)
                if not self.final_inited:
                    # (Re)run the VI init solves over all keyframes; in
                    # async mode this keyframe's mapping dispatches first,
                    # and _maybe_init drains the worker before touching
                    # the whole map.
                    self._dispatch_deferred()
                    self._maybe_init()
                elif self.backend is not None:
                    # The PRV window BA at keyframe cadence: on the worker
                    # as the dispatch post-hook in async mode, inline
                    # (with a rebase on the solved keyframe) otherwise.
                    if self.sys.defer_kf_dispatch:
                        self._dispatch_deferred()
                    else:
                        with metrics.timer("vio.local_ba"):
                            solved = self.backend.run_local_ba(
                                tr.last_new_kf)
                        if solved:
                            self._rebase_from_kf(tr.last_new_kf)
        self._dispatch_deferred()
        self.last_t = t
        return state

    def _imu_windows(self, ts: np.ndarray, cap: int):
        """Padded IMU windows [N - 1, cap] between consecutive timestamps,
        or None if one does not fit."""
        N = len(ts)
        gyro = np.zeros((N - 1, cap, 3), np.float32)
        acc = np.zeros((N - 1, cap, 3), np.float32)
        dt = np.zeros((N - 1, cap), np.float32)
        mask = np.zeros((N - 1, cap), bool)
        for i in range(N - 1):
            vals, dts, mk, n = self.ring.window(ts[i], ts[i + 1], cap)
            if n > cap:
                return None
            gyro[i], acc[i], dt[i], mask[i] = vals[:, :3], vals[:, 3:], dts, mk
        gyro, acc, dt, mask = trim_padding(gyro, acc, dt, mask)
        return (self._t(gyro), self._t(acc), self._t(dt),
                torch.from_numpy(mask).to(self.device))

    def _recompute_bias_after_reloc(self):
        """Gyro-bias GN and the linear accel-bias / velocity solve over the
        frames collected since the relocalization, gravity kept; on
        success the fused tracking resumes from the recomputed state."""
        frames = self._reloc_frames
        self._reloc_frames = None
        ts = np.asarray([f[0] for f in frames], np.float64)
        R_wc = np.swapaxes(np.stack([f[1] for f in frames]), -1, -2)
        p_wc = -np.einsum("kij,kj->ki", R_wc, np.stack([f[2] for f in frames]))
        windows = self._imu_windows(ts, self.cfg.window_cap)
        if windows is None:
            return      # cannot recompute; stay vision-anchored
        out = recompute_bias_navstate(
            self._t(ts), self._t(R_wc), self._t(p_wc), self._Rcb_t,
            self._tcb_t, *windows, self.gw, self.cfg.sigma_g,
            self.cfg.sigma_a)
        bg, ba, v = _np(out.bg), _np(out.ba), _np(out.v)
        if not (np.isfinite(bg).all() and np.isfinite(ba).all()
                and np.isfinite(v).all()) or np.linalg.norm(bg) > 0.5 \
                or np.linalg.norm(ba) > 3.0:
            return
        self.bg, self.ba = bg, ba
        pcb = -self.Rcb.T @ self.tcb
        z = self._t(np.zeros(3))
        self.ns_last = NavState(
            R=self._t(R_wc[-1] @ self.Rcb), p=self._t(p_wc[-1] + R_wc[-1] @ pcb),
            v=self._t(v[-1]), bg=self._t(bg), ba=self._t(ba), dbg=z, dba=z)
        self.prior_info = self._fresh_prior()

    def _rebase_from_kf(self, k: int):
        """Continue from the backend-optimized keyframe: its pose, its
        NavState and a fresh marginal prior."""
        m = self.sys.map
        self.sys.tracker.rebase_to_keyframe(k)
        z = self._t(np.zeros(3))
        self.ns_last = NavState(
            R=self._t(m.kf_Rwb[k]), p=self._t(m.kf_pwb[k]),
            v=self._t(m.kf_vwb[k]), bg=self._t(m.kf_bg[k]),
            ba=self._t(m.kf_ba[k]), dbg=z, dba=z)
        self.prior_info = self._fresh_prior()

    @staticmethod
    def _fresh_prior() -> np.ndarray:
        """Moderate diagonal prior for a state just (re)based on a solved
        keyframe, PVR + bias order [p, v, phi, bg, ba]: velocity and biases
        are trustworthy there, the pose stays loose (vision anchors it)."""
        return np.diag(np.concatenate([
            np.full(3, 1e-2), np.full(3, 4e2), np.full(3, 1e-2),
            np.full(3, 1e4), np.full(3, 1e2)])).astype(np.float32)

    # ------------------------------------------------------------------

    def _fuse(self, frame, pre):
        """The joint VIO motion BA on the tracker's last matches, and the
        marginal prior carried to the next frame."""
        tr = self.sys.tracker
        res = tr.last_result
        if res is None or tr.last_slab is None:
            return
        pw, _ = tr.last_slab
        dev = self.device
        match = res.lm_match
        kp = match.clamp_min(0).long()
        lvl = frame.level[kp].long().clamp_min(0)
        inv_sigma2 = torch.from_numpy(self.sys.map.inv_sigma2).to(dev)
        obs = PoseObs(pw=torch.from_numpy(pw).to(dev), uv=frame.uv[kp],
                      ur=frame.ur[kp], inv_sigma2=inv_sigma2[lvl],
                      valid=(match >= 0) & res.inlier)
        ns_vis = self._navstate_from_pose(tr.Rcw, tr.tcw)
        last = self.ns_last
        ns_cur0 = ns_vis._replace(v=self._propagate(last, pre).v, bg=last.bg,
                                  ba=last.ba, dbg=last.dbg, dba=last.dba)
        enc = ()
        if self.cfg.use_encoder and self.enc_ring is not None \
                and self.last_t is not None:
            ev, edts, emask, _ = self.enc_ring.window(
                self.last_t, float(frame.timestamp), self.cfg.window_cap)
            enc = (self._preintegrate_enc(ev, edts, emask),)
        prior = self.prior_info if self.prior_info is not None \
            else 1e-6 * np.eye(15, dtype=np.float32)
        out = self._fused_solve(last, ns_cur0, pre, obs, self._t(prior),
                                self._t(self.gw), *enc)
        # One read of the solved state decides acceptance: a non-finite
        # solve or one claiming |bg| > 0.5 rad/s or |ba| > 3 m/s^2 has run
        # away, and the previous state is kept.
        ns = out.ns
        head = _np(torch.cat([ns.p, ns.bg + ns.dbg, ns.ba + ns.dba]))
        if not np.isfinite(head[:3]).all():
            return
        if np.linalg.norm(head[3:6]) > 0.5 or np.linalg.norm(head[6:]) > 3.0:
            return
        # Rotations are re-projected onto SO(3) at this boundary.
        ns = ns._replace(R=self._t(normalize_rotation_np(_np(ns.R))))
        Rcw, tcw = self._pose_of(ns)
        tr.Rcw = normalize_rotation_np(Rcw.astype(np.float32))
        tr.tcw = tcw.astype(np.float32)
        self.ns_last = ns
        self.prior_info = _np(out.prior_info)

    def _fused_solve(self, ns_last, ns_cur0, pre, obs, prior, gravity,
                     enc_pre=None):
        """The joint VIO solve; the prior is always present (a negligible
        1e-6 I before the first marginalization)."""
        return self._fused(ns_last, ns_cur0, pre, obs, prior, gravity,
                           *(() if enc_pre is None else (enc_pre,)))

    def _solve(self, ns_last, ns_cur0, pre, obs, prior, gravity, *enc):
        kw = dict(Rbe=self._Rbe_t, tbe=self._tbe_t) if enc else {}
        return vio_pose_optimization(
            ns_last, ns_cur0, pre, obs, self.sys.cam, self._Rcb_t,
            self._tcb_t, self.sys.bf, prior_info=prior, last_fixed=False,
            enc_pre=enc[0] if enc else None,
            sigma_bg_rw=self.cfg.sigma_bg_rw,
            sigma_ba_rw=self.cfg.sigma_ba_rw, gravity=gravity, **kw)

    # ------------------------------------------------------------------

    def _store_kf_navstate(self, k: int):
        ns = self.ns_last
        if ns is None:
            return
        R, p, v = _np(ns.R), _np(ns.p), _np(ns.v)
        bg, ba = _np(ns.bg + ns.dbg), _np(ns.ba + ns.dba)
        pose = self._pose_of(ns) if self.inited else None
        m = self.sys.map
        with m.lock:
            m.kf_Rwb[k], m.kf_pwb[k], m.kf_vwb[k] = R, p, v
            m.kf_bg[k], m.kf_ba[k] = bg, ba
            if pose is not None:
                # The joint motion BA ran after the keyframe was created:
                # the keyframe takes the fused pose.
                m.kf_Rcw[k], m.kf_tcw[k] = pose

    def _maybe_init(self):
        cfg = self.cfg
        if len(self.kf_times) < cfg.init_min_kfs:
            return
        span = self.kf_times[-1][1] - self.kf_times[0][1]
        if span < cfg.init_min_span:
            return
        # Exclusive map access for the init solves and the rescale: drain
        # the mapping worker, then flush pending gauge corrections so that
        # they are not applied again after the init rewrites the states.
        self.sys.wait_idle()
        m = self.sys.map
        with m.lock:
            self.sys.tracker._apply_pending_correction()
        self._apply_ns_correction()
        kf_ids = [k for k, _ in self.kf_times if m.kf_valid[k]]
        ts = np.asarray([t for k, t in self.kf_times if m.kf_valid[k]],
                        np.float64)
        if len(kf_ids) < cfg.init_min_kfs:
            return
        R_wc = np.swapaxes(m.kf_Rcw[kf_ids], -1, -2)
        p_wc = -np.einsum("kij,kj->ki", R_wc, m.kf_tcw[kf_ids])
        windows = self._imu_windows(ts, cfg.init_window_cap)
        if windows is None:
            return      # window capacity too small; retry at the next KF
        with metrics.timer("vio.init"):
            out = try_init_vio(
                self._t(ts), self._t(R_wc), self._t(p_wc), self._Rcb_t,
                self._tcb_t, *windows, cfg.sigma_g, cfg.sigma_a,
                solve_scale=cfg.solve_scale)
            gw = _np(out.gw)
        if not np.isfinite(gw).all() or abs(np.linalg.norm(gw) - 9.81) > 0.5:
            return
        self.gw = gw.astype(np.float32)
        self.bg = _np(out.bg).astype(np.float32)
        self.ba = _np(out.ba).astype(np.float32)
        scale = float(out.scale)
        if cfg.solve_scale and np.isfinite(scale) and scale > 0:
            # Rescale the whole map (monocular).
            m.lm_pw[m.lm_valid] *= scale
            m.kf_tcw[m.kf_valid] *= scale
            self.sys.tracker.tcw = self.sys.tracker.tcw * scale
        v = _np(out.v)
        Rwb_all = R_wc @ self.Rcb
        pcb = -self.Rcb.T @ self.tcb
        for i, k in enumerate(kf_ids):
            m.kf_Rwb[k] = Rwb_all[i]
            m.kf_pwb[k] = (p_wc[i] * (scale if cfg.solve_scale else 1.0)
                           + R_wc[i] @ pcb)
            m.kf_vwb[k] = v[i]
            m.kf_bg[k] = self.bg
            m.kf_ba[k] = self.ba
        k_last = kf_ids[-1]
        z = self._t(np.zeros(3))
        self.ns_last = NavState(
            R=self._t(m.kf_Rwb[k_last]), p=self._t(m.kf_pwb[k_last]),
            v=self._t(m.kf_vwb[k_last]), bg=self._t(self.bg),
            ba=self._t(self.ba), dbg=z, dba=z)
        self.prior_info = self._fresh_prior()
        self.inited = True
        self.sys.mapper.vio_active = True
        if span >= cfg.init_final_span:
            # Final acceptance: freeze the init, engage the PRV keyframe
            # backend and its init global BA.
            self.final_inited = True
            if cfg.use_backend:
                self._attach_backend()

    def _attach_backend(self):
        """Create the PRV keyframe backend and run the init global BA (with
        the gravity direction, and scale for monocular)."""
        from .backend import VioBackend, VioBackendConfig

        cfg = self.cfg
        self.backend = VioBackend(
            self.sys.map, self.sys.cam, self.sys.bf, self.ring, self.Rcb,
            self.tcb,
            cfg=VioBackendConfig(window_size=cfg.backend_window,
                                 sigma_g=cfg.sigma_g, sigma_a=cfg.sigma_a,
                                 sigma_bg_rw=cfg.sigma_bg_rw,
                                 sigma_ba_rw=cfg.sigma_ba_rw),
            enc_ring=self.enc_ring, Rbe=self.Rbe, tbe=self.tbe,
            enc_half_track=cfg.enc_half_track, enc_sigma_v=cfg.enc_sigma_v,
            device=self.device)
        self.backend.gravity = self.gw.copy()
        # The vision-only local BA stops; the PRV window BA replaces it.
        self.sys.mapper.skip_local_ba = True
        if cfg.run_init_gba:
            with metrics.timer("vio.init_gba"):
                ok = self.backend.run_global_ba(
                    opt_scale=cfg.solve_scale, opt_gdir=True,
                    init_prior=cfg.init_gba_bias_prior)
            if ok:
                self.gw = self.backend.gravity.copy()
                kfs = self.sys.map.keyframe_ids()
                if len(kfs):
                    self._rebase_from_kf(int(kfs[-1]))
