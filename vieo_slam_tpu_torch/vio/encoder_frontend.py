"""VEO front end: wheel-encoder-fused tracking without an IMU.

Port of vieo_slam_tpu/vio/encoder_frontend.py (the reference's mode
ENCODER, Tracking::CacheOdom).  The encoder gives the tracker its motion
prediction, carries the pose through a visual dropout (ODOMOK), and
enters the pose solve of every tracked frame as a 6D prior: the wheel
speeds between two frames are preintegrated on SE(2) on the system's
device, the prediction and its information are formed on the host in
numpy (as in the JAX package), and the joint vision + prior motion BA
(solvers/motion_ba.pose_optimization_with_prior) runs on the device,
replayed from a CUDA graph on a GPU.  Wheel odometry is metric and
gravity-free, so fusion is active from the first tracked frame: there is
no initialization phase.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..io.odom_ring import NativeOdomRing, trim_padding
from ..math.lie import normalize_rotation_np
from ..math.preintegration import preintegrate_encoder
from ..solvers.motion_ba import PoseObs, pose_optimization_with_prior
from ..system import System
from ..utils.cuda_graph import GraphedCall
from ..utils.metrics import metrics


@dataclasses.dataclass
class EncoderConfig:
    enc_half_track: float = 0.28     # Encoder.rc
    enc_sigma_v: float = 0.01        # wheel-speed noise density
    window_cap: int = 64             # samples per frame gap
    # body-from-encoder extrinsic Tbe; None = identity / zero
    enc_Rbe: object = None
    enc_tbe: object = None
    fuse: bool = True                # joint vision + encoder motion solve
    # Floor on the prior's per-axis std (wheel slip, track-width and
    # extrinsic error), so that a near-noiseless preintegration cannot
    # out-vote vision.
    min_sigma_rot: float = 2e-3      # rad
    min_sigma_trans: float = 2e-3    # m
    # Wait up to this many wall-clock seconds for wheel samples covering
    # the frame; a window still short after it is zero-order-hold filled.
    delay_for_polling: float = 0.02
    odom_gap_tol: float = 0.02
    # The full anisotropic 6x6 preintegrated covariance transported into
    # the camera tangent (a differential drive is tight laterally and in
    # yaw, loose along the travel under slip); False collapses it to the
    # worst axis of each block.
    full_cov: bool = True


class EncoderFrontend:
    """System wrapper adding wheel-encoder fusion (VEO, no IMU)."""

    def __init__(self, system: System, Rcb=None, tcb=None,
                 cfg: Optional[EncoderConfig] = None):
        self.sys = system
        self.device = system.device
        self.cfg = cfg or EncoderConfig()
        self.Rcb = np.eye(3, dtype=np.float32) if Rcb is None else \
            np.asarray(Rcb, np.float32)
        self.tcb = np.zeros(3, np.float32) if tcb is None else \
            np.asarray(tcb, np.float32)
        self.Rbe = np.eye(3, dtype=np.float32) if self.cfg.enc_Rbe is None \
            else np.asarray(self.cfg.enc_Rbe, np.float32)
        self.tbe = np.zeros(3, np.float32) if self.cfg.enc_tbe is None \
            else np.asarray(self.cfg.enc_tbe, np.float32)
        self.enc_ring = NativeOdomRing(1 << 14)
        self.last_t: Optional[float] = None
        self._last_body: Optional[tuple] = None   # (R_wb, p_wb)
        self._pred: Optional[tuple] = None        # (Rcw, tcw, info6)
        # The fused solve, replayed from a CUDA graph on a GPU.
        self._fused = GraphedCall(self._solve)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    # ------------------------------------------------------------------

    def track_encoder(self, t: float, v_left: float, v_right: float):
        """Queue one wheel-speed sample (m/s, left and right)."""
        v = np.zeros(6, np.float32)
        v[0], v[1] = v_left, v_right
        self.enc_ring.push(t, v)

    # ------------------------------------------------------------------

    def _body_from_tracker(self):
        """The body pose of the tracker's camera pose: T_wb = T_wc T_cb."""
        tr = self.sys.tracker
        Rwc = tr.Rcw.T
        twc = -Rwc @ tr.tcw
        R_wb = Rwc @ self.Rcb
        p_wb = Rwc @ self.tcb + twc
        return R_wb.astype(np.float32), p_wb.astype(np.float32)

    def _predict(self, t0: float, t1: float):
        """Encoder dead reckoning T_w_bj = T_w_bi T_be dT_e T_be^-1 and the
        prior information of the fused solve.  Returns (Rcw_pred, tcw_pred,
        info6 [rho, phi]) or None when the window holds no sample or does
        not fit."""
        cfg = self.cfg
        if not self.enc_ring.wait_until(t1 - cfg.odom_gap_tol,
                                        cfg.delay_for_polling):
            metrics.count("enc_poll_timeout")
        ev, edts, emask, n, lag = self.enc_ring.window_filled(
            t0, t1, cfg.window_cap, tail_tol=cfg.odom_gap_tol)
        if lag > 0:
            metrics.count("enc_window_zoh_filled")
        if n == 0 or n > cfg.window_cap:
            return None
        ev, edts, emask = trim_padding(ev, edts, emask)
        enc = preintegrate_encoder(
            self._t(ev[:, 0]), self._t(ev[:, 1]), self._t(edts),
            cfg.enc_half_track, cfg.enc_sigma_v,
            mask=torch.from_numpy(emask).to(self.device))
        dR_e = enc.dR.cpu().numpy()
        dp_e = enc.dp.cpu().numpy()
        cov = enc.cov.cpu().numpy()            # 6x6, (phi, p) order
        R_i, p_i = self._last_body
        Rbe, tbe = self.Rbe, self.tbe
        R_j = R_i @ Rbe @ dR_e @ Rbe.T
        p_j = p_i + R_i @ (tbe + Rbe @ dp_e) - R_j @ tbe
        # camera pose: Tcw = T_cb T_bw
        Rcw = self.Rcb @ R_j.T
        tcw = -Rcw @ p_j + self.tcb
        if cfg.full_cov:
            # The delta's (phi, p) covariance lives in the tangent at the
            # interval-start encoder frame E_i; a left perturbation xi of
            # the delta maps to the camera-left tangent of the prior
            # residual r = log(Tcw T_prior^-1) as -Ad_{T_cj_ei} xi, so
            # Sigma_c = Ad Sigma_xi Ad^T with T_cj_ei = Tcw_j T_w_bi T_be.
            # The model-error floor is added as a per-axis variance.
            Pm = np.zeros((6, 6), np.float64)  # (phi, p) -> (rho, phi)
            Pm[:3, :3] = cov[3:, 3:]
            Pm[:3, 3:] = cov[3:, :3]
            Pm[3:, :3] = cov[:3, 3:]
            Pm[3:, 3:] = cov[:3, :3]
            R_ce = Rcw @ (R_i @ Rbe)
            t_ce = Rcw @ (p_i + R_i @ tbe) + tcw
            hat_t = np.array([[0, -t_ce[2], t_ce[1]],
                              [t_ce[2], 0, -t_ce[0]],
                              [-t_ce[1], t_ce[0], 0]], np.float64)
            Ad = np.zeros((6, 6), np.float64)
            Ad[:3, :3] = R_ce
            Ad[3:, 3:] = R_ce
            Ad[:3, 3:] = hat_t @ R_ce
            Sig = Ad @ Pm @ Ad.T
            Sig[:3, :3] += np.eye(3) * cfg.min_sigma_trans ** 2
            Sig[3:, 3:] += np.eye(3) * cfg.min_sigma_rot ** 2
            info = np.linalg.inv(Sig).astype(np.float32)
            info = 0.5 * (info + info.T)       # inversion round-off
        else:
            # Worst axis of each block, the floor as a replacement.
            var_phi = max(float(np.max(np.diag(cov[:3, :3]))),
                          cfg.min_sigma_rot ** 2)
            var_p = max(float(np.max(np.diag(cov[3:, 3:]))),
                        cfg.min_sigma_trans ** 2)
            info = np.diag(np.concatenate([
                np.full(3, 1.0 / var_p), np.full(3, 1.0 / var_phi)])
            ).astype(np.float32)
        return (normalize_rotation_np(Rcw).astype(np.float32),
                tcw.astype(np.float32), info)

    # ------------------------------------------------------------------

    def track_frame(self, frame):
        """Track one frame with the encoder prediction and fusion; the
        wheel samples up to its timestamp should have been given to
        track_encoder first."""
        t = float(frame.timestamp)
        tr = self.sys.tracker
        self._pred = None
        if self.last_t is not None and self._last_body is not None:
            with metrics.timer("veo.predict"):
                pred = self._predict(self.last_t, t)
            if pred is not None:
                tr.external_prediction = pred[:2]
                self._pred = pred

        state = self.sys.track_frame(frame)

        if state.name == "OK" and self.cfg.fuse and self._pred is not None:
            with metrics.timer("veo.fuse"):
                self._fuse(frame)
        if state.name in ("OK", "ODOMOK"):
            self._last_body = self._body_from_tracker()
            self._store_kf_navstate()
        self.last_t = t
        return state

    def _fuse(self, frame):
        """Re-solve the current pose over the tracker's matched
        observations with the wheel delta as an SE(3) prior, and adopt the
        fused pose."""
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
        Rcw_p, tcw_p, info = self._pred
        out = self._fused(self._t(tr.Rcw), self._t(tr.tcw), obs,
                          self._t(Rcw_p), self._t(tcw_p), self._t(info))
        Rcw = out.Rcw.cpu().numpy()
        tcw = out.tcw.cpu().numpy()
        if not (np.isfinite(Rcw).all() and np.isfinite(tcw).all()):
            return
        tr.Rcw = normalize_rotation_np(Rcw)
        tr.tcw = tcw.astype(np.float32)

    def _solve(self, Rcw0, tcw0, obs, R_prior, t_prior, info):
        return pose_optimization_with_prior(
            Rcw0, tcw0, obs, self.sys.cam, self.sys.bf, R_prior, t_prior,
            info, rounds=2, iters_per_round=4)

    def _store_kf_navstate(self):
        """The body pose on a keyframe created this frame (map save/load
        and the NavState trajectory carry it)."""
        k = self.sys.tracker.last_new_kf
        if k is None or self._last_body is None:
            return
        m = self.sys.map
        R_wb, p_wb = self._last_body
        with m.lock:
            m.kf_Rwb[k] = R_wb
            m.kf_pwb[k] = p_wb
