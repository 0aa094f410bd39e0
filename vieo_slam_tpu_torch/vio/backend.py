"""VIO backend: PRV sliding-window local BA and the PRV global / init BA.

Port of vieo_slam_tpu/vio/backend.py: problems are assembled on the host
from the MapState (numpy, under map.lock), solved on the device by
solvers/vio_local_ba.vio_ba (a plain call), and written back under the
lock.  IMU chains between consecutive keyframes are re-preintegrated from
the front end's odometry ring at each i-side keyframe's bias, all chains
in one batched preintegration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..io.odom_ring import trim_padding
from ..map.map_state import MapState
from ..math.lie import normalize_rotation_np
from ..math.navstate import NavState, tcw_from_navstate
from ..math.preintegration import (EncPreint, preintegrate_encoder,
                                   preintegrate_imu)
from ..solvers.vio_local_ba import (VioBAConfig, VioBAProblem,
                                    chain_blocks_graph, vio_ba)
from ..utils.device import resolve_device


@dataclasses.dataclass
class VioBackendConfig:
    window_size: int = 10         # temporal window
    fixed_covis: int = 12         # covisible fixed-pose keyframes cap
    chain_sample_cap: int = 256   # IMU samples per keyframe-keyframe chain
    sigma_g: float = 1.7e-4
    sigma_a: float = 2e-3
    sigma_bg_rw: float = 2e-4
    sigma_ba_rw: float = 2e-3
    kf_pad: int = 4
    lm_pad: int = 1024
    stage_iters: tuple = (4, 6)
    gba_stage_iters: tuple = (6, 10)
    # Zero-mean bias prior on the newest window keyframe of the local BA
    # (it spreads through the stiff bias random-walk chains): bounds the
    # bias components that low-excitation segments leave unobservable.
    window_prior_sigma_bg: float = 0.02
    window_prior_sigma_ba: float = 0.12


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                  constant_values=fill)


class VioBackend:
    """Builds and runs NavState-window BAs against the MapState."""

    def __init__(self, map_state: MapState, cam, bf: float, ring, Rcb, tcb,
                 cfg: Optional[VioBackendConfig] = None, enc_ring=None,
                 Rbe=None, tbe=None, enc_half_track: float = 0.28,
                 enc_sigma_v: float = 0.01, device=None):
        self.device = resolve_device(device)
        self.map = map_state
        self.cam = cam
        self.bf = float(bf)
        self.ring = ring                    # an io.odom_ring ring (IMU)
        self.enc_ring = enc_ring
        self.Rcb = np.asarray(Rcb, np.float32)
        self.tcb = np.asarray(tcb, np.float32)
        self.Rbe = np.eye(3, dtype=np.float32) if Rbe is None else \
            np.asarray(Rbe, np.float32)
        self.tbe = np.zeros(3, np.float32) if tbe is None else \
            np.asarray(tbe, np.float32)
        self._enc_half_track = float(enc_half_track)
        self._enc_sigma_v = float(enc_sigma_v)
        self.cfg = cfg or VioBackendConfig()
        self.gravity = np.array([0, 0, -9.81], np.float32)
        self._chain_graph = chain_blocks_graph()     # vio_ba's `graph`

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device)

    # ------------------------------------------------------------------

    def _navstates(self, kf_ids: np.ndarray):
        """(R, p, v, bg, ba) numpy of the keyframes: R and p from the
        current Tcw (vision BAs move Tcw), v and the biases stored."""
        m = self.map
        Rwc = np.swapaxes(m.kf_Rcw[kf_ids], -1, -2)
        twc = -np.einsum("kij,kj->ki", Rwc, m.kf_tcw[kf_ids])
        tbc = -self.Rcb.T @ self.tcb
        Rwb = Rwc @ self.Rcb
        pwb = np.einsum("kij,j->ki", Rwc, tbc) + twc
        return (Rwb.astype(np.float32), pwb.astype(np.float32),
                m.kf_vwb[kf_ids], m.kf_bg[kf_ids], m.kf_ba[kf_ids])

    def _windows(self, ring, kf_ids: np.ndarray, channels: int):
        """Padded sample windows between consecutive kf_ids: (vals [C, T,
        channels], dts [C, T], mask [C, T], valid [C])."""
        m = self.map
        T = self.cfg.chain_sample_cap
        C = len(kf_ids) - 1
        vals = np.zeros((C, T, channels), np.float32)
        dts = np.zeros((C, T), np.float32)
        mask = np.zeros((C, T), bool)
        valid = np.zeros(C, bool)
        for c in range(C):
            v, d, mk, n = ring.window(float(m.kf_timestamp[kf_ids[c]]),
                                      float(m.kf_timestamp[kf_ids[c + 1]]), T)
            if n == 0 or n > T:
                continue
            vals[c], dts[c], mask[c] = v[:, :channels], d, mk
            valid[c] = True
        return (*trim_padding(vals, dts, mask), valid)

    def _chains(self, kf_ids: np.ndarray):
        """Batched IMU preintegrations between consecutive kf_ids, at each
        i-side keyframe's bias, and their validity."""
        m = self.map
        vals, dts, mask, valid = self._windows(self.ring, kf_ids, 6)
        bg = np.where(valid[:, None], m.kf_bg[kf_ids[:-1]], 0.0)
        ba = np.where(valid[:, None], m.kf_ba[kf_ids[:-1]], 0.0)
        pre = preintegrate_imu(
            self._t(vals[..., :3]), self._t(vals[..., 3:]), self._t(dts),
            self._t(bg, torch.float32), self._t(ba, torch.float32),
            self.cfg.sigma_g, self.cfg.sigma_a, mask=self._t(mask))
        return pre, valid

    def _enc_chains(self, window: np.ndarray, C: int):
        """Encoder preintegrations of the window's chains (identity with
        enc_valid False where there are none)."""
        enc = EncPreint(
            dR=self._t(np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))),
            dp=self._t(np.zeros((C, 3), np.float32)),
            cov=self._t(np.tile(np.eye(6, dtype=np.float32), (C, 1, 1))),
            dt=self._t(np.zeros(C, np.float32)))
        enc_valid = np.zeros(C, bool)
        if self.enc_ring is None or len(window) < 2:
            return enc, enc_valid
        vals, dts, mask, valid = self._windows(self.enc_ring, window, 2)
        enc_valid[:len(valid)] = valid
        if valid.any():
            vals = _pad_rows(vals, C)
            enc = preintegrate_encoder(
                self._t(vals[..., 0]), self._t(vals[..., 1]),
                self._t(_pad_rows(dts, C)), self._enc_half_track,
                self._enc_sigma_v, mask=self._t(_pad_rows(mask, C)))
        return enc, enc_valid

    # ------------------------------------------------------------------

    def _build(self, window: np.ndarray, fixed_pr_kfs: np.ndarray,
               lm_ids: np.ndarray, *, prior_bias=None, prior_dt: float = 0.0):
        """A padded VioBAProblem: keyframes [window..., fixed...] (the
        window time-ordered, its anchor first), chains along the window.
        Returns (problem, keyframe order, landmark ids, fixed_pr, fixed_vb,
        chain_i) with the masks as numpy for the caller to adjust."""
        m = self.map
        cfg = self.cfg
        kf_order = np.concatenate([window, fixed_pr_kfs]).astype(int)
        K = len(kf_order)
        Kp = -(-K // cfg.kf_pad) * cfg.kf_pad
        prob_np, _, lm_ids = m.build_ba_problem(window, fixed_pr_kfs, lm_ids)
        M = prob_np["pw"].shape[0]
        Mp = -(-M // cfg.lm_pad) * cfg.lm_pad

        R, p, v, bg, ba = self._navstates(kf_order)
        R_p = _pad_rows(R, Kp)
        R_p[K:] = np.eye(3, dtype=np.float32)
        z = np.zeros((Kp, 3), np.float32)
        ns = NavState(R=self._t(R_p), p=self._t(_pad_rows(p, Kp)),
                      v=self._t(_pad_rows(v, Kp)),
                      bg=self._t(_pad_rows(bg, Kp)),
                      ba=self._t(_pad_rows(ba, Kp)), dbg=self._t(z),
                      dba=self._t(z))

        fixed_pr = np.ones(Kp, bool)
        fixed_pr[:len(window)] = False
        # Gauge: the first window keyframe is fixed unless a covisible
        # fixed ring holds the gauge.
        fixed_pr[0] = len(fixed_pr_kfs) == 0
        fixed_vb = np.ones(Kp, bool)
        fixed_vb[:len(window)] = False

        pre, cvalid = self._chains(window)
        C = len(window) - 1
        Cp = max(C, 1)
        chain_i = np.arange(Cp)
        if C == 0:
            cvalid = np.zeros(1, bool)
            pre = type(pre)(*(torch.zeros((1,) + x.shape[1:], dtype=x.dtype,
                                          device=x.device) for x in pre))
        enc_pre, enc_valid = self._enc_chains(window, Cp)

        if prior_bias is not None:
            dt = max(prior_dt, 1e-3)
            info6 = np.concatenate([
                np.full(3, 1.0 / (cfg.sigma_bg_rw ** 2 * dt)),
                np.full(3, 1.0 / (cfg.sigma_ba_rw ** 2 * dt))])
        else:
            info6 = np.zeros(6)

        prob = VioBAProblem(
            ns=ns, fixed_pr=None, fixed_vb=None,
            pw=self._t(_pad_rows(prob_np["pw"], Mp)),
            lm_valid=self._t(_pad_rows(prob_np["lm_valid"], Mp, False)),
            obs_kf=self._t(_pad_rows(prob_np["obs_kf"], Mp, -1)),
            obs_uv=self._t(_pad_rows(prob_np["obs_uv"], Mp)),
            obs_ur=self._t(_pad_rows(prob_np["obs_ur"], Mp, -1.0)),
            obs_inv_sigma2=self._t(_pad_rows(prob_np["obs_inv_sigma2"], Mp,
                                             1.0)),
            obs_valid=self._t(_pad_rows(prob_np["obs_valid"], Mp, False)),
            chain_i=self._t(chain_i), chain_j=self._t(chain_i + 1),
            chain_valid=self._t(cvalid), chain_weight=None,
            imu_pre=pre, enc_pre=enc_pre, enc_valid=self._t(enc_valid),
            prior_idx=0, prior_info6=self._t(info6, torch.float32))
        return prob, kf_order, lm_ids, fixed_pr, fixed_vb, chain_i

    def _finish(self, prob: VioBAProblem, fixed_pr, fixed_vb,
                weight_vb, chain_i, **kw) -> VioBAProblem:
        """Set the masks and the chain weights: chains whose i-side
        velocity and bias are held in `weight_vb` get 1e-2, else the
        solver explains the held state's error with a fictitious
        accelerometer bias."""
        cw = np.where(weight_vb[chain_i], 1e-2, 1.0)
        return prob._replace(fixed_pr=self._t(fixed_pr),
                             fixed_vb=self._t(fixed_vb),
                             chain_weight=self._t(cw, torch.float32), **kw)

    def _solve_cfg(self) -> VioBAConfig:
        return VioBAConfig(
            Rcb=self._t(self.Rcb), tcb=self._t(self.tcb),
            bf=torch.tensor(self.bf, dtype=torch.float32, device=self.device),
            gravity=self._t(self.gravity), sigma_bg_rw=self.cfg.sigma_bg_rw,
            sigma_ba_rw=self.cfg.sigma_ba_rw, Rbe=self._t(self.Rbe),
            tbe=self._t(self.tbe))

    def _apply(self, res, kf_order, lm_ids, n_free: int) -> bool:
        """Write the optimized states back (Tcw and the NavState fields);
        False, and nothing written, if they are not finite."""
        m = self.map
        R, p, v = (x[:n_free].cpu().numpy() for x in res.ns[:3])
        if not (np.isfinite(p).all() and np.isfinite(R).all()
                and np.isfinite(v).all()):
            return False
        Rcw, tcw = tcw_from_navstate(res.ns, self._t(self.Rcb),
                                     self._t(self.tcb))
        bg = (res.ns.bg + res.ns.dbg)[:n_free].cpu().numpy()
        ba = (res.ns.ba + res.ns.dba)[:n_free].cpu().numpy()
        free = kf_order[:n_free]
        m.kf_Rcw[free] = normalize_rotation_np(Rcw[:n_free].cpu().numpy())
        m.kf_tcw[free] = tcw[:n_free].cpu().numpy()
        m.kf_Rwb[free] = normalize_rotation_np(R)
        m.kf_pwb[free] = p
        m.kf_vwb[free] = v
        m.kf_bg[free] = bg
        m.kf_ba[free] = ba
        pw = res.pw[:len(lm_ids)].cpu().numpy()
        pw_ok = np.isfinite(pw).all(axis=1)
        m.lm_pw[lm_ids[pw_ok]] = pw[pw_ok]
        m.version += 1
        return True

    # ------------------------------------------------------------------

    def run_local_ba(self, k: int) -> bool:
        """PRV sliding-window local BA around keyframe k: the temporal
        window of its predecessors (the oldest fully fixed), a covisible
        fixed-pose ring, and the zero-mean bias prior on k.  The problem
        build and the write-back hold map.lock; the solve does not."""
        m = self.map
        cfg = self.cfg
        with m.lock:
            window = [k]
            cur = k
            while len(window) < cfg.window_size + 1:
                p = int(m.kf_prev[cur])
                if p < 0:
                    break
                window.append(p)
                cur = p
            window = np.asarray(window[::-1], int)   # oldest first
            if len(window) < 3:
                return False
            lm_ids = m.landmarks_in_keyframes(window)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 10:
                return False
            obs_any = np.isin(m.kf_lm_idx, lm_ids) & (m.kf_lm_idx >= 0)
            ring = np.nonzero(obs_any.any(axis=1) & m.kf_valid)[0]
            ring = np.setdiff1d(ring, window)[:cfg.fixed_covis]
            prob, kf_order, lm_ids, fixed_pr, fixed_vb, chain_i = \
                self._build(window, ring, lm_ids)
        n_window = len(window)
        # The oldest window keyframe is the temporal anchor: pose, velocity
        # and bias all held.
        fixed_pr[0] = True
        fixed_vb[0] = True
        info6 = np.concatenate([
            np.full(3, 1.0 / cfg.window_prior_sigma_bg ** 2),
            np.full(3, 1.0 / cfg.window_prior_sigma_ba ** 2)])
        prob = self._finish(prob, fixed_pr, fixed_vb, fixed_vb, chain_i,
                            prior_idx=n_window - 1,
                            prior_info6=self._t(info6, torch.float32))
        res = vio_ba(prob, self.cam, self._solve_cfg(),
                     stage_iters=cfg.stage_iters,
                     use_enc=self.enc_ring is not None, graph=self._chain_graph)
        with m.lock:
            return self._apply(res, kf_order, lm_ids, n_free=n_window)

    def run_global_ba(self, *, opt_scale=False, opt_gdir=False,
                      init_prior=False) -> bool:
        """PRV global BA over all keyframes; with opt_scale / opt_gdir and
        the initial-bias prior, the VI-init follow-up BA."""
        m = self.map
        with m.lock:
            kfs = m.keyframe_ids()
            if len(kfs) < 4:
                return False
            lm_ids = m.landmarks_in_keyframes(kfs)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 10:
                return False
            prior_bias, prior_dt = None, 0.0
            if init_prior:
                prior_bias = np.concatenate([m.kf_bg[kfs[0]], m.kf_ba[kfs[0]]])
                prior_dt = float(m.kf_timestamp[kfs[-1]]
                                 - m.kf_timestamp[kfs[0]])
            prob, kf_order, lm_ids, fixed_pr, fixed_vb, chain_i = \
                self._build(kfs, np.zeros(0, int), lm_ids,
                            prior_bias=prior_bias, prior_dt=prior_dt)
        # Gauge: the first keyframe's pose is held; its velocity and bias
        # float only in init mode.  The chain weights keep the build's
        # masks, under which every window chain floats.
        weight_vb = fixed_vb.copy()
        fixed_pr[0] = True
        fixed_vb[0] = not init_prior
        prob = self._finish(prob, fixed_pr, fixed_vb, weight_vb, chain_i)
        res = vio_ba(prob, self.cam, self._solve_cfg(),
                     stage_iters=self.cfg.gba_stage_iters,
                     opt_scale=opt_scale, opt_gdir=opt_gdir,
                     use_enc=self.enc_ring is not None, graph=self._chain_graph)
        with m.lock:
            if not self._apply(res, kf_order, lm_ids, n_free=len(kfs)):
                return False
            s = float(res.scale)
            if opt_scale and np.isfinite(s) and abs(s - 1.0) > 1e-4:
                # The solver's scale gauge: p_metric = s * p_visual.
                m.lm_pw[m.lm_valid] *= s
                m.kf_tcw[m.kf_valid] *= s
                m.kf_pwb[m.kf_valid] *= s
                m.version += 1
            if opt_gdir:
                self.gravity = res.gravity.cpu().numpy().astype(np.float32)
            m.big_change_idx += 1
        return True
