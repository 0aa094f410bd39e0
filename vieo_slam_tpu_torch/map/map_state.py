"""Sparse map state: keyframes, landmarks, observations, covisibility.

Numpy copy of vieo_slam_tpu/map/map_state.py (the port keeps its own copy
so that it never imports the JAX package).  The map is a struct-of-arrays
with fixed capacities and validity masks, owned by the host; pipeline
stages read a consistent snapshot, run their tensor programs on the
device and write results back.  A monotonically increasing `version`
counter is the change signal.

Descriptors stay uint32 here (numpy counts their bits); they cross into
the port's tensors as int32 views of the same bits.

Observations are stored frame-major (`kf_lm_idx[k, i]` = landmark id of
keypoint i in keyframe k, -1 if none) and regrouped landmark-major
([L, O] lists) on demand when building BA problems
(solvers/local_ba.BAProblem).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np


@dataclasses.dataclass
class MapConfig:
    max_keyframes: int = 512
    max_landmarks: int = 20000
    max_kp: int = 1200            # keypoint capacity per keyframe
    max_obs: int = 12             # obs per landmark used in BA
    n_levels: int = 8
    scale_factor: float = 1.2


class MapState:
    """Global sparse map (Map + KeyFrame + MapPoint storage)."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        K, L, N = cfg.max_keyframes, cfg.max_landmarks, cfg.max_kp
        self.version = 0                 # bumped on every structural change
        self.big_change_idx = 0          # loop/GBA-scale changes
        # Host-side map mutex for the async-mapping pipeline (the
        # reference's mMutexMapUpdate, Map.h): held only around SHORT
        # numpy mutation/snapshot sections — never around device solves,
        # which is where the tracking/mapping overlap comes from.
        # Reentrant so the synchronous pipeline can nest freely.
        import threading
        self.lock = threading.RLock()

        # --- keyframes ---
        self.kf_valid = np.zeros(K, bool)
        self.kf_Rcw = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_tcw = np.zeros((K, 3), np.float32)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)

        # NavState (VIO): world-from-body + velocity + biases.
        self.kf_Rwb = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_pwb = np.zeros((K, 3), np.float32)
        self.kf_vwb = np.zeros((K, 3), np.float32)
        self.kf_bg = np.zeros((K, 3), np.float32)
        self.kf_ba = np.zeros((K, 3), np.float32)

        # features
        self.kf_uv = np.zeros((K, N, 2), np.float32)
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)   # stereo right-u
        self.kf_depth = np.full((K, N), -1.0, np.float32)
        self.kf_kp_valid = np.zeros((K, N), bool)
        self.kf_lm_idx = np.full((K, N), -1, np.int32)

        # temporal chain (prev/next kf id), loop edges
        self.kf_prev = np.full(K, -1, np.int32)
        self.kf_next = np.full(K, -1, np.int32)

        # --- landmarks ---
        self.lm_valid = np.zeros(L, bool)
        self.lm_pw = np.zeros((L, 3), np.float32)
        self.lm_desc = np.zeros((L, 8), np.uint32)
        self.lm_normal = np.zeros((L, 3), np.float32)
        self.lm_min_dist = np.zeros(L, np.float32)
        self.lm_max_dist = np.zeros(L, np.float32)
        self.lm_n_obs = np.zeros(L, np.int32)
        self.lm_visible = np.zeros(L, np.int32)   # found/visible ratios
        self.lm_found = np.zeros(L, np.int32)
        self.lm_first_kf = np.full(L, -1, np.int32)
        self.lm_ref_kf = np.full(L, -1, np.int32)

        self._next_kf = 0
        self._next_lm = 0
        # Freed landmark slots available for reuse (erase_landmarks).
        self._lm_free: list[int] = []
        # (version, csr counts) — see _covis_matrix.
        self._covis_cache = None

    # ------------------------------------------------------------------
    # capacity growth (long sequences must not crash at fixed caps)
    # ------------------------------------------------------------------

    def copy(self) -> "MapState":
        """An independent copy of the map, with its own lock and caches."""
        m = MapState(self.cfg)
        for name, value in self.__dict__.items():
            if name not in ("lock", "_covis_cache"):
                setattr(m, name, copy.deepcopy(value))
        return m

    def _grow_keyframes(self, new_K: int):
        K = self.cfg.max_keyframes
        if new_K <= K:
            return

        def grow(a, fill):
            out = np.empty((new_K,) + a.shape[1:], a.dtype)
            out[:K] = a
            out[K:] = fill
            return out

        self.kf_valid = grow(self.kf_valid, False)
        self.kf_Rcw = grow(self.kf_Rcw, np.eye(3, dtype=np.float32))
        self.kf_tcw = grow(self.kf_tcw, 0.0)
        self.kf_timestamp = grow(self.kf_timestamp, 0.0)
        self.kf_frame_id = grow(self.kf_frame_id, -1)
        self.kf_Rwb = grow(self.kf_Rwb, np.eye(3, dtype=np.float32))
        self.kf_pwb = grow(self.kf_pwb, 0.0)
        self.kf_vwb = grow(self.kf_vwb, 0.0)
        self.kf_bg = grow(self.kf_bg, 0.0)
        self.kf_ba = grow(self.kf_ba, 0.0)
        self.kf_uv = grow(self.kf_uv, 0.0)
        self.kf_level = grow(self.kf_level, 0)
        self.kf_desc = grow(self.kf_desc, 0)
        self.kf_ur = grow(self.kf_ur, -1.0)
        self.kf_depth = grow(self.kf_depth, -1.0)
        self.kf_kp_valid = grow(self.kf_kp_valid, False)
        self.kf_lm_idx = grow(self.kf_lm_idx, -1)
        self.kf_prev = grow(self.kf_prev, -1)
        self.kf_next = grow(self.kf_next, -1)
        self.cfg.max_keyframes = new_K

    def _grow_landmarks(self, new_L: int):
        L = self.cfg.max_landmarks
        if new_L <= L:
            return

        def grow(a, fill):
            out = np.empty((new_L,) + a.shape[1:], a.dtype)
            out[:L] = a
            out[L:] = fill
            return out

        self.lm_valid = grow(self.lm_valid, False)
        self.lm_pw = grow(self.lm_pw, 0.0)
        self.lm_desc = grow(self.lm_desc, 0)
        self.lm_normal = grow(self.lm_normal, 0.0)
        self.lm_min_dist = grow(self.lm_min_dist, 0.0)
        self.lm_max_dist = grow(self.lm_max_dist, 0.0)
        self.lm_n_obs = grow(self.lm_n_obs, 0)
        self.lm_visible = grow(self.lm_visible, 0)
        self.lm_found = grow(self.lm_found, 0)
        self.lm_first_kf = grow(self.lm_first_kf, -1)
        self.lm_ref_kf = grow(self.lm_ref_kf, -1)
        self.cfg.max_landmarks = new_L

    # ------------------------------------------------------------------
    # scale info
    # ------------------------------------------------------------------

    @property
    def level_scales(self) -> np.ndarray:
        return self.cfg.scale_factor ** np.arange(self.cfg.n_levels)

    @property
    def inv_sigma2(self) -> np.ndarray:
        """Per-level information weight 1/scale^2 (Frame ScalePyramidInfo)."""
        return (1.0 / self.level_scales ** 2).astype(np.float32)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def keyframe_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def add_keyframe(
        self, *, Rcw, tcw, timestamp, frame_id,
        uv, level, desc, ur, depth, kp_valid, lm_idx,
        navstate=None,
    ) -> int:
        k = self._next_kf
        if k >= self.cfg.max_keyframes:
            self._grow_keyframes(2 * self.cfg.max_keyframes)
        self._next_kf += 1
        n = uv.shape[0]
        self.kf_valid[k] = True
        self.kf_Rcw[k] = Rcw
        self.kf_tcw[k] = tcw
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_uv[k, :n] = uv
        self.kf_level[k, :n] = level
        self.kf_desc[k, :n] = desc
        self.kf_ur[k, :n] = ur
        self.kf_depth[k, :n] = depth
        self.kf_kp_valid[k, :n] = kp_valid
        self.kf_lm_idx[k, :n] = np.where(kp_valid, lm_idx, -1)
        if navstate is not None:
            R, p, v, bg, ba = navstate
            self.kf_Rwb[k], self.kf_pwb[k] = R, p
            self.kf_vwb[k], self.kf_bg[k], self.kf_ba[k] = v, bg, ba
        # temporal chain
        prev = k - 1
        while prev >= 0 and not self.kf_valid[prev]:
            prev -= 1
        if prev >= 0:
            self.kf_prev[k] = prev
            self.kf_next[prev] = k
        # register observations on landmarks
        obs_lms = self.kf_lm_idx[k]
        good = obs_lms >= 0
        np.add.at(self.lm_n_obs, obs_lms[good], 1)
        self.version += 1
        return k

    def erase_keyframe(self, k: int):
        """SetBadFlag equivalent: drop KF, decrement obs, relink chain."""
        assert self.kf_valid[k]
        lms = self.kf_lm_idx[k]
        good = lms >= 0
        np.add.at(self.lm_n_obs, lms[good], -1)
        self.kf_lm_idx[k] = -1
        self.kf_kp_valid[k] = False
        self.kf_valid[k] = False
        p, nx = self.kf_prev[k], self.kf_next[k]
        if p >= 0:
            self.kf_next[p] = nx
        if nx >= 0:
            self.kf_prev[nx] = p
        self.version += 1

    # ------------------------------------------------------------------
    # landmarks
    # ------------------------------------------------------------------

    def n_landmarks(self) -> int:
        return int(self.lm_valid.sum())

    def add_landmarks(self, pw, desc, first_kf, normals=None,
                      min_dist=None, max_dist=None) -> np.ndarray:
        """Bulk-insert landmarks; returns their ids.

        Freed slots (from culling) are reused first; the backing arrays
        grow when fresh capacity runs out — long sequences degrade (via
        culling pressure) instead of crashing."""
        m = pw.shape[0]
        n_reuse = min(len(self._lm_free), m)
        reuse = np.asarray(self._lm_free[:n_reuse], int)
        self._lm_free = self._lm_free[n_reuse:]
        fresh = m - n_reuse
        if self._next_lm + fresh > self.cfg.max_landmarks:
            self._grow_landmarks(
                max(2 * self.cfg.max_landmarks,
                    self._next_lm + fresh))
        ids = np.concatenate([
            reuse, np.arange(self._next_lm, self._next_lm + fresh)])
        self._next_lm += fresh
        self.lm_valid[ids] = True
        self.lm_pw[ids] = pw
        self.lm_desc[ids] = desc
        self.lm_first_kf[ids] = first_kf
        self.lm_ref_kf[ids] = first_kf
        # reused slots carry stale counters — reset them
        self.lm_n_obs[ids] = 0
        self.lm_visible[ids] = 0
        self.lm_found[ids] = 0
        if normals is None:
            self.lm_normal[ids] = 0.0
        if min_dist is None:
            self.lm_min_dist[ids] = 0.0
            self.lm_max_dist[ids] = 0.0
        if normals is not None:
            self.lm_normal[ids] = normals
        if min_dist is not None:
            self.lm_min_dist[ids] = min_dist
            self.lm_max_dist[ids] = max_dist
        self.version += 1
        return ids

    def erase_landmarks(self, ids: np.ndarray):
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        was = self.lm_valid[ids]
        self.lm_valid[ids] = False
        # remove every observation pointing at them
        mask = np.isin(self.kf_lm_idx, ids)
        self.kf_lm_idx[mask] = -1
        self.lm_n_obs[ids] = 0
        self._lm_free.extend(int(i) for i in ids[was])
        self.version += 1

    def replace_landmark(self, old: int, new: int):
        """MapPoint::Replace — redirect observations of `old` to `new`."""
        mask = self.kf_lm_idx == old
        # where the target kf already observes `new`, just drop.
        self.kf_lm_idx[mask] = new
        self.lm_n_obs[new] += int(mask.sum())
        if self.lm_valid[old]:
            self._lm_free.append(int(old))
        self.lm_valid[old] = False
        self.lm_n_obs[old] = 0
        self.lm_found[new] += self.lm_found[old]
        self.lm_visible[new] += self.lm_visible[old]
        self.version += 1

    # ------------------------------------------------------------------
    # observation views
    # ------------------------------------------------------------------

    def landmark_observations(self, lm_ids: np.ndarray, max_obs=None):
        """Group observations landmark-major.

        Returns (obs_kf [M, O], obs_kp [M, O]) int32 with -1 padding, where
        M = len(lm_ids), O = max_obs (cfg.max_obs default).
        """
        O = max_obs or self.cfg.max_obs
        lm_ids = np.asarray(lm_ids, int)
        M = len(lm_ids)
        obs_kf = np.full((M, O), -1, np.int32)
        obs_kp = np.full((M, O), -1, np.int32)
        if M == 0:
            return obs_kf, obs_kp
        # Vectorized group-by: flatten (kf, kp) -> lm, map lm id to its
        # row in lm_ids via a dense lookup, rank within each row by
        # sorted position, scatter ranks < O.
        hi = max(int(self.kf_lm_idx.max(initial=-1)),
                 int(lm_ids.max(initial=-1)))
        pos = np.full(hi + 2, -1, np.int64)
        pos[lm_ids] = np.arange(M)
        valid_kf = self.kf_valid[:, None]
        lms = self.kf_lm_idx
        sel = (lms >= 0) & valid_kf
        k_all, i_all = np.nonzero(sel)
        j_all = pos[lms[k_all, i_all]]
        keep = j_all >= 0
        k_all, i_all, j_all = k_all[keep], i_all[keep], j_all[keep]
        order = np.argsort(j_all, kind="stable")
        j_s, k_s, i_s = j_all[order], k_all[order], i_all[order]
        rank = np.arange(len(j_s)) - np.searchsorted(j_s, j_s)
        fit = rank < O
        obs_kf[j_s[fit], rank[fit]] = k_s[fit]
        obs_kp[j_s[fit], rank[fit]] = i_s[fit]
        return obs_kf, obs_kp

    def update_landmark_geometry(self, lm_ids: np.ndarray):
        """MapPoint maintenance (src/MapPoint.cc):
        ComputeDistinctiveDescriptors (min-median-Hamming representative),
        UpdateNormalAndDepth (mean viewing ray + scale-invariance distance
        band from the reference KF's observation level).

        Vectorized over landmarks x observations; call after landmark
        creation / fuse / BA at keyframe cadence."""
        lm_ids = np.asarray(lm_ids, int)
        lm_ids = lm_ids[self.lm_valid[lm_ids]]
        if lm_ids.size == 0:
            return
        obs_kf, obs_kp = self.landmark_observations(lm_ids)
        M, O = obs_kf.shape
        has = obs_kf >= 0
        kc = np.clip(obs_kf, 0, None)
        ic = np.clip(obs_kp, 0, None)

        # --- distinctive descriptor: min median pairwise distance ------
        desc = self.kf_desc[kc, ic]                     # [M, O, 8] uint32
        x = desc[:, :, None, :] ^ desc[:, None, :, :]
        d = np.bitwise_count(x).sum(-1).astype(np.float32)   # [M, O, O]
        pair_ok = has[:, :, None] & has[:, None, :]
        d = np.where(pair_ok, d, np.nan)
        # rows without an observation get zeros (not all-NaN) and are
        # masked to inf below — keeps nanmedian warning-free.
        med = np.nanmedian(np.where(has[:, :, None], d, 0.0), axis=2)
        med = np.where(has, med, np.inf)
        best = np.nanargmin(np.where(np.isfinite(med), med, 1e9), axis=1)
        any_obs = has.any(axis=1)
        sel = lm_ids[any_obs]
        self.lm_desc[sel] = desc[np.arange(M), best][any_obs]

        # --- normal + scale-invariance band ----------------------------
        Rcw = self.kf_Rcw[kc]                           # [M, O, 3, 3]
        tcw = self.kf_tcw[kc]
        centers = -np.einsum("moji,moj->moi", Rcw, tcw)
        rays = self.lm_pw[lm_ids][:, None, :] - centers
        norms = np.linalg.norm(rays, axis=-1)
        rays = rays / np.maximum(norms, 1e-9)[..., None]
        w = has.astype(np.float32)
        normal = (rays * w[..., None]).sum(1) / np.maximum(
            w.sum(1), 1.0)[:, None]
        nn = np.linalg.norm(normal, axis=-1)
        normal = normal / np.maximum(nn, 1e-9)[:, None]
        self.lm_normal[sel] = normal[any_obs].astype(np.float32)

        # reference KF = first observation; its level sets the band
        ref_k = kc[np.arange(M), np.argmax(has, axis=1)]
        ref_i = ic[np.arange(M), np.argmax(has, axis=1)]
        dist = norms[np.arange(M), np.argmax(has, axis=1)]
        lvl = self.kf_level[ref_k, ref_i]
        scales = self.level_scales
        max_d = dist * scales[np.clip(lvl, 0, len(scales) - 1)]
        min_d = max_d / scales[-1]
        self.lm_max_dist[sel] = max_d[any_obs].astype(np.float32)
        self.lm_min_dist[sel] = min_d[any_obs].astype(np.float32)

    def predict_scale(self, lm_ids: np.ndarray,
                      cam_center: np.ndarray) -> np.ndarray:
        """MapPoint::PredictScale — expected pyramid octave of each
        landmark when viewed from `cam_center`."""
        lm_ids = np.asarray(lm_ids, int)
        dist = np.linalg.norm(self.lm_pw[lm_ids] - cam_center, axis=-1)
        max_d = np.maximum(self.lm_max_dist[lm_ids], 1e-6)
        ratio = np.maximum(max_d / np.maximum(dist, 1e-6), 1e-6)
        lvl = np.ceil(np.log(ratio) / np.log(self.cfg.scale_factor) - 1e-5)
        return np.clip(lvl, 0, self.cfg.n_levels - 1).astype(np.int32)

    def _covis_matrix(self):
        """Full pairwise shared-landmark count matrix (sparse CSR),
        cached by version.

        Replaces the per-call O(K·N) membership scan the round-2 review
        flagged as quadratic at loop-closing time (one covisibility query
        per candidate per keyframe): one sparse A·Aᵀ on the binary
        keyframe×landmark incidence per map version, O(nnz) per query
        afterwards — the incremental-counts equivalent of the reference's
        KeyFrame::UpdateConnections bookkeeping."""
        if self._covis_cache is not None \
                and self._covis_cache[0] == self.version:
            return self._covis_cache[1]
        import scipy.sparse as sp

        sel = (self.kf_lm_idx >= 0) & self.kf_valid[:, None]
        k_idx, kp_idx = np.nonzero(sel)
        lm = self.kf_lm_idx[k_idx, kp_idx]
        keep = self.lm_valid[lm]
        k_idx, lm = k_idx[keep], lm[keep]
        K = self.kf_lm_idx.shape[0]
        L = self.lm_valid.shape[0]
        # binary incidence (duplicate observations of one landmark in a
        # KF count once — the reference counts distinct MapPoints)
        key = k_idx.astype(np.int64) * L + lm
        uniq = np.unique(key)
        A = sp.csr_matrix(
            (np.ones(len(uniq), np.int32),
             (uniq // L, uniq % L)), shape=(K, L))
        C = (A @ A.T).tocsr()
        self._covis_cache = (self.version, C)
        return C

    def covisible_keyframes(self, k: int, min_shared: int = 15):
        """Weighted covisibility neighbours of keyframe k
        (KeyFrame::UpdateConnections semantics: >= 15 shared landmarks).

        Returns (kf_ids sorted by weight desc, weights)."""
        C = self._covis_matrix()
        row = C.getrow(k)
        counts = np.zeros(self.kf_lm_idx.shape[0], np.int64)
        counts[row.indices] = row.data
        counts[k] = 0
        counts[~self.kf_valid] = 0
        ids = np.nonzero(counts >= min_shared)[0]
        if ids.size == 0 and counts.max() > 0:  # keep the best one anyway
            ids = np.asarray([counts.argmax()])
        order = np.argsort(-counts[ids], kind="stable")
        return ids[order], counts[ids[order]]

    def landmarks_in_keyframes(self, kf_ids) -> np.ndarray:
        lms = np.unique(self.kf_lm_idx[np.asarray(kf_ids, int)])
        return lms[(lms >= 0)]

    # ------------------------------------------------------------------
    # BA bridges
    # ------------------------------------------------------------------

    def build_ba_problem(self, window_kfs, fixed_kfs, lm_ids):
        """Assemble the padded arrays for solvers.local_ba.BAProblem.

        window_kfs: optimized keyframes; fixed_kfs: pose-fixed ring.
        Keyframe indices in the problem are [window..., fixed...].
        Returns (problem_dict, kf_order, lm_ids) — caller wraps into
        tensors to keep this module device-free.
        """
        kf_order = np.concatenate([np.asarray(window_kfs, int),
                                   np.asarray(fixed_kfs, int)])
        K = len(kf_order)
        loc = np.full(len(self.kf_valid), -1, np.int32)
        loc[kf_order] = np.arange(K, dtype=np.int32)
        obs_kf, obs_kp = self.landmark_observations(lm_ids)
        M, O = obs_kf.shape
        kc = np.clip(obs_kf, 0, None)
        ic = np.clip(obs_kp, 0, None)
        obs_local = np.where(obs_kf >= 0, loc[kc], -1).astype(np.int32)
        obs_valid = obs_local >= 0
        obs_uv = np.where(obs_valid[..., None],
                          self.kf_uv[kc, ic], 0.0).astype(np.float32)
        obs_ur = np.where(obs_valid, self.kf_ur[kc, ic],
                          -1.0).astype(np.float32)
        obs_is2 = np.where(
            obs_valid, self.inv_sigma2[self.kf_level[kc, ic]],
            1.0).astype(np.float32)
        fixed = np.zeros(K, bool)
        fixed[len(window_kfs):] = True
        prob = dict(
            Rcw=self.kf_Rcw[kf_order], tcw=self.kf_tcw[kf_order],
            fixed=fixed,
            pw=self.lm_pw[lm_ids], lm_valid=self.lm_valid[lm_ids],
            obs_kf=obs_local, obs_uv=obs_uv, obs_ur=obs_ur,
            obs_inv_sigma2=obs_is2, obs_valid=obs_valid,
        )
        return prob, kf_order, np.asarray(lm_ids)

    def apply_gauge_correction(self, kfs, R_old_cw, t_old_cw):
        """Carry the NavState along a per-KF camera-pose rewrite.

        After loop correction / GBA moves `kf_Rcw/kf_tcw`, every
        world-frame quantity rigidly attached to the keyframe must follow
        the same gauge change T_delta = Twc_new @ Tcw_old (the reference
        updates NavStates alongside poses in CorrectLoop,
        src/LoopClosing.cc:535-627, and in GBA propagation :779-824).
        Called AFTER the new camera poses are stored, with the pre-rewrite
        poses passed in.  Rotates body rotation and velocity by
        dR_w = Rcw_new^T @ Rcw_old and moves the body position as a point.
        Biases are gauge-invariant.
        """
        kfs = np.asarray(kfs, int)
        if kfs.size == 0:
            return
        R_new = self.kf_Rcw[kfs]                       # [K, 3, 3]
        t_new = self.kf_tcw[kfs]
        dRw = np.einsum("kji,kjl->kil", R_new, R_old_cw)   # Rcw_new^T Rcw_old
        self.kf_vwb[kfs] = np.einsum(
            "kij,kj->ki", dRw, self.kf_vwb[kfs]).astype(np.float32)
        self.kf_Rwb[kfs] = np.einsum(
            "kij,kjl->kil", dRw, self.kf_Rwb[kfs]).astype(np.float32)
        # point transform: p' = Rcw_new^T (Rcw_old p + tcw_old - tcw_new)
        pc = np.einsum("kij,kj->ki", R_old_cw, self.kf_pwb[kfs]) + t_old_cw
        self.kf_pwb[kfs] = np.einsum(
            "kji,kj->ki", R_new, pc - t_new).astype(np.float32)

    def apply_ba_result(self, kf_order, lm_ids, Rcw, tcw, pw,
                        n_free: int) -> bool:
        """Write optimized poses/points back (under 'map update').

        Non-finite results are rejected wholesale (a diverged solve must
        not poison the map — the reference's equivalent safety is its
        forced-on asserts, mlog/log.h:14-22). Returns False if rejected."""
        if not (np.isfinite(Rcw[:n_free]).all()
                and np.isfinite(tcw[:n_free]).all()):
            return False
        free = kf_order[:n_free]
        from ..math.lie import normalize_rotation_np

        R_old = self.kf_Rcw[free].copy()
        t_old = self.kf_tcw[free].copy()
        # BA iterates dR@R retractions in f32; re-project onto SO(3)
        # before the poses become long-lived state (see
        # normalize_rotation_np for the amplification mechanism).
        self.kf_Rcw[free] = normalize_rotation_np(Rcw[:n_free])
        self.kf_tcw[free] = tcw[:n_free]
        self.apply_gauge_correction(free, R_old, t_old)
        pw_ok = np.isfinite(pw).all(axis=1)
        self.lm_pw[lm_ids[pw_ok]] = pw[pw_ok]
        if not pw_ok.all():
            self.erase_landmarks(lm_ids[~pw_ok])
        self.version += 1
        return True
