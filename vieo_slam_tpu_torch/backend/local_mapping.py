"""Local mapping: keyframe processing, landmark creation/culling, local BA.

Port of vieo_slam_tpu/backend/local_mapping.py (process_keyframe),
run synchronously after keyframe insertion: create close landmarks from
stereo depth (after fusing existing ones, kernel B4), triangulate against
covisible keyframes (kernel B3), cull probation landmarks, run the
windowed BA, cull redundant keyframes.  Window selection and bookkeeping
are host-side numpy; the heavy steps run on the mapper's device.  Global
BA (`run_global_ba`) runs after a loop closure and at shutdown: the
single-device chunked solve or, over a mesh of several shards, the
landmark-sharded distributed solve of parallel/dist_ba.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cameras import models as cm
from ..frontend.frame import desc_to_tensor
from ..map.map_state import MapState
from ..ops import matching
from ..parallel.dist_ba import distributed_ba, make_ba_mesh, pad_landmarks
from ..math.lie import normalize_rotation_np
from ..solvers.local_ba import BAProblem, landmark_refit_chi2, local_ba
from ..utils.device import resolve_device
from ..utils.metrics import metrics
from .triangulation import triangulate_pair


@dataclasses.dataclass
class LocalMappingConfig:
    window_size: int = 8          # optimized covisible KFs
    fixed_ring: int = 8           # pose-fixed first-ring cap
    max_new_points: int = 300     # per-KF new landmark cap (close stereo)
    close_depth: float = 4.0      # depth gate for direct stereo creation
    triangulate_neighbors: int = 4  # KF pairs tried per new KF
    cull_min_found_ratio: float = 0.25
    cull_obs_window: int = 3      # KFs within which a LM must earn >=3 obs
    ba_kf_pad: int = 4            # pad K to a multiple
    ba_lm_pad: int = 1024         # pad M to a multiple
    kf_cull_redundancy: float = 0.9
    kf_cull_max_per_pass: int = 1   # at most N culled per new KF
    kf_cull_min_age: int = 6        # never cull the most recent KFs
    kf_cull_min_map: int = 16       # keep small maps intact
    # Never cull a KF whose removal leaves a temporal hole longer than
    # this between its chain neighbours (seconds).
    kf_cull_max_gap: float = 2.0
    # Pre-GBA moving-object cull: erase landmarks whose refit median chi2
    # exceeds this (no single static 3D point explains their observations;
    # static landmarks refit to chi2 ~1, moving ones to hundreds).  0
    # disables.
    gba_moving_cull_chi2: float = 20.0
    gba_moving_cull_min_obs: int = 4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class LocalMapper:
    def __init__(self, cam: cm.Camera, bf: float, map_state: MapState,
                 cfg: LocalMappingConfig | None = None, device=None,
                 ba_mesh=None):
        self.cam = cam
        self.bf = float(bf)
        self.map = map_state
        self.cfg = cfg or LocalMappingConfig()
        self.device = resolve_device(device)
        # The global BA's parallel.dist_ba.BAMesh (in-process).  None: the
        # mapper's own device alone, so the global BA runs the single-device
        # solve.  Unlike the JAX package's mapper, which shards over
        # jax.devices(), a GPU mapper does not take every visible GPU
        # unasked: no sharded GBA has been measured faster than one device
        # (PERF.md, the distributed GBA).
        self.ba_mesh = ba_mesh
        self.recent_lms: list[tuple[int, np.ndarray]] = []  # (kf, lm_ids)
        # Set by a VIO front end once its keyframe backend (the PRV window
        # BA of vio/backend.py) takes over from the vision-only local BA.
        self.skip_local_ba = False
        # Set by a VIO front end once odometry is fused: keyframe culling
        # then keeps the temporal gaps that the IMU chains span short.
        self.vio_active = False
        self.vio_timespan_cap = 0.5

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device)

    # ------------------------------------------------------------------

    def process_keyframe(self, k: int):
        """LocalMapping::Run body for one new keyframe."""
        m = self.map
        with metrics.timer("lm.create_points"), m.lock:
            new_ids = self.create_close_landmarks(k)
            tri_ids = self.triangulate_new_landmarks(k)
        new_ids = np.concatenate([new_ids, tri_ids])
        metrics.count("landmarks_created", int(new_ids.size))
        if new_ids.size:
            self.recent_lms.append((k, new_ids))
        with metrics.timer("lm.cull"), m.lock:
            self.cull_landmarks(k)
        if not self.skip_local_ba:
            with metrics.timer("lm.local_ba"):
                self.run_local_ba(k)
        with metrics.timer("lm.kf_cull"), m.lock:
            self.cull_keyframes(k)
        with m.lock:
            touched = m.kf_lm_idx[k]
            m.update_landmark_geometry(touched[touched >= 0])

    # ------------------------------------------------------------------

    def create_close_landmarks(self, k: int) -> np.ndarray:
        """Landmarks from stereo depth for untracked keypoints, after a
        fuse-first pass that lets a keypoint adopt a matching existing
        landmark instead of spawning a duplicate."""
        m = self.map
        depth = m.kf_depth[k]
        self._fuse_into_keyframe(k)
        unassoc = (m.kf_lm_idx[k] < 0) & m.kf_kp_valid[k] & (depth > 0)
        kp_idx = np.nonzero(unassoc)[0]
        if kp_idx.size == 0:
            return np.zeros(0, np.int64)
        order = np.argsort(depth[kp_idx], kind="stable")
        kp_idx = kp_idx[order]
        n_close = int((depth[kp_idx] < self.cfg.close_depth).sum())
        n_take = min(max(n_close, 100), self.cfg.max_new_points)
        kp_idx = kp_idx[:n_take]
        uv = m.kf_uv[k, kp_idx]
        z = depth[kp_idx]
        rays = _np(cm.unproject(self.cam, torch.from_numpy(uv)))
        pc = rays * z[:, None]
        Rwc = m.kf_Rcw[k].T
        pw = pc @ Rwc.T + (-Rwc @ m.kf_tcw[k])
        lm_ids = m.add_landmarks(pw.astype(np.float32), m.kf_desc[k, kp_idx],
                                 first_kf=k)
        m.kf_lm_idx[k, kp_idx] = lm_ids
        np.add.at(m.lm_n_obs, lm_ids, 1)
        m.version += 1
        return lm_ids

    def _fuse_into_keyframe(self, k: int):
        """Associate existing covisible landmarks with this KF's
        still-unmatched keypoints."""
        m = self.map
        neigh, _ = m.covisible_keyframes(k, min_shared=5)
        kfs = np.concatenate([[k], neigh[:10]])
        lm_ids = m.landmarks_in_keyframes(kfs)
        lm_ids = lm_ids[m.lm_valid[lm_ids]]
        already = set(int(x) for x in m.kf_lm_idx[k] if x >= 0)
        lm_ids = np.asarray([l for l in lm_ids if int(l) not in already],
                            dtype=np.int64)
        if lm_ids.size == 0:
            return
        free_kp = (m.kf_lm_idx[k] < 0) & m.kf_kp_valid[k]
        pc = m.lm_pw[lm_ids] @ m.kf_Rcw[k].T + m.kf_tcw[k]
        pc_t = torch.from_numpy(pc.astype(np.float32))
        uv_proj = cm.project(self.cam, pc_t)
        vis = (pc_t[:, 2] > 0.1) & cm.in_image(self.cam, uv_proj, 1.0)
        idx, _ = matching.fuse_candidates(
            uv_proj.to(self.device),
            torch.zeros(len(lm_ids), dtype=torch.int32, device=self.device),
            desc_to_tensor(m.lm_desc[lm_ids], self.device),
            vis.to(self.device),
            self._t(m.kf_uv[k]), self._t(m.kf_level[k]),
            desc_to_tensor(m.kf_desc[k], self.device), self._t(free_kp),
            radius=4.0, level_scales=m.level_scales.astype(np.float32))
        idx = _np(idx)
        ok = idx >= 0
        m.kf_lm_idx[k, idx[ok]] = lm_ids[ok]
        np.add.at(m.lm_n_obs, lm_ids[ok], 1)
        m.version += 1

    def triangulate_new_landmarks(self, k: int) -> np.ndarray:
        """Two-view triangulation vs covisible neighbours."""
        m = self.map
        neigh, _ = m.covisible_keyframes(k, min_shared=5)
        neigh = neigh[: self.cfg.triangulate_neighbors]
        created = []
        scales = self._t(m.level_scales.astype(np.float32))
        is2 = self._t(m.inv_sigma2)
        for n in neigh:
            free_k = (m.kf_lm_idx[k] < 0) & m.kf_kp_valid[k]
            free_n = (m.kf_lm_idx[n] < 0) & m.kf_kp_valid[n]
            if free_k.sum() < 10 or free_n.sum() < 10:
                continue
            res = triangulate_pair(
                self._t(m.kf_Rcw[k]), self._t(m.kf_tcw[k]),
                self._t(m.kf_uv[k]), self._t(m.kf_level[k]),
                desc_to_tensor(m.kf_desc[k], self.device), self._t(free_k),
                self._t(m.kf_Rcw[n]), self._t(m.kf_tcw[n]),
                self._t(m.kf_uv[n]), self._t(m.kf_level[n]),
                desc_to_tensor(m.kf_desc[n], self.device), self._t(free_n),
                is2, scales, self.cam)
            good = _np(res.good)
            kp1 = np.nonzero(good)[0]
            if kp1.size == 0:
                continue
            kp2 = _np(res.kp2)[kp1]
            pw = _np(res.pw)[kp1]
            ids = m.add_landmarks(pw.astype(np.float32), m.kf_desc[k, kp1],
                                  first_kf=k)
            m.kf_lm_idx[k, kp1] = ids
            m.kf_lm_idx[int(n), kp2] = ids
            np.add.at(m.lm_n_obs, ids, 2)
            m.version += 1
            created.append(ids)
        if not created:
            return np.zeros(0, np.int64)
        return np.concatenate(created)

    # ------------------------------------------------------------------

    def cull_landmarks(self, k: int):
        """MapPointCulling, scoped to the probation set: recently created
        landmarks that fail the found ratio or do not earn 3 observations
        within cull_obs_window keyframes are erased."""
        m = self.map
        keep = []
        drop = []
        for kf_born, ids in self.recent_lms:
            age = k - kf_born
            ids = ids[m.lm_valid[ids]]
            if ids.size == 0:
                continue
            vis = m.lm_visible[ids]
            ratio = m.lm_found[ids] / np.maximum(vis, 1)
            bad_r = (vis >= 8) & (ratio < self.cfg.cull_min_found_ratio)
            if bad_r.any():
                drop.append(ids[bad_r])
                ids = ids[~bad_r]
            if age >= self.cfg.cull_obs_window:
                drop.append(ids[m.lm_n_obs[ids] < 3])
            else:
                keep.append((kf_born, ids))
        self.recent_lms = keep
        if drop:
            bad = np.concatenate(drop)
            if bad.size:
                m.erase_landmarks(bad)

    # ------------------------------------------------------------------

    def run_local_ba(self, k: int):
        """Windowed BA around keyframe k (LocalBundleAdjustment)."""
        m = self.map
        cfg = self.cfg
        with m.lock:
            neigh, _ = m.covisible_keyframes(k, min_shared=5)
            window = np.unique(np.concatenate([[k],
                                               neigh[: cfg.window_size - 1]]))
            if m.n_keyframes() <= 2:
                return
            lm_ids = m.landmarks_in_keyframes(window)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 10:
                return
            obs_any = np.isin(m.kf_lm_idx, lm_ids) & (m.kf_lm_idx >= 0)
            ring = np.nonzero(obs_any.any(axis=1) & m.kf_valid)[0]
            ring = np.setdiff1d(ring, window)[: cfg.fixed_ring]
            if ring.size == 0:
                ring = window[:1]
                window = window[1:]
                if window.size == 0:
                    return
            prob_np, kf_order, lm_ids = m.build_ba_problem(window, ring, lm_ids)
        prob = self._pad_problem(prob_np)
        res = local_ba(prob, self.cam, self.bf)
        K, M = len(kf_order), len(lm_ids)
        Rcw = _np(res.Rcw)[:K]
        tcw = _np(res.tcw)[:K]
        pw = _np(res.pw)[:M]
        inl = _np(res.obs_inlier)[:M]
        with m.lock:
            m.apply_ba_result(kf_order, lm_ids, Rcw, tcw, pw,
                              n_free=len(window))
            obs_kf, obs_kp = m.landmark_observations(lm_ids)
            bad = (obs_kf >= 0) & np.isin(obs_kf, kf_order) & ~inl
            mm, oo = np.nonzero(bad)
            if mm.size:
                m.kf_lm_idx[obs_kf[mm, oo], obs_kp[mm, oo]] = -1
                np.add.at(m.lm_n_obs, lm_ids[mm], -1)
                m.version += 1

    def run_global_ba(self, *, stage_iters=(8, 12), distributed=None,
                      abort=None, correction_sinks=None) -> bool:
        """Full-map BA: all keyframes free except the first (gauge), all
        landmarks.  Run after a loop closure and by System.final_global_ba.

        Single device: one solve per stage of `stage_iters`, the outlier
        classification carried from one into the next.  distributed: the
        landmark-sharded solve of parallel.dist_ba over `self.ba_mesh`
        (None: the mapper's device alone), one distributed_ba call per
        stage (its Huber weights re-derived
        every iteration: no chi2 classification is carried across the
        stages).  None = auto: distributed when the mesh has more than one
        shard and the problem at least 8192 padded landmarks; a one-shard
        mesh always runs the single-device solve.  abort: optional
        threading.Event, checked before every stage and before the
        write-back; an aborted GBA discards its result and returns
        False."""
        def aborted():
            return abort is not None and abort.is_set()

        built = self.global_problem()
        if built is None:
            return False
        prob, kf_order, lm_ids, snap_next_kf = built
        K, M = len(kf_order), len(lm_ids)
        mesh = self.ba_mesh if self.ba_mesh is not None \
            else make_ba_mesh([self.device])
        if distributed is None:
            distributed = mesh.size > 1 and prob.pw.shape[0] >= 8192
        if distributed and mesh.size > 1:
            if mesh.group is not None:
                raise ValueError("run_global_ba shards over an in-process "
                                 "mesh, not a process group")
            prob = pad_landmarks(prob, mesh.size)
            for it in stage_iters:
                if aborted():
                    return False
                Rcw, tcw, pw = distributed_ba(prob, self.cam, self.bf, mesh,
                                              iters=it)
                prob = prob._replace(Rcw=Rcw.to(self.device),
                                     tcw=tcw.to(self.device),
                                     pw=pw.to(self.device))
        else:
            active = None
            for it in stage_iters:
                if aborted():
                    return False
                res = local_ba(prob, self.cam, self.bf, stage_iters=(it,),
                               init_active=active)
                prob = prob._replace(Rcw=res.Rcw, tcw=res.tcw, pw=res.pw)
                active = res.obs_inlier
        Rcw = _np(prob.Rcw)[:K]
        tcw = _np(prob.tcw)[:K]
        pw = _np(prob.pw)[:M]
        if aborted():
            return False
        with self.map.lock:
            return self._apply_gba_result(
                kf_order, lm_ids, Rcw, tcw, pw, n_free=K - 1,
                snap_next_kf=snap_next_kf, correction_sinks=correction_sinks)


    def global_problem(self):
        """The global BA's problem, built under map.lock: every keyframe
        (the first fixed) and every valid landmark they observe, padded,
        after the moving-landmark cull (which erases the landmarks it
        finds from the map).  Returns (prob, kf_order, lm_ids,
        snap_next_kf), or None for a map too small to solve."""
        m = self.map
        with m.lock:
            kfs = m.keyframe_ids()
            if len(kfs) < 3:
                return None
            lm_ids = m.landmarks_in_keyframes(kfs)
            lm_ids = lm_ids[m.lm_valid[lm_ids]]
            if lm_ids.size < 10:
                return None
            prob_np, kf_order, lm_ids = m.build_ba_problem(kfs[1:], kfs[:1],
                                                           lm_ids)
            snap_next_kf = m._next_kf
        prob = self._pad_problem(prob_np)
        M = len(lm_ids)
        if self.cfg.gba_moving_cull_chi2 > 0:
            med, n_obs = landmark_refit_chi2(prob, self.cam, self.bf)
            med, n_obs = _np(med)[:M], _np(n_obs)[:M]
            bad = (med > self.cfg.gba_moving_cull_chi2) \
                & (n_obs >= self.cfg.gba_moving_cull_min_obs)
            if bad.any():
                metrics.count("gba_moving_culled", int(bad.sum()))
                with m.lock:
                    m.erase_landmarks(lm_ids[bad])
                mask = np.ones(prob.pw.shape[0], bool)
                mask[:M][bad] = False
                mj = self._t(mask)
                prob = prob._replace(lm_valid=prob.lm_valid & mj,
                                     obs_valid=prob.obs_valid & mj[:, None])
        return prob, kf_order, lm_ids, snap_next_kf

    def _apply_gba_result(self, kf_order, lm_ids, Rcw, tcw, pw, *,
                          n_free: int, snap_next_kf: int,
                          correction_sinks=None) -> bool:
        """GBA write-back, and its propagation to keyframes created while
        the solve ran (re-anchored on their temporal-chain predecessor)
        and to landmarks outside the solved set (moved with their
        reference keyframe).  Every sink gets push_correction(R_old,
        t_old, R_new, t_new) of the newest keyframe.  Caller holds
        map.lock."""
        m = self.map
        R_before = m.kf_Rcw.copy()
        t_before = m.kf_tcw.copy()
        if not m.apply_ba_result(kf_order, lm_ids, Rcw, tcw, pw,
                                 n_free=n_free):
            return False
        corrected = set(int(x) for x in kf_order)
        for k in (int(k) for k in m.keyframe_ids() if k >= snap_next_kf):
            a = int(m.kf_prev[k])
            while a >= 0 and a not in corrected:
                a = int(m.kf_prev[a])
            if a < 0:
                continue
            R_rel = m.kf_Rcw[k] @ R_before[a].T
            t_rel = m.kf_tcw[k] - R_rel @ t_before[a]
            R_old = m.kf_Rcw[k].copy()
            t_old = m.kf_tcw[k].copy()
            m.kf_Rcw[k] = normalize_rotation_np((R_rel @ m.kf_Rcw[a])[None])[0]
            m.kf_tcw[k] = R_rel @ m.kf_tcw[a] + t_rel
            m.apply_gauge_correction([k], R_old[None], t_old[None])
        other = np.setdiff1d(np.nonzero(m.lm_valid)[0], lm_ids)
        if other.size:
            ref = m.lm_ref_kf[other]
            ok = ref >= 0
            other, ref = other[ok], ref[ok]
            pc = (np.einsum("kij,kj->ki", R_before[ref], m.lm_pw[other])
                  + t_before[ref])
            m.lm_pw[other] = np.einsum(
                "kji,kj->ki", m.kf_Rcw[ref],
                pc - m.kf_tcw[ref]).astype(np.float32)
        if correction_sinks:
            last = int(m.keyframe_ids()[-1])
            for sink in correction_sinks:
                sink.push_correction(R_before[last], t_before[last],
                                     m.kf_Rcw[last].copy(),
                                     m.kf_tcw[last].copy())
        m.big_change_idx += 1
        return True

    def _pad_problem(self, p: dict) -> BAProblem:
        cfg = self.cfg
        K = p["Rcw"].shape[0]
        M = p["pw"].shape[0]
        Kp = -(-K // cfg.ba_kf_pad) * cfg.ba_kf_pad
        Mp = -(-M // cfg.ba_lm_pad) * cfg.ba_lm_pad

        def pad(a, n, fill=0):
            w = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        Rcw = pad(p["Rcw"], Kp)
        Rcw[K:] = np.eye(3, dtype=np.float32)
        return BAProblem(
            Rcw=self._t(Rcw), tcw=self._t(pad(p["tcw"], Kp)),
            fixed=self._t(pad(p["fixed"], Kp, True)),
            pw=self._t(pad(p["pw"], Mp)),
            lm_valid=self._t(pad(p["lm_valid"], Mp, False)),
            obs_kf=self._t(pad(p["obs_kf"], Mp, -1)),
            obs_uv=self._t(pad(p["obs_uv"], Mp)),
            obs_ur=self._t(pad(p["obs_ur"], Mp, -1.0)),
            obs_inv_sigma2=self._t(pad(p["obs_inv_sigma2"], Mp, 1.0)),
            obs_valid=self._t(pad(p["obs_valid"], Mp, False)))

    # ------------------------------------------------------------------

    def cull_keyframes(self, k: int):
        """KeyFrameCulling: erase covisible KFs whose landmarks are >= 90%
        observed by >= 3 other KFs at the same or finer octave."""
        m = self.map
        if m.n_keyframes() <= self.cfg.kf_cull_min_map:
            return
        neigh, _ = m.covisible_keyframes(k, min_shared=15)
        n_culled = 0
        for kf in neigh:
            if kf == 0 or kf == k:
                continue
            if k - kf < self.cfg.kf_cull_min_age:
                continue
            if n_culled >= self.cfg.kf_cull_max_per_pass:
                break
            prev, nxt = int(m.kf_prev[kf]), int(m.kf_next[kf])
            if prev >= 0 and nxt >= 0:
                gap = m.kf_timestamp[nxt] - m.kf_timestamp[prev]
                cap = min(self.vio_timespan_cap, self.cfg.kf_cull_max_gap) \
                    if self.vio_active else self.cfg.kf_cull_max_gap
                if gap > cap:
                    continue
            elif self.vio_active:
                continue
            kp_sel = np.nonzero(m.kf_lm_idx[kf] >= 0)[0]
            lms = m.kf_lm_idx[kf, kp_sel]
            if lms.size == 0:
                m.erase_keyframe(int(kf))
                n_culled += 1
                continue
            obs_kf, obs_kp = m.landmark_observations(lms)
            lev = m.kf_level[np.clip(obs_kf, 0, None),
                             np.clip(obs_kp, 0, None)]
            lvl_self = m.kf_level[kf, kp_sel]
            others = (obs_kf >= 0) & (obs_kf != kf)
            cnt = (others & (lev <= lvl_self[:, None] + 1)).sum(axis=1)
            if (cnt >= 3).mean() > self.cfg.kf_cull_redundancy:
                m.erase_keyframe(int(kf))
                n_culled += 1
