"""Loop closing: detection, Sim3 verification, map correction, pose graph.

Port of vieo_slam_tpu/backend/loop_closing.py, run synchronously at
keyframe cadence: BoW scoring against the dense keyframe database,
temporal consistency across consecutive keyframes, Hamming matching
(kernel B3) + 3D-3D Sim3 RANSAC for geometric verification, SearchBySim3
(kernel B4) and the two-sided Sim3 refinement, then a whole-graph Sim3
pose graph with landmark correction and SearchAndFuse (kernel B4).  The
vocabulary trains online from the map's own descriptors.  Host-side
numpy does the bookkeeping; the matchers, the solvers and the pose graph
run on the closer's device (by default the GPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cameras import models as cm
from ..frontend.frame import desc_to_tensor
from ..loop.keyframe_db import KeyFrameDatabase
from ..loop.vocabulary import Vocabulary, train_vocabulary, transform
from ..map.map_state import MapState
from ..math import lie
from ..math.lie import normalize_rotation_np
from ..ops import matching
from ..solvers.pose_graph import (
    PoseGraphProblem, correct_landmarks, optimize_pose_graph,
)
from ..solvers.sim3_solver import optimize_sim3, sim3_ransac
from ..utils import prng
from ..utils.device import resolve_device
from ..utils.metrics import metrics


@dataclasses.dataclass
class LoopClosingConfig:
    min_kf_gap: int = 10            # KFs between query and candidates
    consistency_needed: int = 2     # consecutive detections required
    min_sim3_inliers: int = 20      # ComputeSim3 acceptance
    inlier_thresh: float = 0.10     # metric 3D-3D gate
    fix_scale: bool = True          # stereo/RGB-D
    covis_edge_min: int = 30        # covisibility edges >= N shared
    voc_k: int = 8                  # k^L leaf words
    voc_L: int = 4
    voc_train_after: int = 3        # train vocab once N KFs exist
    max_pose_graph_kfs: int = 512


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sim3_inverse_np(R, t, s):
    """Host Sim3 inverse of one (R [3, 3], t [3], s) in f32."""
    Ri, ti, si = lie.sim3_inverse(
        torch.as_tensor(np.asarray(R, np.float32)),
        torch.as_tensor(np.asarray(t, np.float32)),
        torch.tensor(float(s), dtype=torch.float32))
    return Ri.numpy(), ti.numpy(), float(si)


class LoopCloser:
    def __init__(self, cam: cm.Camera, bf: float, map_state: MapState,
                 cfg: LoopClosingConfig | None = None,
                 vocabulary: Vocabulary | None = None, device=None):
        self.cam = cam
        self.bf = float(bf)
        self.map = map_state
        self.cfg = cfg or LoopClosingConfig()
        self.device = resolve_device(device)
        self.voc = vocabulary
        self.db: KeyFrameDatabase | None = None
        self.kf_bow: dict[int, np.ndarray] = {}
        self.last_loop_kf = -10 ** 9
        self._pending: dict[int, int] = {}   # candidate -> streak count
        self.loop_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.n_loops_closed = 0
        self.last_fuse_count = 0        # SearchAndFuse merges + additions
        self.total_fuse_count = 0

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device)

    def _desc(self, a) -> torch.Tensor:
        return desc_to_tensor(a, self.device)

    # ------------------------------------------------------------------

    def _ensure_vocabulary(self):
        if self.voc is not None:
            return True
        m = self.map
        kfs = m.keyframe_ids()
        if len(kfs) < self.cfg.voc_train_after:
            return False
        alld = np.concatenate([m.kf_desc[k][m.kf_kp_valid[k]] for k in kfs])
        if len(alld) < 500:
            return False
        self.voc = train_vocabulary(alld, k=self.cfg.voc_k,
                                    L=self.cfg.voc_L, seed=0)
        return True

    def rebuild_database(self):
        """Re-create the vocabulary and the database from the current map
        (map reuse: every loaded keyframe is added again)."""
        self.kf_bow = {}
        self.db = None
        self.voc = None
        self._pending = {}
        if not self._ensure_vocabulary():
            return False
        self.db = KeyFrameDatabase(self.voc.n_words,
                                   capacity=self.map.cfg.max_keyframes)
        for k in self.map.keyframe_ids():
            self.db.add(int(k), self._bow_of(int(k)))
        return True

    def _bow_of(self, k: int) -> np.ndarray:
        if k not in self.kf_bow:
            m = self.map
            bow, _ = transform(self.voc, self._desc(m.kf_desc[k]),
                               self._t(m.kf_kp_valid[k]))
            self.kf_bow[k] = _np(bow)
        return self.kf_bow[k]

    # ------------------------------------------------------------------

    def process_keyframe(self, k: int) -> bool:
        """DetectLoop + ComputeSim3 + CorrectLoop for one new KF.
        Returns True if a loop was closed."""
        if not self._ensure_vocabulary():
            return False
        if self.db is None:
            self.db = KeyFrameDatabase(self.voc.n_words,
                                       capacity=self.map.cfg.max_keyframes)
        m = self.map
        # Purge culled keyframes from the database: a dead KF left in it
        # keeps scoring as a candidate that no exclusion sees.
        nk = min(len(self.db.present), len(m.kf_valid))
        for kf in np.nonzero(self.db.present[:nk] & ~m.kf_valid[:nk])[0]:
            self.db.erase(int(kf))
            self.kf_bow.pop(int(kf), None)
        bow = self._bow_of(k)
        closed = False
        if k - self.last_loop_kf >= self.cfg.min_kf_gap:
            neigh, _ = m.covisible_keyframes(k, min_shared=5)
            connected = np.concatenate([[k], neigh]).astype(int)
            recent = np.asarray(
                [kf for kf in m.keyframe_ids()
                 if k - kf < self.cfg.min_kf_gap], int)
            excl = np.unique(np.concatenate([connected, recent]))
            cands = self.db.detect_loop_candidates(
                bow, k, excl,
                lambda c: m.covisible_keyframes(int(c), min_shared=5)[0])
            for c in self._consistency_filter(cands):
                if self._try_close(k, int(c)):
                    closed = True
                    break
        self.db.add(k, bow)
        return closed

    def _consistency_filter(self, cands: np.ndarray) -> np.ndarray:
        """A candidate must persist `consistency_needed` consecutive KFs (a
        candidate or its covisible ring counts as the same group)."""
        m = self.map
        out = []
        new_pending: dict[int, int] = {}
        for c in cands:
            group = set(int(x) for x in np.concatenate(
                [[c], m.covisible_keyframes(int(c), min_shared=5)[0]]))
            streak = 1
            for prev, cnt in self._pending.items():
                if prev in group:
                    streak = cnt + 1
                    break
            new_pending[int(c)] = streak
            if streak >= self.cfg.consistency_needed:
                out.append(int(c))
        self._pending = new_pending
        return np.asarray(out, int)

    # ------------------------------------------------------------------

    def _matched_landmark_pairs(self, k: int, c: int):
        """Descriptor-match keypoints of k vs c where both carry landmarks
        (kernel B3); returns their landmark positions in each KF's camera
        frame and their landmark ids."""
        m = self.map
        idx, _ = matching.match_descriptors(
            self._desc(m.kf_desc[k]), self._desc(m.kf_desc[c]),
            self._t(m.kf_kp_valid[k] & (m.kf_lm_idx[k] >= 0)),
            self._t(m.kf_kp_valid[c] & (m.kf_lm_idx[c] >= 0)),
            max_dist=60, ratio=0.85)
        idx = _np(idx)
        rows = np.nonzero(idx >= 0)[0]
        if rows.size == 0:
            return None
        lm_k = m.kf_lm_idx[k, rows]
        lm_c = m.kf_lm_idx[c, idx[rows]]
        ok = (lm_k >= 0) & (lm_c >= 0) & m.lm_valid[lm_k] & m.lm_valid[lm_c]
        lm_k, lm_c = lm_k[ok], lm_c[ok]
        if lm_k.size < 3:
            return None
        p_k = m.lm_pw[lm_k] @ m.kf_Rcw[k].T + m.kf_tcw[k]   # in k frame
        p_c = m.lm_pw[lm_c] @ m.kf_Rcw[c].T + m.kf_tcw[c]   # in c frame
        return p_k.astype(np.float32), p_c.astype(np.float32), lm_k, lm_c

    def _search_by_sim3(self, k: int, c: int, S_ck):
        """SearchBySim3: project each KF's landmarks through the Sim3
        estimate into the other image and window-match (kernel B4) against
        its landmark-carrying keypoints; keep the pairs found in both
        directions.  Returns (lm_k, lm_c, kp_k, kp_c)."""
        m = self.map
        R_ck, t_ck, s_ck = S_ck
        R_kc, t_kc, s_kc = _sim3_inverse_np(R_ck, t_ck, s_ck)

        def project_side(src, dst, R, t, s):
            lm = m.kf_lm_idx[src]
            has = m.kf_kp_valid[src] & (lm >= 0)
            has = has & m.lm_valid[np.clip(lm, 0, None)]
            p_src = (m.lm_pw[np.clip(lm, 0, None)] @ m.kf_Rcw[src].T
                     + m.kf_tcw[src])
            p_dst = float(s) * (p_src @ np.asarray(R).T) + np.asarray(t)
            uv = cm.project(self.cam, torch.from_numpy(
                p_dst.astype(np.float32)))
            idx, _ = matching.search_by_projection(
                uv.to(self.device), self._t(m.kf_level[src]),
                self._desc(m.kf_desc[src]),
                self._t(has & (p_dst[:, 2] > 0.05)),
                self._t(m.kf_uv[dst]), self._t(m.kf_level[dst]),
                self._desc(m.kf_desc[dst]),
                self._t(m.kf_kp_valid[dst] & (m.kf_lm_idx[dst] >= 0)),
                radius=10.0, level_scales=m.level_scales,
                max_dist=60, ratio=1.0, level_tolerance=8)
            return _np(idx)

        idx_kc = project_side(k, c, R_ck, t_ck, s_ck)   # kp_k -> kp_c
        idx_ck = project_side(c, k, R_kc, t_kc, s_kc)   # kp_c -> kp_k
        rows_k = np.nonzero(idx_kc >= 0)[0]
        rows_k = rows_k[idx_ck[idx_kc[rows_k]] == rows_k]
        rows_c = idx_kc[rows_k]
        return (m.kf_lm_idx[k, rows_k], m.kf_lm_idx[c, rows_c], rows_k,
                rows_c)

    def _try_close(self, k: int, c: int) -> bool:
        """ComputeSim3 + CorrectLoop for the candidate pair (k, c); the
        RANSAC draws with the key of seed k, as the JAX package's."""
        pairs = self._matched_landmark_pairs(k, c)
        if pairs is None:
            return False
        p_k, p_c, lm_k, lm_c = pairs
        cap = 512
        n = min(len(p_k), cap)
        src = np.zeros((cap, 3), np.float32)
        dst = np.zeros((cap, 3), np.float32)
        val = np.zeros(cap, bool)
        src[:n], dst[:n], val[:n] = p_k[:n], p_c[:n], True
        res = sim3_ransac(
            self._t(src), self._t(dst), self._t(val),
            prng.prng_key(int(k)),
            inlier_thresh=self.cfg.inlier_thresh,
            with_scale=not self.cfg.fix_scale)
        if int(res.n_inliers) < self.cfg.min_sim3_inliers:
            return False
        S_ck = (_np(res.R), _np(res.t), float(res.s))   # k frame -> c frame
        # Widen the match set through the RANSAC seed (SearchBySim3), then
        # refine S_ck on two-sided reprojection; the refined inlier count
        # is the acceptance gate.
        m = self.map
        inl0 = _np(res.inliers)[:n]
        xk, xc, _, _ = self._search_by_sim3(k, c, S_ck)
        pair_k = np.concatenate([lm_k[:n][inl0], xk])
        pair_c = np.concatenate([lm_c[:n][inl0], xc])
        key = pair_k.astype(np.int64) * (1 << 32) + pair_c
        _, uniq = np.unique(key, return_index=True)
        pair_k, pair_c = pair_k[uniq], pair_c[uniq]
        ok = m.lm_valid[pair_k] & m.lm_valid[pair_c]
        refined = self._refine_sim3(k, c, S_ck, pair_k[ok], pair_c[ok])
        if refined is None:
            return False
        S_ck, inl_pairs = refined
        self._correct_loop(k, c, S_ck)
        self.last_loop_kf = k
        self.n_loops_closed += 1
        # fuse the matched duplicates (the Sim3-inlier pairs) ...
        with m.lock:
            for a, b in zip(*inl_pairs):
                if a != b and m.lm_valid[a] and m.lm_valid[b]:
                    m.replace_landmark(int(a), int(b))
        # ... then SearchAndFuse over the loop's covisibility rings.
        self.last_fuse_count = self._search_and_fuse(k, c)
        self.total_fuse_count += self.last_fuse_count
        return True

    def _search_and_fuse(self, k: int, c: int) -> int:
        """SearchAndFuse: project every loop-side landmark (those of KF c
        and its covisibility ring) through the corrected poses into each
        current-side keyframe (k and its ring) and fuse (kernel B4): a
        matched keypoint that carries a landmark has it replaced by the
        loop-side point, a free one gains a new observation.  The
        predicted octaves passed to the matcher are zero, as in the JAX
        package.  Returns the number of fused keypoints."""
        m = self.map
        n_fused = 0
        with m.lock:
            neigh_c, _ = m.covisible_keyframes(c, min_shared=5)
            lm_loop = m.landmarks_in_keyframes(
                np.concatenate([[c], neigh_c]).astype(int))
            lm_loop = lm_loop[m.lm_valid[lm_loop]]
            if lm_loop.size == 0:
                return 0
            neigh_k, _ = m.covisible_keyframes(k, min_shared=5)
            cur_kfs = np.concatenate([[k], neigh_k]).astype(int)
            cap = -(-len(lm_loop) // 1024) * 1024
            scales = m.level_scales.astype(np.float32)
            for kf in (int(x) for x in cur_kfs):
                if not m.kf_valid[kf]:
                    continue
                lm_cur = lm_loop[m.lm_valid[lm_loop]]
                if lm_cur.size == 0:
                    break
                # skip loop points this KF already observes
                seen = np.isin(lm_cur, m.kf_lm_idx[kf][
                    m.kf_kp_valid[kf] & (m.kf_lm_idx[kf] >= 0)])
                pc = m.lm_pw[lm_cur] @ m.kf_Rcw[kf].T + m.kf_tcw[kf]
                npts = len(lm_cur)
                uv_proj = np.zeros((cap, 2), np.float32)
                desc_p = np.zeros((cap, 8), np.uint32)
                vis = np.zeros(cap, bool)
                uv_t = cm.project(self.cam,
                                  torch.from_numpy(pc.astype(np.float32)))
                uv_proj[:npts] = uv_t.numpy()
                desc_p[:npts] = m.lm_desc[lm_cur]
                vis[:npts] = ((pc[:, 2] > 0.1) & ~seen
                              & cm.in_image(self.cam, uv_t, 1.0).numpy())
                idx, _ = matching.fuse_candidates(
                    self._t(uv_proj),
                    torch.zeros(cap, dtype=torch.int32, device=self.device),
                    self._desc(desc_p), self._t(vis),
                    self._t(m.kf_uv[kf]), self._t(m.kf_level[kf]),
                    self._desc(m.kf_desc[kf]), self._t(m.kf_kp_valid[kf]),
                    radius=6.0, level_scales=scales)
                idx = _np(idx)[:npts]
                for li, kp in zip(lm_cur[idx >= 0], idx[idx >= 0]):
                    li, kp = int(li), int(kp)
                    if not m.lm_valid[li]:
                        continue
                    existing = int(m.kf_lm_idx[kf, kp])
                    if existing == li:
                        continue
                    if existing >= 0 and m.lm_valid[existing]:
                        # duplicate: the loop-side point replaces it
                        m.replace_landmark(existing, li)
                    else:
                        m.kf_lm_idx[kf, kp] = li
                        m.lm_n_obs[li] += 1
                    n_fused += 1
            m.version += 1
        metrics.count("loop_fused_points", n_fused)
        return n_fused

    def _refine_sim3(self, k: int, c: int, S_ck, pair_k, pair_c):
        """OptimizeSim3 on the pairs' positions in each camera frame and
        their observing keypoints; None below min_sim3_inliers."""
        m = self.map
        if len(pair_k) < 3:
            return None
        kp_k = self._kp_of_landmarks(k, pair_k)
        kp_c = self._kp_of_landmarks(c, pair_c)
        ok = (kp_k >= 0) & (kp_c >= 0)
        pair_k, pair_c = pair_k[ok], pair_c[ok]
        kp_k, kp_c = kp_k[ok], kp_c[ok]
        if len(pair_k) < 3:
            return None
        cap = 512
        nn = min(len(pair_k), cap)
        pk = np.zeros((cap, 3), np.float32)
        pc = np.zeros((cap, 3), np.float32)
        uk = np.zeros((cap, 2), np.float32)
        uc = np.zeros((cap, 2), np.float32)
        isk = np.ones(cap, np.float32)
        isc = np.ones(cap, np.float32)
        vv = np.zeros(cap, bool)
        pk[:nn] = m.lm_pw[pair_k[:nn]] @ m.kf_Rcw[k].T + m.kf_tcw[k]
        pc[:nn] = m.lm_pw[pair_c[:nn]] @ m.kf_Rcw[c].T + m.kf_tcw[c]
        uk[:nn] = m.kf_uv[k, kp_k[:nn]]
        uc[:nn] = m.kf_uv[c, kp_c[:nn]]
        isk[:nn] = m.inv_sigma2[m.kf_level[k, kp_k[:nn]]]
        isc[:nn] = m.inv_sigma2[m.kf_level[c, kp_c[:nn]]]
        vv[:nn] = True
        R0, t0, s0 = S_ck
        out = optimize_sim3(
            self._t(R0, torch.float32), self._t(t0, torch.float32),
            torch.tensor(float(s0), dtype=torch.float32, device=self.device),
            self._t(pk), self._t(pc), self._t(uk), self._t(uc),
            self._t(isk), self._t(isc), self._t(vv), self.cam,
            fix_scale=self.cfg.fix_scale)
        if int(out.n_inliers) < self.cfg.min_sim3_inliers:
            return None
        inl = _np(out.inliers)[:nn]
        S = (_np(out.R), _np(out.t), float(out.s))
        return S, (pair_k[:nn][inl], pair_c[:nn][inl])

    def _kp_of_landmarks(self, kf: int, lm_ids: np.ndarray) -> np.ndarray:
        """Keypoint index of each landmark id in KF kf (-1 if unseen)."""
        m = self.map
        inv = np.full(int(m.lm_pw.shape[0]), -1, np.int64)
        lm = m.kf_lm_idx[kf]
        rows = np.nonzero(m.kf_kp_valid[kf] & (lm >= 0))[0]
        inv[lm[rows]] = rows
        return inv[lm_ids]

    # ------------------------------------------------------------------

    def _correct_loop(self, k: int, c: int, S_ck):
        """CorrectLoop: pose graph over all KFs with the new loop edge,
        under map.lock."""
        with self.map.lock:
            self._correct_loop_locked(k, c, S_ck)

    def _correct_loop_locked(self, k: int, c: int, S_ck):
        m = self.map
        cfg = self.cfg
        all_kfs = m.keyframe_ids()
        if len(all_kfs) > cfg.max_pose_graph_kfs:
            # Hierarchical skeleton: a temporally uniform subsample plus
            # every loop-edge endpoint is optimized; the other keyframes
            # re-attach rigidly to their nearest preceding skeleton KF.
            stride = -(-len(all_kfs) // cfg.max_pose_graph_kfs)
            keep = set(int(x) for x in all_kfs[::stride])
            keep.update((int(k), int(c), int(all_kfs[-1])))
            for (a, b, *_rest) in self.loop_edges:
                keep.update((int(a), int(b)))
            kfs = np.asarray(sorted(x for x in keep if m.kf_valid[x]), int)
        else:
            kfs = all_kfs
        K = len(kfs)
        local = {int(kf): i for i, kf in enumerate(kfs)}
        R = m.kf_Rcw[kfs].astype(np.float32)
        t = m.kf_tcw[kfs].astype(np.float32)

        ei, ej, eR, et, es, ew = [], [], [], [], [], []

        def add_edge(i, j, Rm=None, tm=None, sm=1.0, w=1.0):
            ei.append(i)
            ej.append(j)
            if Rm is None:  # measurement from the current estimates
                Rm = R[i] @ R[j].T
                tm = t[i] - Rm @ t[j]
            eR.append(np.asarray(Rm, np.float32))
            et.append(np.asarray(tm, np.float32))
            es.append(sm)
            ew.append(w)

        # temporal chain edges
        for a, b in zip(kfs[:-1], kfs[1:]):
            add_edge(local[int(a)], local[int(b)])
        # covisibility edges, weighted by shared-landmark count
        for kf in kfs:
            neigh, wts = m.covisible_keyframes(int(kf),
                                               min_shared=cfg.covis_edge_min)
            for nb, ws in list(zip(neigh, wts))[:8]:
                i, j = local[int(kf)], local.get(int(nb))
                if j is None or i >= j:
                    continue
                add_edge(i, j, w=min(float(ws) / cfg.covis_edge_min, 4.0))
        # previous loop edges
        for (a, b, Rm, tm) in self.loop_edges:
            if int(a) in local and int(b) in local:
                add_edge(local[int(a)], local[int(b)], Rm, tm, 1.0, w=3.0)
        # the new loop edge: for (i=k, j=c) the measurement is
        # S_kw S_cw^-1 = S_kc = S_ck^-1.
        R_kc, t_kc, s_kc = _sim3_inverse_np(*S_ck)
        add_edge(local[k], local[c], R_kc, t_kc, s_kc, w=5.0)
        self.loop_edges.append((k, c, R_kc, t_kc))

        fixed = np.zeros(K, bool)
        fixed[local[c]] = True                   # anchor the loop KF
        prob = PoseGraphProblem(
            R=self._t(R), t=self._t(t),
            s=torch.ones(K, dtype=torch.float32, device=self.device),
            fixed=self._t(fixed),
            edge_i=self._t(np.asarray(ei, np.int32)),
            edge_j=self._t(np.asarray(ej, np.int32)),
            edge_R=self._t(np.stack(eR)), edge_t=self._t(np.stack(et)),
            edge_s=self._t(np.asarray(es, np.float32)),
            edge_w=self._t(np.asarray(ew, np.float32)))
        out = optimize_pose_graph(prob, iters=20, fix_scale=cfg.fix_scale)
        R_new, t_new, s_new = _np(out.R), _np(out.t), _np(out.s)

        # Expand the skeleton solution to every valid keyframe.
        n_all = len(all_kfs)
        R_all_new = np.zeros((n_all, 3, 3), np.float32)
        t_all_new = np.zeros((n_all, 3), np.float32)
        s_all_new = np.ones(n_all, np.float32)
        all_local = {int(kf): i for i, kf in enumerate(all_kfs)}
        in_skel = np.asarray([int(kf) in local for kf in all_kfs])
        skel_rows = np.asarray([local[int(kf)] for kf in all_kfs[in_skel]],
                               int)
        R_all_new[in_skel] = R_new[skel_rows]
        t_all_new[in_skel] = t_new[skel_rows]
        s_all_new[in_skel] = s_new[skel_rows]
        if not in_skel.all():
            anchor_pos = np.maximum.accumulate(
                np.where(in_skel, np.arange(n_all), -1))
            anchor_pos[anchor_pos < 0] = int(np.argmax(in_skel))
            for i in np.nonzero(~in_skel)[0]:
                a = int(anchor_pos[i])
                kf_i, kf_a = int(all_kfs[i]), int(all_kfs[a])
                R_rel = m.kf_Rcw[kf_i] @ m.kf_Rcw[kf_a].T
                t_rel = m.kf_tcw[kf_i] - R_rel @ m.kf_tcw[kf_a]
                R_all_new[i] = R_rel @ R_all_new[a]
                t_all_new[i] = R_rel @ t_all_new[a] + t_rel
                s_all_new[i] = s_all_new[a]

        # Landmarks move with their reference KFs, then write back.
        lm_ids = np.nonzero(m.lm_valid)[0]
        ref_local = np.asarray([all_local.get(int(r), 0)
                                for r in m.lm_ref_kf[lm_ids]], np.int32)
        pw_new = correct_landmarks(
            self._t(m.lm_pw[lm_ids]), self._t(ref_local),
            self._t(m.kf_Rcw[all_kfs].astype(np.float32)),
            self._t(m.kf_tcw[all_kfs].astype(np.float32)),
            torch.ones(n_all, dtype=torch.float32, device=self.device),
            self._t(R_all_new), self._t(t_all_new), self._t(s_all_new))
        m.lm_pw[lm_ids] = _np(pw_new)
        R_old_cw = m.kf_Rcw[all_kfs].copy()
        t_old_cw = m.kf_tcw[all_kfs].copy()
        # scale-normalize back onto SE3 for storage
        m.kf_Rcw[all_kfs] = normalize_rotation_np(R_all_new)
        m.kf_tcw[all_kfs] = t_all_new / np.maximum(s_all_new[:, None], 1e-9)
        m.apply_gauge_correction(all_kfs, R_old_cw, t_old_cw)
        m.big_change_idx += 1
        m.version += 1
