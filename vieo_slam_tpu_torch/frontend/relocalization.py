"""Relocalization: recover a lost tracker against the keyframe database.

Port of vieo_slam_tpu/frontend/relocalization.py: BoW query for candidate
keyframes, descriptor matching against each candidate's landmarks with an
octave gate (kernel B3), a minimal-solver RANSAC (3-point Horn hypotheses
scored by reprojection when the frame has depth for >= 10 matches, else
six-point DLT PnP), then a projection search of the candidate's
covisible landmarks at the coarse pose (kernel B4) and a pose
optimization on the harvested matches.  Each candidate's RANSAC draws
with the key of the frame's timestamp in milliseconds (`timestamp_seed`),
the JAX package's own hypotheses for that key (`utils.prng`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cameras import models as cm
from ..loop.vocabulary import transform
from ..math.lie import normalize_rotation_np
from ..ops import matching
from ..solvers.motion_ba import PoseObs, pose_optimization
from ..solvers.pnp_solver import pnp_ransac, pnp_ransac_3d3d
from ..utils import prng
from .frame import desc_to_tensor
from .tracking import TrackState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def timestamp_seed(timestamp: float) -> int:
    """The draw's seed: the timestamp in ms, masked to 31 bits, computed
    as the JAX package computes it with x64 off (an f32 timestamp times
    1e3 in f32, truncated).  The f64 product differs at some timestamps
    (0.1 * 163: 16299 in f32, 16300 in f64)."""
    ms = np.float32(np.float32(timestamp) * np.float32(1e3))
    return int(ms) & 0x7FFFFFFF


def try_relocalize(system, loop_closer, frame) -> bool:
    """Attempt relocalization of `frame`; on success the tracker's pose
    and state are reset.  Returns True on success."""
    if loop_closer is None or loop_closer.voc is None \
            or loop_closer.db is None:
        return False
    m = system.map
    tr = system.tracker
    dev = frame.uv.device
    bow, _ = transform(loop_closer.voc, frame.desc, frame.valid)
    cands = loop_closer.db.detect_reloc_candidates(_np(bow), top_n=5)
    f_valid = _np(frame.valid)
    if f_valid.sum() < 30:
        return False
    depth = _np(frame.depth)
    rays = _np(cm.unproject(system.cam, frame.uv))
    lvl_f = _np(frame.level)
    key = prng.prng_key(timestamp_seed(frame.timestamp))
    fx = float(system.cam.fx)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for c in (int(x) for x in cands):
        kp_has_lm = m.kf_kp_valid[c] & (m.kf_lm_idx[c] >= 0)
        # Level-consistency gate (|octave difference| <= 1).
        extra = t(np.abs(lvl_f[:, None] - m.kf_level[c][None, :]) <= 1)
        idx, _ = matching.match_descriptors(
            frame.desc, desc_to_tensor(m.kf_desc[c], dev), frame.valid,
            t(kp_has_lm), max_dist=60, ratio=0.85, extra_mask=extra)
        idx = _np(idx)
        rows = np.nonzero(idx >= 0)[0]
        if rows.size < 15:
            continue
        lm = m.kf_lm_idx[c, idx[rows]]
        ok = (lm >= 0) & m.lm_valid[lm]
        rows, lm = rows[ok], lm[ok]
        if rows.size < 15:
            continue
        cap = 512
        n = min(rows.size, cap)
        dst = np.zeros((cap, 3), np.float32)
        val = np.zeros(cap, bool)
        dst[:n] = m.lm_pw[lm[:n]]
        val[:n] = True
        # Coarse pose.  The inlier gate is 5 px: the landmarks carry
        # single-view stereo depth noise that reprojects several pixels
        # from another viewpoint.
        src_rays = np.zeros((cap, 3), np.float32)
        src_rays[:, 2] = 1.0
        src_rays[:n] = rays[rows[:n]]
        d_rows = depth[rows[:n]]
        has3d = np.zeros(cap, bool)
        has3d[:n] = d_rows > 0
        if has3d.sum() >= 10:
            p_cam = np.zeros((cap, 3), np.float32)
            p_cam[:n] = rays[rows[:n]] * np.maximum(d_rows, 0)[:, None]
            res = pnp_ransac_3d3d(t(p_cam), t(src_rays), t(dst), t(has3d),
                                  t(val), key, n_hyp=1024, thresh=5.0 / fx,
                                  min_inliers=10)
        else:
            res = pnp_ransac(t(src_rays), t(dst), t(val), key, n_hyp=2048,
                             thresh=5.0 / fx, min_inliers=10)
        if not bool(res.ok):
            continue
        Rcw = _np(res.Rcw).astype(np.float32)
        tcw = _np(res.tcw).astype(np.float32)

        # Harvest: project the candidate's covisible landmark set at the
        # coarse pose, window-match, then optimize the pose on it.
        neigh, _ = m.covisible_keyframes(c, min_shared=5)
        lm_ids = m.landmarks_in_keyframes(np.concatenate([[c], neigh[:10]]))
        lm_ids = lm_ids[m.lm_valid[lm_ids]][:2048]
        hcap = 2048
        nlm = len(lm_ids)
        pw_h = np.zeros((hcap, 3), np.float32)
        desc_h = np.zeros((hcap, 8), np.uint32)
        uv_h = np.zeros((hcap, 2), np.float32)
        vis_h = np.zeros(hcap, bool)
        pw_h[:nlm] = m.lm_pw[lm_ids]
        desc_h[:nlm] = m.lm_desc[lm_ids]
        pc = pw_h[:nlm] @ Rcw.T + tcw
        uv_t = cm.project(system.cam, torch.from_numpy(pc))
        uv_h[:nlm] = uv_t.numpy()
        vis_h[:nlm] = (pc[:, 2] > 0.1) & cm.in_image(system.cam, uv_t,
                                                     1.0).numpy()
        hidx, _ = matching.search_by_projection(
            t(uv_h), torch.zeros(hcap, dtype=torch.int32, device=dev),
            desc_to_tensor(desc_h, dev), t(vis_h),
            frame.uv, frame.level, frame.desc, frame.valid,
            radius=10.0, level_scales=m.level_scales.astype(np.float32),
            max_dist=60, ratio=0.9, level_tolerance=8)
        kp = hidx.clamp_min(0).long()
        lv = frame.level[kp].long().clamp_min(0)
        obs = PoseObs(pw=t(pw_h), uv=frame.uv[kp], ur=frame.ur[kp],
                      inv_sigma2=t(m.inv_sigma2)[lv], valid=hidx >= 0)
        ref = pose_optimization(t(Rcw), t(tcw), obs, system.cam, system.bf,
                                rounds=2, iters_per_round=5)
        if int(ref.n_inliers) < 20:
            continue
        tr.Rcw = normalize_rotation_np(_np(ref.Rcw).astype(np.float32))
        tr.tcw = _np(ref.tcw).astype(np.float32)
        tr.velocity = None
        tr.last_kf_id = c
        tr.state = TrackState.OK
        # read by an odometry front end (the post-relocalization bias
        # recompute) and cleared there
        tr.just_relocalized = True
        return True
    return False
