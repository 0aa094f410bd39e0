"""Map checkpoint / resume and trajectory output formats.

Port of vieo_slam_tpu/io/serialization.py (the reference's map save/load
and its SaveTrajectoryTUM / SaveTrajectoryKITTI / SaveTrajectoryNavState
writers).  The map is one compressed .npz of the map's arrays plus a JSON
entry of its scalar state, under the JAX package's keys, so a map either
package saved loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..map.map_state import MapConfig, MapState
from ..math import lie

_ARRAY_FIELDS = (
    "kf_valid", "kf_Rcw", "kf_tcw", "kf_timestamp", "kf_frame_id",
    "kf_Rwb", "kf_pwb", "kf_vwb", "kf_bg", "kf_ba",
    "kf_uv", "kf_level", "kf_desc", "kf_ur", "kf_depth",
    "kf_kp_valid", "kf_lm_idx", "kf_prev", "kf_next",
    "lm_valid", "lm_pw", "lm_desc", "lm_normal", "lm_min_dist",
    "lm_max_dist", "lm_n_obs", "lm_visible", "lm_found",
    "lm_first_kf", "lm_ref_kf",
)


def save_map(m: MapState, path: str):
    """Write the map to `path` (.npz) atomically: a temporary file, then a
    rename."""
    with m.lock:
        arrays = {f: np.array(getattr(m, f)) for f in _ARRAY_FIELDS}
        meta = dict(
            version=m.version, big_change_idx=m.big_change_idx,
            next_kf=m._next_kf, next_lm=m._next_lm,
            cfg=dict(max_keyframes=m.cfg.max_keyframes,
                     max_landmarks=m.cfg.max_landmarks,
                     max_kp=m.cfg.max_kp, max_obs=m.cfg.max_obs,
                     n_levels=m.cfg.n_levels,
                     scale_factor=m.cfg.scale_factor))
    tmp = path + ".tmp"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_map(path: str) -> MapState:
    """A MapState read from a file save_map (of either package) wrote."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        m = MapState(MapConfig(**meta["cfg"]))
        for f in _ARRAY_FIELDS:
            setattr(m, f, z[f].copy())
    m.version = meta["version"]
    m.big_change_idx = meta["big_change_idx"]
    m._next_kf = meta["next_kf"]
    m._next_lm = meta["next_lm"]
    return m


# ---------------------------------------------------------------------------
# Trajectory formats
# ---------------------------------------------------------------------------


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix (numpy in, out)."""
    return lie.quat_from_rotmat(torch.from_numpy(
        np.ascontiguousarray(R))).numpy()


def tum_line(t, Rcw, tcw) -> str:
    """`t x y z qx qy qz qw` of Twc."""
    Rwc = Rcw.T
    twc = -Rwc @ tcw
    q = quat_wxyz(Rwc)
    return (f"{t:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")


def write_trajectory_tum(path: str, trajectory):
    """TUM format, one line per (t, Rcw, tcw, state) entry."""
    with open(path, "w") as f:
        for t, Rcw, tcw, _state in trajectory:
            f.write(tum_line(t, Rcw, tcw) + "\n")


def write_trajectory_kitti(path: str, trajectory):
    """KITTI format: the 12 floats of the 3x4 Twc matrix per entry."""
    with open(path, "w") as f:
        for _t, Rcw, tcw, _state in trajectory:
            Rwc = Rcw.T
            twc = -Rwc @ tcw
            T = np.concatenate([Rwc, twc[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{x:.9e}" for x in T) + "\n")


def write_trajectory_navstate(path: str, m: MapState):
    """NavState format: `t p q v bg ba` per keyframe."""
    with open(path, "w") as f:
        for k in m.keyframe_ids():
            q = quat_wxyz(m.kf_Rwb[k])
            vals = [m.kf_timestamp[k], *m.kf_pwb[k], q[1], q[2], q[3], q[0],
                    *m.kf_vwb[k], *m.kf_bg[k], *m.kf_ba[k]]
            f.write(" ".join(f"{x:.7f}" for x in vals) + "\n")
