"""A loop closer's state saved as npz arrays (scripts/row_parity.py's
closure_state() writes it with --dump), read back into the JAX package's
LoopCloser, and the keyframe ATE of a map; shared by
tests/test_torch_loop_closing.py and scripts/row_parity.py.  Only
jax_closer_from_state() imports the JAX package."""

import json

import numpy as np


def kf_ate(m, ate_fn, ts, twc, mono: bool) -> float:
    """The keyframe ATE RMSE of a map (the rows' kf_ate), with either
    package's ate()."""
    kfs = m.keyframe_ids()
    if len(kfs) < 2:
        return float("nan")
    p = np.stack([-(m.kf_Rcw[k].T @ m.kf_tcw[k]) for k in kfs])
    return float(ate_fn(m.kf_timestamp[kfs], p, ts, twc,
                        with_scale=mono)["rmse"])


def jax_closer_from_state(z):
    """The JAX package's LoopCloser over its MapState, both rebuilt from a
    closure state (closure_state()'s arrays), and its camera."""
    from vieo_slam_tpu.backend.loop_closing import (
        LoopCloser, LoopClosingConfig)
    from vieo_slam_tpu.cameras import models as jcm
    from vieo_slam_tpu.loop.keyframe_db import KeyFrameDatabase
    from vieo_slam_tpu.loop.vocabulary import Vocabulary
    from vieo_slam_tpu.map.map_state import MapConfig, MapState
    from vieo_slam_tpu_torch.convert import _MAP_ARRAYS

    jm = MapState(MapConfig(*(int(x) for x in z["map_cfg"]),
                            scale_factor=float(z["map_scale_factor"])))
    for name in _MAP_ARRAYS:
        rows = z[f"map_{name}"]
        getattr(jm, name)[:len(rows)] = rows
    jm.version, jm.big_change_idx, jm._next_kf, jm._next_lm = (
        int(x) for x in z["map_counters"])
    jm._lm_free = [int(x) for x in z["map_lm_free"]]
    fx, fy, cx, cy, w, h = z["cam"]
    jcam = jcm.make_pinhole(fx, fy, cx, cy, int(w), int(h))
    k, L = (int(x) for x in z["voc_kL"])
    voc = Vocabulary(k=k, L=L, node_desc=z["voc_node_desc"],
                     idf=z["voc_idf"])
    lc = LoopCloser(jcam, float(z["bf"]), jm, LoopClosingConfig(
        **json.loads(str(z["lc_cfg"]))), vocabulary=voc)
    lc.kf_bow = {int(i): b for i, b in zip(z["kf_bow_ids"], z["kf_bow"])}
    lc.db = KeyFrameDatabase(voc.n_words, capacity=jm.cfg.max_keyframes)
    nk = len(z["db_present"])
    lc.db.bows[:nk] = z["db_bows"]
    lc.db.present[:nk] = z["db_present"]
    lc._pending = {int(a): int(b) for a, b in z["pending"]}
    lc.last_loop_kf, lc.n_loops_closed, lc.total_fuse_count = (
        int(x) for x in z["closer_counters"])
    lc.loop_edges = [(int(a), int(b), R, t) for (a, b), R, t in zip(
        z["loop_edge_kc"], z["loop_edge_R"], z["loop_edge_t"])]
    return lc, jcam
