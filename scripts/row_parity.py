#!/usr/bin/env python3
"""Run the first frames of one row of evaluate_ntimes.py with the JAX
package (on the CPU, x64 off, as its rows run) and with the port (on a
GPU or the CPU), and print where each initializes and goes LOST.

    python3 scripts/row_parity.py --row mono_loop --seed 11 --frames 60 \
        [--sides jax,port] [--device cuda] [--dump DIR] [--out FILE]
    python3 scripts/row_parity.py --row smoke_mono --seed 0
    python3 scripts/row_parity.py --row stereo_loop --seed 0 --width 752 \
        --features 1200 --levels 8 --sides jax --out ACCURACY_fullwidth.json
    python3 scripts/row_parity.py --row stereo_loop --width 752 \
        --features 1200 --levels 8 --device cpu \
        --replay tests/data/stereo_loop_752_seed0_closure.npz

The row smoke_mono is chip_smoke.py phase 7's mono sequence instead of a
row of evaluate_ntimes.py: chip_smoke.scene at 640x480 in the mono row's
world (MONO_WORLD, MONO_OMEGA), rendered with the rows' photometric noise
and drift from the noise seed (phase 7's is 0), built with 1000 features
on 4 levels and the fused keypoint tail (the port's tail kernel B5, or its
plain twin on the CPU; the JAX package's TPU branch, forced on the CPU),
tracked by a mono System with a 4096-landmark slab and no loop closer.
Its numbers are the scale-aligned ATE RMSE of the OK frames.

Each side runs the row at its size (by default the rows' own: 640x480,
1000 features for mono and 600 otherwise, 4 levels; --width, --features
and --levels run it at another, the camera scaled as the port's
evaluate_ntimes.scenario() scales it) and length (360 frames for a loop
or figure-eight row, 60 otherwise: the blackout sits at 3/5 of it), frame
by frame up to --frames.  For each side it prints the state of every
frame as one string (. OK, L LOST, o ODOMOK, n not initialized), the
frames that made a keyframe, the first OK frame (the two-view init of a
mono row), the LOST runs as (first, last) frames, and every call of
monocular_init with its frame, its matches and its verdict.  With --dump,
each call's (uv1, uv2, valid) and result go to
DIR/<side>_<device>_<row>_<seed>.npz, so that two runs' inputs can be
compared call by call.

For a row with a loop closer, every candidate verification (_try_close)
is recorded on both sides as (frame, k, c, closed), and every closure
with its frame, keyframe k, candidate c, S_ck (R, t, s), the keyframe ATE
before and after the correction and the SearchAndFuse count.  With
--dump, the map and the closer's state at the start of each verification
up to the first closure go to DIR/<side>_<device>_<row>_<seed>_try<n>.npz,
the closing one's to ..._closure.npz (closure_state() writes them;
tests/jax_loop_state.py reads one back into the JAX package's closer,
and --replay NPZ starts both closers from it: the JAX package's on the
CPU, the port's on --device; it needs the JAX package).  With
--vocabulary NPZ each side's loop closer adopts the vocabulary of such a
state where it would train its own from the first keyframes.

--seed takes a comma list.  --out merges into the file it names: each
(row, seed, side) goes under scenarios/<row>/seeds/<seed>/<side>, and
the row's avg_/med_ keys (those of ACCURACY_r05.json) are the means and
medians of the JAX side's seeds (the port's where no JAX side ran).

The JAX side needs the JAX package (run it on the CPU); the port side
imports nothing of it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from jax_loop_state import kf_ate  # noqa: E402  (imports no JAX)

LETTER = {"OK": ".", "LOST": "L", "ODOMOK": "o", "NOT_INITIALIZED": "n"}
SMOKE_MONO = "smoke_mono"


def row_length(row: str) -> int:
    return 360 if row.endswith(("_loop", "_lem")) else 60


# The JAX example's camera (its lines 86-88) and ORB configuration (its
# line 156), rewritten in its source for another width, feature count or
# octave count.
JAX_CAMERA = ("    cam = cm.make_pinhole(fx, fx, 320.0, 240.0, 640, 480)\n"
              "    bf = fx * BASELINE\n")
JAX_ORB = ('    ocfg = orb.OrbConfig(n_features=1000 if base == "mono" else '
           '600,\n                         n_levels=4)\n')


def jax_example_source(width: int, features, levels: int) -> str:
    """examples/evaluate_ntimes.py's source with the camera scaled as the
    port's scenario() scales it (fx * width / 640, cx = width / 2, bf =
    fx * width / 640 * 0.2) and the given ORB configuration; the file on
    disk is left as it is."""
    src = (ROOT / "examples" / "evaluate_ntimes.py").read_text()
    s = width / 640.0
    n_feat = ('1000 if base == "mono" else 600' if features is None
              else str(int(features)))
    for old, new in ((JAX_CAMERA,
                      f"    cam = cm.make_pinhole(fx * {s!r}, fx * {s!r}, "
                      f"{width / 2.0!r}, 240.0, {int(width)}, 480)\n"
                      f"    bf = fx * {s!r} * BASELINE\n"),
                     (JAX_ORB, f"    ocfg = orb.OrbConfig(n_features="
                               f"{n_feat}, n_levels={int(levels)})\n")):
        assert src.count(old) == 1, f"the JAX example no longer holds {old!r}"
        src = src.replace(old, new)
    return src


def closure_state(lc, map_arrays) -> dict:
    """A copy of a loop closer's map and state as npz arrays: the map's
    arrays cut to its used keyframe and landmark rows, its counters and
    configuration, the closer's vocabulary, keyframe BoWs, database,
    consistency streaks, loop edges and configuration, and its camera."""
    m = lc.map
    nk, nl = int(m._next_kf), int(m._next_lm)
    out = {f"map_{n}": np.array(getattr(m, n))[:nk if n.startswith("kf_")
                                                 else nl]
           for n in map_arrays}
    mc = m.cfg
    out["map_cfg"] = np.array([mc.max_keyframes, mc.max_landmarks, mc.max_kp,
                               mc.max_obs, mc.n_levels], np.int64)
    out["map_scale_factor"] = np.float64(mc.scale_factor)
    out["map_counters"] = np.array([m.version, m.big_change_idx, nk, nl],
                                   np.int64)
    out["map_lm_free"] = np.array(list(m._lm_free), np.int64)
    out["voc_kL"] = np.array([lc.voc.k, lc.voc.L], np.int64)
    out["voc_node_desc"] = np.array(lc.voc.node_desc, np.uint32)
    out["voc_idf"] = np.array(lc.voc.idf, np.float32)
    ids = sorted(int(k) for k in lc.kf_bow)
    out["kf_bow_ids"] = np.array(ids, np.int64)
    out["kf_bow"] = np.stack([np.asarray(lc.kf_bow[k], np.float32)
                              for k in ids])
    out["db_bows"] = np.array(lc.db.bows, np.float32)[:nk]
    out["db_present"] = np.array(lc.db.present, bool)[:nk]
    out["pending"] = np.array(sorted((int(k), int(v))
                                     for k, v in lc._pending.items()),
                              np.int64).reshape(-1, 2)
    out["closer_counters"] = np.array(
        [lc.last_loop_kf, lc.n_loops_closed, lc.total_fuse_count], np.int64)
    out["loop_edge_kc"] = np.array([(a, b) for a, b, _, _ in lc.loop_edges],
                                   np.int64).reshape(-1, 2)
    out["loop_edge_R"] = np.array([R for _, _, R, _ in lc.loop_edges],
                                  np.float32).reshape(-1, 3, 3)
    out["loop_edge_t"] = np.array([t for _, _, _, t in lc.loop_edges],
                                  np.float32).reshape(-1, 3)
    out["lc_cfg"] = np.array(json.dumps(
        {k: getattr(lc.cfg, k) for k in vars(lc.cfg)}))
    cam = lc.cam
    out["cam"] = np.array([float(np.asarray(getattr(cam, a))) for a in
                           ("fx", "fy", "cx", "cy", "width", "height")],
                          np.float64)
    out["bf"] = np.float64(lc.bf)
    return out


def state_vocabulary(path):
    """The vocabulary of a closure state, as the port's Vocabulary."""
    from vieo_slam_tpu_torch.loop.vocabulary import Vocabulary

    z = np.load(path)
    k, L = (int(x) for x in z["voc_kL"])
    return Vocabulary(k=k, L=L, node_desc=z["voc_node_desc"],
                      idf=z["voc_idf"])


def replay(path, row: str, device: str, width: int = 640, features=None,
           levels: int = 4) -> dict:
    """Both closers from one closure state: the JAX package's (on the CPU,
    x64 off) and the port's (converted, on `device`) each verify and
    correct the state's (k, c) with their own draws.  Returns each side's
    verdict, S_ck, its error against the row's true relative pose of k
    and c (m, degrees), fused count and keyframe ATE before and after, and
    the largest differences of S_ck and of the corrected keyframe poses."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from vieo_slam_tpu.io.evaluate import ate as jate
    from vieo_slam_tpu_torch import convert
    from vieo_slam_tpu_torch.io.evaluate import ate as tate
    from jax_loop_state import jax_closer_from_state

    z = np.load(path)
    k, c, frame = (int(x) for x in z["try_close_kc"])
    jlc, jcam = jax_closer_from_state(z)
    pmap = convert.map_from_jax(jlc.map)
    plc = convert.loop_closer_from_jax(jlc, convert.camera_from_jax(jcam),
                                       pmap, device=device)
    ts, twc, mono = ground_truth(row, width, features, levels)
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.sim import world as sim

    sc = ev.scenario(row, row_length(row), width, features, levels)
    Rcw, tcw = sim.trajectory_to_tcw(sc.Rwc, sc.twc)
    fk, fc = (int(np.argmin(np.abs(ts - jlc.map.kf_timestamp[x])))
              for x in (k, c))
    R_true = Rcw[fc] @ Rcw[fk].T                # k frame -> c frame
    t_true = tcw[fc] - R_true @ tcw[fk]
    out, S = {"k": k, "c": c, "frame": frame}, {}
    port = f"port_{device.split(':')[0]}"
    for tag, lc, ate_fn in (("jax_cpu", jlc, jate), (port, plc, tate)):
        correct = lc._correct_loop

        def hooked(k_, c_, S_ck, tag=tag, correct=correct):
            S[tag] = [np.asarray(x, np.float64) for x in S_ck]
            correct(k_, c_, S_ck)

        lc._correct_loop = hooked
        before = kf_ate(lc.map, ate_fn, ts, twc, mono)
        closed = bool(lc._try_close(k, c))
        out[tag] = dict(closed=closed, fused=int(lc.last_fuse_count),
                        ate_before=before,
                        ate_after=kf_ate(lc.map, ate_fn, ts, twc, mono))
        if tag in S:
            R, t, _ = S[tag]
            out[tag]["t"] = t.tolist()
            out[tag]["err_t"] = float(np.linalg.norm(t - t_true))
            cos = (np.trace(R @ R_true.T) - 1.0) / 2.0
            out[tag]["err_deg"] = float(np.degrees(np.arccos(
                np.clip(cos, -1.0, 1.0))))
    if len(S) == 2:
        out["max_dR"] = float(np.abs(S["jax_cpu"][0] - S[port][0]).max())
        out["max_dt"] = float(np.abs(S["jax_cpu"][1] - S[port][1]).max())
    kfs = jlc.map.keyframe_ids()
    out["max_pose_dR"] = float(np.abs(jlc.map.kf_Rcw[kfs]
                                      - pmap.kf_Rcw[kfs]).max())
    out["max_pose_dt"] = float(np.abs(jlc.map.kf_tcw[kfs]
                                      - pmap.kf_tcw[kfs]).max())
    return out


def hook_closures(closer_cls, ate_of, frame_of: dict, dump: bool = False):
    """Wrap a LoopCloser class's _try_close and _correct_loop to record
    every candidate verification (frame, k, c, closed) and every closure;
    with `dump`, each verification up to the first closure also keeps the
    state it started from.  Returns the closures, the verifications and
    a function that puts the class's methods back."""
    from vieo_slam_tpu_torch.convert import _MAP_ARRAYS

    records, tries = [], []
    try_close, correct = closer_cls._try_close, closer_cls._correct_loop

    def hooked_correct(self, k, c, S_ck):
        pre = ate_of(self.map)
        correct(self, k, c, S_ck)
        R, t, s = (np.asarray(x, np.float64) for x in S_ck)
        records.append(dict(frame=frame_of["i"], k=int(k), c=int(c),
                            R=R.tolist(), t=t.tolist(), s=float(s),
                            ate_before=pre, ate_after=ate_of(self.map)))

    def hooked_try(self, k, c):
        n = len(records)
        tried = dict(frame=frame_of["i"], k=int(k), c=int(c))
        if dump and not records:
            tried["state"] = {**closure_state(self, _MAP_ARRAYS),
                              "try_close_kc": np.array([k, c, tried["frame"]],
                                                       np.int64)}
        tries.append(tried)
        closed = try_close(self, k, c)
        tried["closed"] = bool(closed)
        if closed and len(records) > n:
            records[-1]["fused"] = int(self.last_fuse_count)
        return closed

    def restore():
        closer_cls._try_close, closer_cls._correct_loop = try_close, correct

    closer_cls._correct_loop = hooked_correct
    closer_cls._try_close = hooked_try
    return records, tries, restore


def smoke_mono_frames(n_frames: int, seed: int):
    """chip_smoke.py phase 7's camera, timestamps, true camera centres and
    images."""
    import chip_smoke as cs
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev

    cam, _, world, ts, Rcw, tcw, twc = cs.scene(
        n_frames, 640, cs.MONO_WORLD, cs.MONO_OMEGA)
    rng = np.random.RandomState(seed)
    images = []
    for i in range(n_frames):
        g, b = ev.gain_bias(float(ts[i]))
        images.append(world.render_view(cam, Rcw[i], tcw[i],
                                        noise_sigma=ev.NOISE_SIGMA, gain=g,
                                        bias=b, rng=rng))
    return cam, ts, twc, images


def ate_ok_frames(traj, ts, twc) -> dict:
    """The scale-aligned ATE RMSE of a tracker's OK frames."""
    from vieo_slam_tpu_torch.io.evaluate import ate

    traj = [x for x in traj if x[3] == "OK"]
    if len(traj) < 3:
        return {"ate_ok_frames": float("nan")}
    poses = np.asarray([-(np.asarray(R).T @ np.asarray(t))
                        for _, R, t, _ in traj])
    return {"ate_ok_frames": ate(np.asarray([x[0] for x in traj]), poses,
                                 ts, twc, with_scale=True)["rmse"]}


def jax_smoke_mono(seed: int, frames: int):
    import jax
    import jax.numpy as jnp

    from vieo_slam_tpu.cameras import models as jcm
    from vieo_slam_tpu.frontend import frame as jframe
    from vieo_slam_tpu.frontend.tracking import TrackerConfig
    from vieo_slam_tpu.ops import orb as jorb
    from vieo_slam_tpu.system import SensorMode, System, SystemConfig

    jorb._use_fused_tail = lambda: True
    jorb._use_gather_kernel = lambda *_: False
    jorb._use_mxu_gather = lambda: False
    cam, ts, twc, images = smoke_mono_frames(frames, seed)
    jc = jcm.make_pinhole(float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), 640, 480)
    cfg = jorb.OrbConfig(n_features=1000, n_levels=4)
    build = jax.jit(lambda im, t: jframe.build_mono_frame(im, cfg,
                                                          timestamp=t))
    system = System(jc, 0.0, SystemConfig(
        sensor=SensorMode.MONOCULAR, tracker=TrackerConfig(
            use_predicted_scale=True, local_landmark_cap=4096)))
    states = [system.track_frame(build(jnp.asarray(im),
                                       jnp.asarray(ts[i], jnp.float64))).name
              for i, im in enumerate(images)]
    system.wait_idle()
    return states, ate_ok_frames(system.tracker.trajectory, ts, twc)


def port_smoke_mono(seed: int, frames: int, device: str, frame_of: dict):
    import torch

    from vieo_slam_tpu_torch.frontend import frame as fr
    from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
    from vieo_slam_tpu_torch.ops import orb
    from vieo_slam_tpu_torch.system import SensorMode, System, SystemConfig

    orb.TAIL_KERNEL_MODE = "on"
    cam, ts, twc, images = smoke_mono_frames(frames, seed)
    cfg = orb.OrbConfig(n_features=1000, n_levels=4)
    system = System(cam, 0.0, SystemConfig(
        sensor=SensorMode.MONOCULAR, tracker=TrackerConfig(
            use_predicted_scale=True, local_landmark_cap=4096)),
        device=device)
    states = []
    for i, im in enumerate(images):
        frame_of["i"] = i
        f = fr.build_mono_frame(torch.from_numpy(im).to(device), cfg,
                                timestamp=float(ts[i]), device=device)
        states.append(system.track_frame(f).name)
    system.wait_idle()
    return states, ate_ok_frames(system.tracker.trajectory, ts, twc)


def summary(states: list, calls: list, kf_frames: list) -> dict:
    letters = "".join(LETTER.get(s, "?") for s in states)
    runs = [(m.start(), m.end() - 1) for m in re.finditer("L+", letters)]
    return {"states": letters, "kf_frames": kf_frames,
            "first_ok": letters.find(".") if "." in letters else None,
            "lost_runs": runs, "n_lost": letters.count("L"),
            "init_calls": [{k: v for k, v in c.items()
                            if k not in ("uv1", "uv2", "val")}
                           for c in calls]}


def dump(path: Path, calls: list):
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for n, c in enumerate(calls):
        for k in ("uv1", "uv2", "val"):
            arrays[f"{n}_{k}"] = c[k]
        arrays[f"{n}_meta"] = np.array([c["frame"], c["key"], c["matches"],
                                        c["ok"], c["n_good"]])
    np.savez_compressed(path, **arrays)


def ground_truth(row: str, width: int, features, levels: int):
    """The row's timestamps and true camera centres (numpy, the same on
    both sides) and whether its ATE is similarity-aligned."""
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev

    sc = ev.scenario(row, row_length(row), width, features, levels)
    return sc.ts, sc.twc, sc.base == "mono"


def run_jax(row: str, seed: int, frames: int, width: int = 640,
            features=None, levels: int = 4, dump: bool = False,
            vocabulary=None):
    """The JAX example's run_once over the row's first frames, its
    per-frame states read from its EVAL_VERBOSE lines, and its closures."""
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from vieo_slam_tpu import system as jsystem
    from vieo_slam_tpu.backend import loop_closing as jlc
    from vieo_slam_tpu.io.evaluate import ate as jate
    from vieo_slam_tpu.solvers import initializer as jinit

    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_ntimes", ROOT / "examples" / "evaluate_ntimes.py")
    ex = importlib.util.module_from_spec(spec)
    exec(compile(jax_example_source(width, features, levels),
                 spec.origin, "exec"), ex.__dict__)
    calls, frame_of, kf_frames = [], {"i": -1}, []
    orig = jinit.monocular_init

    def spy(uv1, uv2, val, cam, key, **kw):
        res = orig(uv1, uv2, val, cam, key, **kw)
        v = np.asarray(val)
        calls.append(dict(frame=frame_of["i"], key=int(np.asarray(key)[-1]),
                          matches=int(v.sum()),
                          ok=bool(res.ok), n_good=int(res.n_good),
                          uv1=np.asarray(uv1), uv2=np.asarray(uv2), val=v))
        return res

    jinit.monocular_init = spy
    track = jsystem.System.track_frame

    def counted(self, *a, **kw):
        frame_of["i"] += 1
        n_kf = self.map._next_kf
        try:
            return track(self, *a, **kw)
        finally:
            kf_frames.extend([frame_of["i"]] * (self.map._next_kf - n_kf))

    jsystem.System.track_frame = counted
    if row == SMOKE_MONO:
        states, out = jax_smoke_mono(seed, frames)
        return ({**summary(states, calls, kf_frames), "numbers": out,
                 "closures": []}, calls, [])
    if row_length(row) != frames and (row.endswith("_blackout")
                                      or row == "map_reuse"):
        raise SystemExit("a recovery row's events depend on its length: "
                         "run all of its frames")
    ts, twc, mono = ground_truth(row, width, features, levels)
    closures, tries, restore = hook_closures(
        jlc.LoopCloser, lambda m: kf_ate(m, jate, ts, twc, mono), frame_of,
        dump)
    train = jlc.train_vocabulary
    if vocabulary is not None:
        from vieo_slam_tpu.loop.vocabulary import Vocabulary

        voc = state_vocabulary(vocabulary)
        jlc.train_vocabulary = lambda *a, **kw: Vocabulary(
            k=voc.k, L=voc.L, node_desc=voc.node_desc, idf=voc.idf)
    os.environ["EVAL_VERBOSE"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = ex.run_once(row, seed, frames)
    finally:
        del os.environ["EVAL_VERBOSE"]
        jsystem.System.track_frame = track
        jinit.monocular_init = orig
        jlc.train_vocabulary = train
        restore()
    jax.clear_caches()
    states = re.findall(r"^\s+\[\s*\d+\]\s+(\w+)", buf.getvalue(), re.M)
    return ({**summary(states, calls, kf_frames), "numbers": out,
             "closures": closures}, calls, tries)


def run_port(row: str, seed: int, frames: int, device: str,
             width: int = 640, features=None, levels: int = 4,
             dump: bool = False, vocabulary=None):
    import torch

    from vieo_slam_tpu_torch.backend import loop_closing as tlc
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.io.evaluate import ate as tate
    from vieo_slam_tpu_torch.solvers import initializer as tinit

    if device.startswith("cuda"):
        from vieo_slam_tpu_torch.ops import cuda_build
        cuda_build.build_all(verbose=False)
    calls, orig, frame_of = [], tinit.monocular_init, {"i": 0}
    kf_frames = []

    def spy(uv1, uv2, val, cam, key, **kw):
        res = orig(uv1, uv2, val, cam, key, **kw)
        v = val.cpu().numpy()
        calls.append(dict(frame=frame_of["i"], key=int(key[1]),
                          matches=int(v.sum()),
                          ok=bool(res.ok), n_good=int(res.n_good),
                          uv1=uv1.cpu().numpy(), uv2=uv2.cpu().numpy(),
                          val=v))
        return res

    tinit.monocular_init = spy
    closures, tries, restore = [], [], lambda: None
    train = tlc.train_vocabulary
    if vocabulary is not None:
        voc = state_vocabulary(vocabulary)
        tlc.train_vocabulary = lambda *a, **kw: voc
    if row != SMOKE_MONO:
        ts, twc, mono = ground_truth(row, width, features, levels)
        closures, tries, restore = hook_closures(
            tlc.LoopCloser, lambda m: kf_ate(m, tate, ts, twc, mono),
            frame_of, dump)
    try:
        if row == SMOKE_MONO:
            states, out = port_smoke_mono(seed, frames, device, frame_of)
        else:
            r = ev.Row(row, seed, row_length(row), device, width, features,
                       levels)
            for i in range(frames):
                frame_of["i"] = i
                n_kf = r.system.map._next_kf
                r.step(i)
                kf_frames.extend([i] * (r.system.map._next_kf - n_kf))
            states = r.states
            out = r.finish() if frames == row_length(row) else None
    finally:
        tinit.monocular_init = orig
        tlc.train_vocabulary = train
        restore()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return ({**summary(states, calls, kf_frames), "numbers": out,
             "closures": closures}, calls, tries)


def git_commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def merge_out(path: Path, meta: dict, row: str, seed: int, tag: str,
              res: dict):
    """Add one (row, seed, side) to the report at `path`, and recompute the
    row's avg_/med_ keys over its seeds."""
    rep = json.loads(path.read_text()) if path.exists() else {
        "meta": {k: v for k, v in meta.items() if k != "command"},
        "scenarios": {}}
    size = ("width", "features", "levels")
    if any(rep["meta"].get(k) != meta[k] for k in size):
        raise SystemExit(f"{path} holds another size: "
                         f"{[rep['meta'].get(k) for k in size]}")
    cmds = rep["meta"].setdefault("commands", [])
    if meta["command"] not in cmds:
        cmds.append(meta["command"])
    rep["meta"].update({k: v for k, v in meta.items() if k != "command"})
    sc = rep["scenarios"].setdefault(row, {"image_level": True})
    sc.setdefault("seeds", {}).setdefault(str(seed), {})[tag] = res
    side = "jax_cpu" if any("jax_cpu" in v for v in sc["seeds"].values()) \
        else tag
    nums = [v[side]["numbers"] for v in sc["seeds"].values()
            if v.get(side, {}).get("numbers")]
    if nums:
        sc["frames"] = row_length(row)
        sc["n_runs"] = len(nums)
        sc["aggregate_of"] = side
        for k in nums[0]:
            vals = np.asarray([n[k] for n in nums], np.float64)
            sc[f"avg_{k}"] = float(np.nanmean(vals))
            sc[f"med_{k}"] = float(np.nanmedian(vals))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", default="mono_loop")
    ap.add_argument("--seed", default="11",
                    help="a noise seed, or a comma list of them")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to run (default: the whole row)")
    ap.add_argument("--sides", default="jax,port")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the JAX side runs on the CPU)")
    ap.add_argument("--width", type=int, default=640,
                    help="image width (the camera scaled from 640)")
    ap.add_argument("--features", type=int, default=None,
                    help="ORB features (default: the row's own)")
    ap.add_argument("--levels", type=int, default=4,
                    help="pyramid levels")
    ap.add_argument("--vocabulary", default=None,
                    help="a closure state (--dump) whose vocabulary each "
                         "side's loop closer adopts where it would train "
                         "its own")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--replay", default=None,
                    help="a closure state (--dump): run both closers' "
                         "verification and correction from it, and stop")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    frames = args.frames or row_length(args.row)
    if args.replay:
        print(json.dumps(replay(args.replay, args.row, args.device,
                                args.width, args.features, args.levels),
                         indent=1), flush=True)
        return 0
    if args.device.startswith("cuda") and "port" in args.sides:
        from vieo_slam_tpu_torch.utils.device import nvidia_smi
        print(nvidia_smi(), flush=True)
    size = dict(width=args.width, features=args.features,
                levels=args.levels)
    meta = {"command": " ".join(["python3", "scripts/row_parity.py"]
                                + sys.argv[1:]),
            "commit": git_commit(), **size}
    for seed in (int(x) for x in str(args.seed).split(",")):
        for side in args.sides.split(","):
            t0 = time.perf_counter()
            if side == "jax":
                res, calls, tries = run_jax(args.row, seed, frames, **size,
                                            dump=bool(args.dump),
                                            vocabulary=args.vocabulary)
                import jax
                tag = "jax_cpu"
                meta["jax_version"] = jax.__version__
                meta["jax_side"] = "CPU, x64 off"
            else:
                res, calls, tries = run_port(args.row, seed, frames,
                                             args.device, **size,
                                             dump=bool(args.dump),
                                             vocabulary=args.vocabulary)
                tag = f"port_{args.device.split(':')[0]}"
            res["seconds"] = time.perf_counter() - t0
            res["verifications"] = [{k: v for k, v in t.items()
                                     if k != "state"} for t in tries]
            print(f"{tag} {args.row} seed {seed}, {frames} frames "
                  f"({res['seconds']:.1f} s): first OK frame "
                  f"{res['first_ok']}, LOST runs {res['lost_runs']} "
                  f"({res['n_lost']} frames)", flush=True)
            print(f"  states {res['states']}", flush=True)
            print(f"  keyframes made at frames {res['kf_frames']}",
                  flush=True)
            for c in res["init_calls"]:
                print(f"  monocular_init at frame {c['frame']} (key "
                      f"{c['key']}): {c['matches']} "
                      f"matches, ok {c['ok']}, {c['n_good']} good points",
                      flush=True)
            print("  candidate verifications (frame, k, c, closed) "
                  + str([tuple(t.values()) for t in res["verifications"]]),
                  flush=True)
            for c in res["closures"]:
                print(f"  closure at frame {c['frame']}: keyframe {c['k']} "
                      f"to {c['c']}, S_ck t {np.round(c['t'], 5).tolist()} "
                      f"s {c['s']:.6f}, keyframe ATE {c['ate_before']:.6g} "
                      f"-> {c['ate_after']:.6g} m, "
                      f"{c.get('fused')} fused", flush=True)
            if res["numbers"]:
                print("  " + ", ".join(f"{k} {v:.7g}"
                                       for k, v in res["numbers"].items()),
                      flush=True)
            if args.dump:
                stem = Path(args.dump) / f"{tag}_{args.row}_{seed}"
                dump(Path(f"{stem}.npz"), calls)
                for n, t in enumerate(x for x in tries if "state" in x):
                    name = "closure" if t["closed"] else f"try{n}"
                    np.savez_compressed(f"{stem}_{name}.npz", **t["state"])
            if args.out:
                merge_out(Path(args.out), meta, args.row, seed, tag, res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
