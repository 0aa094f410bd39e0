#!/usr/bin/env python3
"""Run the first frames of one row of evaluate_ntimes.py with the JAX
package (on the CPU, x64 off, as its rows run) and with the port (on a
GPU or the CPU), and print where each initializes and goes LOST.

    python3 scripts/row_parity.py --row mono_loop --seed 11 --frames 60 \
        [--sides jax,port] [--device cuda] [--dump DIR] [--out FILE]
    python3 scripts/row_parity.py --row smoke_mono --seed 0

The row smoke_mono is chip_smoke.py phase 7's mono sequence instead of a
row of evaluate_ntimes.py: chip_smoke.scene at 640x480 in the mono row's
world (MONO_WORLD, MONO_OMEGA), rendered with the rows' photometric noise
and drift from the noise seed (phase 7's is 0), built with 1000 features
on 4 levels and the fused keypoint tail (the port's tail kernel B5, or its
plain twin on the CPU; the JAX package's TPU branch, forced on the CPU),
tracked by a mono System with a 4096-landmark slab and no loop closer.
Its numbers are the scale-aligned ATE RMSE of the OK frames.

Each side runs the row at its own size (640x480, 1000 features for mono
and 600 otherwise, 4 levels) and length (360 frames for a loop or
figure-eight row, 60 otherwise: the blackout sits at 3/5 of it), frame by
frame up to --frames.  For each side it prints the state of every frame
as one string (. OK, L LOST, o ODOMOK, n not initialized), the first OK
frame (the two-view init of a mono row), the LOST runs as (first, last)
frames, and every call of monocular_init with its frame, its matches and
its verdict.  With --dump, each call's (uv1, uv2, valid) and result go to
DIR/<side>_<device>_<row>_<seed>.npz, so that two runs' inputs can be
compared call by call.

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
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LETTER = {"OK": ".", "LOST": "L", "ODOMOK": "o", "NOT_INITIALIZED": "n"}
SMOKE_MONO = "smoke_mono"


def row_length(row: str) -> int:
    return 360 if row.endswith(("_loop", "_lem")) else 60


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


def summary(states: list, calls: list) -> dict:
    letters = "".join(LETTER.get(s, "?") for s in states)
    runs = [(m.start(), m.end() - 1) for m in re.finditer("L+", letters)]
    return {"states": letters,
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


def run_jax(row: str, seed: int, frames: int) -> dict:
    """The JAX example's run_once over the row's first frames, its
    per-frame states read from its EVAL_VERBOSE lines."""
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from vieo_slam_tpu import system as jsystem
    from vieo_slam_tpu.solvers import initializer as jinit

    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_ntimes", ROOT / "examples" / "evaluate_ntimes.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    calls, frame_of = [], {"i": -1}
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
        return track(self, *a, **kw)

    jsystem.System.track_frame = counted
    if row == SMOKE_MONO:
        states, out = jax_smoke_mono(seed, frames)
        return {**summary(states, calls), "numbers": out}, calls
    if row_length(row) != frames and (row.endswith("_blackout")
                                      or row == "map_reuse"):
        raise SystemExit("a recovery row's events depend on its length: "
                         "run all of its frames")
    os.environ["EVAL_VERBOSE"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = ex.run_once(row, seed, frames)
    finally:
        del os.environ["EVAL_VERBOSE"]
    states = re.findall(r"^\s+\[\s*\d+\]\s+(\w+)", buf.getvalue(), re.M)
    return {**summary(states, calls), "numbers": out}, calls


def run_port(row: str, seed: int, frames: int, device: str) -> dict:
    import torch

    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.solvers import initializer as tinit

    if device.startswith("cuda"):
        from vieo_slam_tpu_torch.ops import cuda_build
        cuda_build.build_all(verbose=False)
    calls, orig, frame_of = [], tinit.monocular_init, {"i": 0}

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
    if row == SMOKE_MONO:
        states, out = port_smoke_mono(seed, frames, device, frame_of)
    else:
        r = ev.Row(row, seed, row_length(row), device)
        for i in range(frames):
            frame_of["i"] = i
            r.step(i)
        states = r.states
        out = r.finish() if frames == row_length(row) else None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {**summary(states, calls), "numbers": out}, calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", default="mono_loop")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to run (default: the whole row)")
    ap.add_argument("--sides", default="jax,port")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the JAX side runs on the CPU)")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    frames = args.frames or row_length(args.row)
    if args.device.startswith("cuda"):
        from vieo_slam_tpu_torch.utils.device import nvidia_smi
        print(nvidia_smi(), flush=True)
    report = {"row": args.row, "seed": args.seed, "frames": frames}
    for side in args.sides.split(","):
        t0 = time.perf_counter()
        if side == "jax":
            res, calls = run_jax(args.row, args.seed, frames)
            tag = "jax_cpu"
        else:
            res, calls = run_port(args.row, args.seed, frames, args.device)
            tag = f"port_{args.device.split(':')[0]}"
        res["seconds"] = time.perf_counter() - t0
        report[tag] = res
        print(f"{tag} {args.row} seed {args.seed}, {frames} frames "
              f"({res['seconds']:.1f} s): first OK frame {res['first_ok']}, "
              f"LOST runs {res['lost_runs']} ({res['n_lost']} frames)",
              flush=True)
        print(f"  states {res['states']}", flush=True)
        for c in res["init_calls"]:
            print(f"  monocular_init at frame {c['frame']} (key "
                  f"{c['key']}): {c['matches']} "
                  f"matches, ok {c['ok']}, {c['n_good']} good points",
                  flush=True)
        if res["numbers"]:
            print("  " + ", ".join(f"{k} {v:.5g}"
                                   for k, v in res["numbers"].items()),
                  flush=True)
        if args.dump:
            dump(Path(args.dump) / f"{tag}_{args.row}_{args.seed}.npz",
                 calls)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
