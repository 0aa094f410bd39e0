"""N-run image-level ATE evaluation over the scenario matrix.

Port of the JAX package's examples/evaluate_ntimes.py (the reference's
EvaluateEuRoC_Ntimes.sh pipeline): each sensor configuration runs N times
with different noise seeds, and the keyframe ATE (rmse, max) is recorded
without and with the final global BA, then averaged into a table.  Every
scenario runs pixels -> ORB -> matching -> tracking: the renderer stamps
per-landmark texture patches, hardened with photometric noise, brightness
drift, depth outliers (RGB-D) and moving landmarks.

Scenarios: stereo | stereo_async | rgbd | mono | stereo_vio | vieo | veo |
multicam_kb8 | multicam4_kb8 (the 60-frame 1/3 circle), the multi-lap
loop rows stereo_loop | mono_loop | vio_loop (an outward circle, 180
frames a lap), the figure-eight rows stereo_lem | vio_lem and the
recovery rows stereo_blackout | vio_blackout (12 black frames at 3/5 of
the run) | map_reuse (the map saved at 3/5, loaded into a fresh System).
veo_blackout (the wheel-encoder row through the blackout) is the port's
own, for its smoke run.

This module holds the one copy of the rows: `scenario` builds a row's
world, path, cameras and configuration, `Row` drives it frame by frame
(`prepare` renders, `track` builds the frame and tracks it, `finish`
runs the final global BA and returns the numbers), and `run_once` is the
JAX package's function on top of them.

Run: python -m vieo_slam_tpu_torch.examples.evaluate_ntimes [--n 3]
     [--frames 60] [--loop-frames 360] [--scenarios stereo_lem,vio_lem]
     [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..backend.loop_closing import LoopCloser, LoopClosingConfig
from ..cameras import models as cm
from ..frontend import frame as fr
from ..frontend.tracking import TrackerConfig
from ..io.evaluate import ate
from ..ops import orb
from ..sim import world as sim
from ..system import System, SystemConfig
from ..utils.device import resolve_device
from ..utils.metrics import metrics
from ..vio.encoder_frontend import EncoderConfig, EncoderFrontend
from ..vio.frontend import VioConfig, VioFrontend

# Photometric hardening applied to every rendered frame.
NOISE_SIGMA = 2.0
DYNAMIC_FRAC = 0.02
DEPTH_OUTLIER_FRAC = 0.07

# Multi-lap loop rows: outward-looking circle, 2 deg/frame of yaw, 180
# frames a lap, so each revisit needs place recognition.
LOOP_RADIUS = 1.5
LOOP_FRAMES_PER_LAP = 180

BASELINE = 0.2
FX = 400.0
# The KB8 rig of the multicam rows.
KB8_DIST = [0.02, 0.002, -0.001, 0.0005]
# The IMU biases of the VIO rows (noise 1e-4 and 1e-3, seed `seed + 100`).
VIO_BG = np.array([0.01, -0.02, 0.015], np.float32)
VIO_BA = np.array([0.05, 0.03, -0.04], np.float32)

# The sensor pipeline of each row whose name is not its own.
BASE = {"stereo_loop": "stereo", "mono_loop": "mono",
        "vio_loop": "stereo_vio",
        "stereo_lem": "stereo", "vio_lem": "stereo_vio",
        "stereo_blackout": "stereo", "vio_blackout": "stereo_vio",
        "veo_blackout": "veo", "map_reuse": "stereo",
        "multicam4_kb8": "multicam_kb8"}
STEREO_BASES = ("stereo", "stereo_async", "stereo_vio", "vieo", "veo")
_CTR_KEYS = ("state_LOST", "state_ODOMOK", "reloc_success")


def gain_bias(t):
    """Slow brightness drift (exposure wander on real cameras)."""
    return 1.0 + 0.10 * np.sin(0.5 * t), 8.0 * np.sin(0.3 * t)


def rig_cameras(width: int, n_cams: int):
    """The multicam rows' KB8 rig (fx 400, the principal point at the
    image centre): one horizontal pair at the stereo baseline and, for 4
    cameras, a second pair displaced by half the baseline in y; and the
    undistorted geometry camera."""
    offsets = [np.zeros(3), np.asarray([-BASELINE, 0, 0])]
    if n_cams == 4:
        offsets += [np.asarray([0, -0.5 * BASELINE, 0]),
                    np.asarray([-BASELINE, -0.5 * BASELINE, 0])]
    cams = [cm.make_kb8(FX, FX, width / 2.0, 240.0, KB8_DIST, width, 480,
                        Rcr=np.eye(3, dtype=np.float32),
                        tcr=off.astype(np.float32)) for off in offsets]
    return cams, cm.make_pinhole(FX, FX, width / 2.0, 240.0, width, 480)


def encoder_extrinsic(Rwc, v_w):
    """The rows' body-from-encoder rotation: x along the travel, z up, at
    the first frame (constant on a differential-drive circle)."""
    x_e = Rwc[0].T @ (v_w[0] / np.linalg.norm(v_w[0]))
    z_e = Rwc[0].T @ np.array([0.0, 0.0, 1.0])
    return np.stack([x_e, np.cross(z_e, x_e), z_e], axis=-1).astype(
        np.float64)


@dataclasses.dataclass
class Scenario:
    """One row's world, path, cameras and configuration."""
    name: str
    base: str                 # the sensor pipeline
    n_frames: int
    is_lem: bool
    is_loop: bool             # loop and figure-eight rows
    world_cfg: sim.WorldConfig
    ts: np.ndarray
    Rwc: np.ndarray
    twc: np.ndarray
    v_w: np.ndarray
    a_w: np.ndarray
    bo: tuple                 # black frames [start, end), or (-1, -1)
    reuse_at: int             # the frame the map is reloaded at, or -1
    cam: cm.Camera            # the tracking camera (a rig's geometry one)
    bf: float
    rig: list | None          # a rig's distorted cameras
    ocfg: orb.OrbConfig
    lc_cfg: LoopClosingConfig


def scenario(name: str, n_frames: int, width: int = 640,
             n_features: int | None = None, n_levels: int = 4) -> Scenario:
    """The JAX rows' setup.  `width` (cameras scaled from the rows' 640,
    the rig's focal length kept), `n_features` (default: 1000 for mono,
    600 otherwise) and `n_levels` run a row at another size."""
    base = BASE.get(name, name)
    is_lem = name.endswith("_lem")
    is_loop = name.endswith("_loop") or is_lem
    ts = np.arange(n_frames) * 0.1
    if is_lem:
        # Figure-eight, tangent heading: the yaw rate swings between -4.8
        # and +4.8 deg a frame, with yaw-acceleration spikes at the lobe
        # ends; each lap revisits every pose.
        world_cfg = sim.WorldConfig(n_landmarks=4000, seed=4,
                                    extent=(10.0, 7.0, 3.0),
                                    dynamic_frac=DYNAMIC_FRAC)
        Rwc, twc, v_w, a_w = sim.figure_eight_trajectory(
            ts, a=3.0, b=1.0, omega=2 * np.pi / (LOOP_FRAMES_PER_LAP * 0.1))
    elif is_loop:
        world_cfg = sim.WorldConfig(n_landmarks=4000, seed=4,
                                    extent=(8.0, 6.0, 3.0),
                                    dynamic_frac=DYNAMIC_FRAC)
        Rwc, twc, v_w, a_w = sim.circle_trajectory(
            ts, radius=LOOP_RADIUS,
            omega=2 * np.pi / (LOOP_FRAMES_PER_LAP * 0.1), look_outward=True)
    else:
        world_cfg = sim.WorldConfig(n_landmarks=2200, seed=4,
                                    extent=(6.0, 4.5, 3.0),
                                    dynamic_frac=DYNAMIC_FRAC)
        Rwc, twc, v_w, a_w = sim.circle_trajectory(ts, radius=1.0,
                                                   omega=0.35,
                                                   look_outward=True)
    # 12 black frames at 3/5 of the run: past the VIO final init, with
    # enough frames after the recovery to score it.
    bo = ((3 * n_frames) // 5, (3 * n_frames) // 5 + 12) \
        if name.endswith("_blackout") else (-1, -1)
    reuse_at = (3 * n_frames) // 5 if name == "map_reuse" else -1
    rig = None
    if base == "multicam_kb8":
        rig, cam = rig_cameras(width, 4 if name == "multicam4_kb8" else 2)
    else:
        s = width / 640.0
        cam = cm.make_pinhole(FX * s, FX * s, width / 2.0, 240.0, width, 480)
    if n_features is None:
        n_features = 1000 if base == "mono" else 600
    return Scenario(
        name=name, base=base, n_frames=n_frames, is_lem=is_lem,
        is_loop=is_loop, world_cfg=world_cfg, ts=ts, Rwc=Rwc, twc=twc,
        v_w=v_w, a_w=a_w, bo=bo, reuse_at=reuse_at, cam=cam,
        bf=cam.fx * BASELINE, rig=rig,
        ocfg=orb.OrbConfig(n_features=n_features, n_levels=n_levels),
        # mono closes with free scale; loop rows close only on a lap-old
        # revisit
        lc_cfg=LoopClosingConfig(min_kf_gap=30 if is_loop else 8,
                                 fix_scale=(base != "mono")))


class Row:
    """One run of a row, frame by frame: `step(i)` for each frame, then
    `finish()`.  `async_mapping` (default: the stereo_async row alone),
    `vio_cfg` (VioConfig fields over the row's) and `rig` ((distorted
    cameras, geometry camera) in place of the row's rig) vary the row."""

    def __init__(self, name: str, seed: int, n_frames: int, device=None,
                 width: int = 640, n_features: int | None = None,
                 n_levels: int = 4, *, async_mapping: bool | None = None,
                 vio_cfg: dict | None = None, rig=None):
        self.sc = sc = scenario(name, n_frames, width, n_features, n_levels)
        if rig is not None:
            sc.rig, sc.cam = rig
            sc.bf = sc.cam.fx * BASELINE
        self.dev = resolve_device(device)
        self.verbose = os.environ.get("EVAL_VERBOSE", "0") == "1"
        self.world = sim.SyntheticWorld(sc.world_cfg)
        self.Rcw, self.tcw = sim.trajectory_to_tcw(sc.Rwc, sc.twc)
        self.rng = np.random.RandomState(seed)      # the photometric noise
        self._ctr0 = {k: metrics.counters.get(k, 0) for k in _CTR_KEYS}
        if async_mapping is None:
            async_mapping = sc.base == "stereo_async"
        self.scfg = SystemConfig(
            tracker=TrackerConfig(use_predicted_scale=True),
            async_mapping=async_mapping)
        # (keyframe, candidate, keyframe ATE before, after) of each
        # closure, and the seconds these snapshots took (inside the
        # loop-closing stage)
        self.lc_events, self.hook_s = [], []
        self.system = self.front = self._new_system()
        self.imu = self.enc = None
        if sc.base in ("veo", "vieo"):
            Rbe = encoder_extrinsic(sc.Rwc, sc.v_w)
            self.enc = sim.make_encoder_samples(
                sc.ts, sc.Rwc.astype(np.float64), sc.twc.astype(np.float64),
                Rbe, np.zeros(3), rate_hz=100.0, half_track=0.28,
                noise_v=2e-3, seed=seed + 200)
            enc_cfg = dict(enc_half_track=0.28, enc_sigma_v=5e-3,
                           enc_Rbe=Rbe, enc_tbe=np.zeros(3))
        if sc.base == "veo":
            self.front = EncoderFrontend(self.system,
                                         cfg=EncoderConfig(**enc_cfg))
        elif sc.base in ("stereo_vio", "vieo"):
            self.imu = sim.make_imu_samples(
                sc.ts, sc.Rwc.astype(np.float64), sc.v_w, sc.a_w,
                rate_hz=200.0, bg=VIO_BG, ba=VIO_BA, noise_g=1e-4,
                noise_a=1e-3, seed=seed + 100)
            self.front = VioFrontend(self.system, cfg=VioConfig(**{
                "init_min_kfs": 10, "init_min_span": 3.0,
                **(dict(use_encoder=True, **enc_cfg) if self.enc else {}),
                **(vio_cfg or {})}))
        self.states, self.view_stats, self.frame = [], [], None
        self._i_imu = self._i_enc = 0

    def _new_system(self) -> System:
        sc = self.sc
        system = System(sc.cam, sc.bf, self.scfg, device=self.dev)
        system.loop_closer = lc = LoopCloser(sc.cam, sc.bf, system.map,
                                             sc.lc_cfg, device=self.dev)
        if sc.is_loop:
            correct = lc._correct_loop

            def hooked(k, c, S_ck):
                t0 = time.perf_counter()
                pre = self.kf_ate()["rmse"]
                dt = time.perf_counter() - t0
                correct(k, c, S_ck)
                t0 = time.perf_counter()
                self.lc_events.append((k, c, pre, self.kf_ate()["rmse"]))
                self.hook_s.append(dt + time.perf_counter() - t0)

            lc._correct_loop = hooked
        return system

    def kf_ate(self, t_min: float = -1.0) -> dict:
        """Keyframe ATE (rmse, max) of the keyframes after t_min, their
        timestamps rounded to f32 as the JAX rows keep them (x64 off) and
        compared in f64; similarity-aligned for mono."""
        m = self.system.map
        kfs = m.keyframe_ids()
        t_kf = m.kf_timestamp[kfs].astype(np.float32).astype(np.float64)
        kfs = kfs[t_kf > t_min]
        if len(kfs) < 2:
            # no keyframes in the window (the recovery never happened)
            return {"rmse": float("nan"), "max": float("nan")}
        p = np.stack([-(m.kf_Rcw[k].T @ m.kf_tcw[k]) for k in kfs])
        return ate(m.kf_timestamp[kfs], p, self.sc.ts, self.sc.twc,
                   with_scale=(self.sc.base == "mono"))

    def _reuse_map(self):
        """Map reuse: save the map, then a fresh System and LoopCloser
        load it and the run goes on (it must relocalize against it)."""
        fd, path = tempfile.mkstemp(suffix=".npz")
        os.close(fd)
        try:
            self.system.save_map(path)
            self.system.shutdown()
            self.system = self.front = self._new_system()
            self.system.load_map(path)
        finally:
            os.unlink(path)

    def prepare(self, i: int) -> list:
        """Frame i's host side: the map reuse, the odometry up to its
        time and its rendered images (black in the blackout)."""
        sc, t = self.sc, float(self.sc.ts[i])
        if i == sc.reuse_at:
            self._reuse_map()
        if self.imu is not None:
            t_imu, gyro, acc = self.imu
            while self._i_imu < len(t_imu) and t_imu[self._i_imu] <= t:
                j = self._i_imu
                self.front.track_odom(t_imu[j], gyro[j], acc[j])
                self._i_imu += 1
        if self.enc is not None:
            t_enc, v_l, v_r = self.enc
            while self._i_enc < len(t_enc) and t_enc[self._i_enc] <= t:
                j = self._i_enc
                self.front.track_encoder(t_enc[j], v_l[j], v_r[j])
                self._i_enc += 1
        g, b = gain_bias(t)
        hard = dict(t=t, noise_sigma=NOISE_SIGMA, gain=g, bias=b,
                    rng=self.rng)
        R, tc = self.Rcw[i], self.tcw[i]
        if sc.base in STEREO_BASES:
            images = list(self.world.render_stereo(sc.cam, R, tc, BASELINE,
                                                   **hard))
        elif sc.base == "rgbd":
            images = list(self.world.render_view(
                sc.cam, R, tc, return_depth=True,
                depth_outlier_frac=DEPTH_OUTLIER_FRAC, **hard))
        elif sc.base == "mono":
            images = [self.world.render_view(sc.cam, R, tc, **hard)]
        else:
            images = [self.world.render_view(c, c.Rcr @ R, c.Rcr @ tc + c.tcr,
                                             **hard) for c in sc.rig]
        if sc.bo[0] <= i < sc.bo[1]:
            # sensor blackout (lens cover, exposure failure)
            images = [np.zeros_like(x) for x in images]
        return images

    def track(self, i: int, images: list):
        """Build frame i from its images on the device and track it;
        returns the tracking state."""
        sc, t, dev = self.sc, float(self.sc.ts[i]), self.dev
        ims = [torch.from_numpy(x).to(dev) for x in images]
        if sc.base in STEREO_BASES:
            frame = fr.build_stereo_frame(
                *ims, sc.ocfg, bf=sc.bf, min_depth=0.3, max_depth=15.0,
                timestamp=t, device=dev)
        elif sc.base == "rgbd":
            frame = fr.build_rgbd_frame(*ims, sc.ocfg, bf=sc.bf, timestamp=t,
                                        device=dev)
        elif sc.base == "mono":
            frame = fr.build_mono_frame(ims[0], sc.ocfg, timestamp=t,
                                        device=dev)
        else:
            frame, pv = fr.build_multicam_frame(
                ims, sc.rig, sc.ocfg, geom_cam=sc.cam, virt_bf=sc.bf,
                max_depth=15.0, timestamp=t, return_stats=True, device=dev)
            # per partner view: matches, accepted triangulations, mean
            # squared two-view error
            self.view_stats.append([(float(v["matches"]),
                                     float(v["accepted"]),
                                     float(v["mean_err2"])) for v in pv])
        state = self.front.track_frame(frame)
        self.frame = frame
        self.states.append(state.name)
        if self.verbose:
            print(f"  [{i:3d}] {state.name:7s} "
                  f"kf={self.system.map.n_keyframes():3d}", flush=True)
        return state

    def step(self, i: int):
        return self.track(i, self.prepare(i))

    def counter(self, key: str) -> float:
        """This run's count of a global counter."""
        return float(metrics.counters.get(key, 0) - self._ctr0[key])

    def finish(self) -> dict:
        """The final global BA, then the JAX row's numbers: the keyframe
        ATE without and with it, and the row's own columns."""
        sc = self.sc
        self.system.wait_idle()
        pre = self.kf_ate()
        self.system.final_global_ba()
        post = self.kf_ate()
        self.system.shutdown()
        out = {"rmse_noFullBA": pre["rmse"], "max_noFullBA": pre["max"],
               "rmse_fullBA": post["rmse"], "max_fullBA": post["max"]}
        if self.view_stats:
            arr = np.asarray(self.view_stats)        # [frames, views, 3]
            for v in range(arr.shape[1]):
                out[f"view{v + 1}_tri_per_frame"] = float(arr[:, v, 1].mean())
                out[f"view{v + 1}_mean_err2"] = float(np.nanmean(
                    np.where(arr[:, v, 1] > 0, arr[:, v, 2], np.nan)))
        if sc.is_loop:
            first = self.lc_events[0] if self.lc_events else \
                (None, None, float("nan"), float("nan"))
            out["loops_closed"] = float(len(self.lc_events))
            out["rmse_preLC"], out["rmse_postLC"] = first[2], first[3]
            out["fused_points"] = float(
                self.system.loop_closer.total_fuse_count)
        if sc.is_lem:
            out["n_lost"] = self.counter("state_LOST")
            out["n_relocs"] = self.counter("reloc_success")
        if sc.bo[0] >= 0 or sc.reuse_at >= 0:
            out["n_lost"] = self.counter("state_LOST")
            out["n_odomok"] = self.counter("state_ODOMOK")
            out["n_relocs"] = self.counter("reloc_success")
            t_rec = float(sc.ts[sc.bo[1]] if sc.bo[0] >= 0
                          else sc.ts[sc.reuse_at])
            out["rmse_postRecovery"] = self.kf_ate(t_min=t_rec)["rmse"]
        return out


def run_once(scenario: str, seed: int, n_frames: int, device=None,
             width: int = 640, n_features: int | None = None,
             n_levels: int = 4) -> dict:
    """One run of a row; the JAX package's keys."""
    row = Row(scenario, seed, n_frames, device, width, n_features, n_levels)
    for i in range(n_frames):
        row.step(i)
    return row.finish()


ALL = ("stereo,stereo_async,rgbd,mono,stereo_vio,vieo,veo,"
       "multicam_kb8,multicam4_kb8")
LOOP_SCENARIOS = "stereo_loop,mono_loop,vio_loop"
LEM_SCENARIOS = "stereo_lem,vio_lem"
RECOVERY_SCENARIOS = "stereo_blackout,vio_blackout,map_reuse"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=11,
                    help="base seed (seed_i = seed0 + 7*i); lets one "
                         "row's N runs split across parallel processes")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--loop-frames", type=int, default=360,
                    help="frames for *_loop scenarios (2 laps at 180/lap)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--scenarios", default=",".join(
        (ALL, LOOP_SCENARIOS, LEM_SCENARIOS, RECOVERY_SCENARIOS)))
    ap.add_argument("--out", default=None,
                    help="write the aggregate table as JSON")
    args = ap.parse_args(argv)

    table = {}
    for sc in args.scenarios.split(","):
        nf = args.loop_frames \
            if sc.endswith(("_loop", "_lem")) else args.frames
        rows = []
        for run in range(args.n):
            r = run_once(sc, seed=args.seed0 + run * 7, n_frames=nf,
                         device=args.device)
            rows.append(r)
            print(f"{sc} run {run}: " + " ".join(
                f"{k}={v:.4f}" for k, v in r.items()), flush=True)
        agg = {"image_level": True}
        if sc.endswith("_loop"):
            agg["frames"] = nf
            agg["laps"] = round(nf / LOOP_FRAMES_PER_LAP, 2)
        for k in rows[0]:
            vals = np.asarray([r[k] for r in rows])
            # nan-aware: a loop row with zero closures reports NaN for
            # its pre/post-closure columns
            agg[f"avg_{k}"] = round(float(np.nanmean(vals)), 4)
            agg[f"med_{k}"] = round(float(np.nanmedian(vals)), 4)
        table[sc] = agg

    print("\n== aggregate (m) ==")
    hdr = ["scenario", "avg_rmse_fullBA", "med_rmse_fullBA",
           "avg_rmse_noFullBA", "avg_max_fullBA"]
    print(" | ".join(f"{h:>18}" for h in hdr))
    for sc, agg in table.items():
        print(" | ".join([f"{sc:>18}"] + [
            f"{agg.get(h, float('nan')):>18.4f}" for h in hdr[1:]]))
    print(json.dumps(table))
    if args.out:
        meta = {"n_runs": args.n, "frames": args.frames,
                "loop_frames": args.loop_frames,
                "loop_frames_per_lap": LOOP_FRAMES_PER_LAP,
                "renderer_hardening": {
                    "noise_sigma": NOISE_SIGMA,
                    "brightness_drift": "gain 1±0.10, bias ±8",
                    "dynamic_landmark_frac": DYNAMIC_FRAC,
                    "rgbd_depth_outlier_frac": DEPTH_OUTLIER_FRAC}}
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "scenarios": table}, f, indent=1)
    return table


if __name__ == "__main__":
    main()
