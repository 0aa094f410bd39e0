"""A cell's inputs and its system under test, built from its files.

`Sequence` renders the traffic mix of a configuration from the run's seed
(the same seed gives the same images and IMU samples); `Sut` builds the
program's System (and VioFrontend) from the configuration and hands it one
frame at a time.  Sensors: "stereo" (rectified pair) and "stereo_imu" (the
pair plus the IMU stream, through a VioFrontend).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import generator as gen
from . import render

SENSORS = ("stereo", "stereo_imu")


def seeds(seed: int, n: int) -> list[int]:
    """n 32-bit seeds drawn from the run's seed (any whole number)."""
    state = np.random.SeedSequence(int(seed)).generate_state(n)
    return [int(x) for x in state]


def camera(config: dict) -> dict:
    c = config["camera"]
    return {k: c[k] for k in ("fx", "fy", "cx", "cy", "width", "height")}


class Sequence:
    """The rendered frames (uint8 [F, 2, H, W] on `dev`), their timestamps,
    the true camera poses and, for "stereo_imu", the IMU samples."""

    def __init__(self, config: dict, traffic: dict, seed: int, dev,
                 n_frames: int | None = None):
        if config["sensor"] not in SENSORS:
            raise ValueError(f"sensor {config['sensor']!r} is not one of "
                             f"{SENSORS}")
        if traffic["path"] != "circle":
            raise ValueError(f"path {traffic['path']!r}: only 'circle'")
        s_noise, s_imu = seeds(seed, 2)
        w = config["world"]
        self.world = gen.SyntheticWorld(gen.WorldConfig(
            n_landmarks=w["n_landmarks"], seed=w["seed"],
            extent=tuple(w["extent"]), dynamic_frac=w["dynamic_frac"]))
        self.cam = camera(config)
        c = config["camera"]
        self.baseline = c["bf"] / c["fx"]
        F = int(n_frames or traffic["frames"])
        dt = 1.0 / c["fps"]
        omega = traffic["laps"] * 2 * np.pi / (traffic["frames"] * dt)
        # Every seed flies the same path through the same room: the seed
        # draws the sensors' noise, so that each run does the same work.
        self.ts = np.arange(F) * dt
        Rwc, twc, v_w, a_w = gen.circle_trajectory(
            self.ts, radius=traffic["radius"], omega=omega,
            look_outward=traffic["look_outward"])
        self.Rwc, self.twc = Rwc, twc
        self.Rcw, self.tcw = gen.trajectory_to_tcw(Rwc, twc)
        if w.get("brightness_drift"):
            gains, biases = gen.gain_bias(self.ts)
        else:
            gains, biases = np.ones(F), np.zeros(F)
        self.images = render.render_stereo_sequence(
            self.world, self.cam, self.baseline, self.Rcw, self.tcw, self.ts,
            gains, biases, w["noise_sigma"], s_noise, dev)
        self.imu = None
        if config["sensor"] == "stereo_imu":
            m = config["imu"]
            self.imu = gen.make_imu_samples(
                self.ts, Rwc.astype(np.float64), v_w, a_w,
                rate_hz=m["rate_hz"], bg=np.asarray(m["bg"], np.float32),
                ba=np.asarray(m["ba"], np.float32), noise_g=m["noise_g"],
                noise_a=m["noise_a"], seed=s_imu)

    def __len__(self):
        return len(self.ts)


def _fields(cls, values: dict, **nested):
    """cls(**values), nested dataclass fields built from their dicts."""
    kw = dict(values)
    for key, sub in nested.items():
        if key in kw:
            kw[key] = sub(**kw[key])
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kw)


class Sut:
    """The system under test: the program's System (with its LoopCloser)
    and, for "stereo_imu", its VioFrontend; `step(i)` hands over frame i
    and returns its tracking state."""

    def __init__(self, config: dict, seq: Sequence, dev):
        from vieo_slam_tpu_torch.backend.loop_closing import (
            LoopCloser, LoopClosingConfig)
        from vieo_slam_tpu_torch.backend.local_mapping import (
            LocalMappingConfig)
        from vieo_slam_tpu_torch.cameras import models as cm
        from vieo_slam_tpu_torch.frontend import frame as fr
        from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
        from vieo_slam_tpu_torch.ops import orb
        from vieo_slam_tpu_torch.system import System, SystemConfig
        from vieo_slam_tpu_torch.vio.frontend import VioConfig, VioFrontend

        self.fr = fr
        self.dev = dev
        self.seq = seq
        c = config["camera"]
        self.cam = cm.make_pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                                   c["width"], c["height"])
        self.bf = float(c["bf"])
        self.ocfg = orb.OrbConfig(**config["orb"])
        self.stereo = config["stereo"]
        scfg = _fields(SystemConfig, config["system"],
                       tracker=lambda **k: TrackerConfig(**k),
                       mapper=lambda **k: LocalMappingConfig(**k))
        self.system = System(self.cam, self.bf, scfg, device=dev)
        if config.get("loop_closing") is not None:
            self.system.loop_closer = LoopCloser(
                self.cam, self.bf, self.system.map,
                LoopClosingConfig(**config["loop_closing"]), device=dev)
        self.front = self.system
        self.vio = None
        if config["sensor"] == "stereo_imu":
            self.vio = self.front = VioFrontend(
                self.system, cfg=VioConfig(**config["vio"]))
            self._i_imu = 0
        self.frame = None        # the last frame built

    def feed_imu(self, i: int):
        """The IMU samples up to frame i's time, as the sensor delivers them."""
        t_imu, gyro, acc = self.seq.imu
        t = self.seq.ts[i]
        j = self._i_imu
        while j < len(t_imu) and t_imu[j] <= t:
            self.vio.track_odom(t_imu[j], gyro[j], acc[j])
            j += 1
        self._i_imu = j

    def build(self, i: int):
        left, right = self.seq.images[i]
        self.frame = self.fr.build_stereo_frame(
            left, right, self.ocfg, bf=self.bf,
            min_depth=self.stereo["min_depth"],
            max_depth=self.stereo["max_depth"],
            timestamp=float(self.seq.ts[i]), device=self.dev)
        return self.frame

    def track(self, frame):
        return self.front.track_frame(frame)

    def step(self, i: int):
        if self.vio is not None:
            self.feed_imu(i)
        return self.track(self.build(i))

    def pose(self):
        """The pose (Rcw, tcw) the last frame returned, on the host."""
        tr = self.system.tracker
        return tr.Rcw, tr.tcw

    def fused_ready(self) -> bool:
        """VIO: past the init's final acceptance, with a fused frame."""
        return bool(self.vio is not None and self.vio.final_inited)

    def shutdown(self):
        self.system.shutdown()
