"""Synthetic worlds for end-to-end runs of the image pipeline.

Port of the pixel-rendering part of vieo_slam_tpu/sim/world.py: a field
of landmarks with fixed texture stamps, rendered through a pinhole camera
into grayscale views (optionally with a per-pixel depth map, photometric
noise and brightness drift) and stereo pairs, plus the circle trajectory
and the IMU stream along a trajectory.
A fraction of the landmarks may oscillate through the world (dynamic
scene content).  Numpy, with the port's own `cameras.project`; the same
seed gives the same world and the same images as the JAX package's
renderer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cameras import models as cm
from ..math import lie


@dataclasses.dataclass
class WorldConfig:
    n_landmarks: int = 3000
    extent: tuple = (20.0, 12.0, 6.0)   # x, y, z box size
    seed: int = 0
    # This fraction of the landmarks oscillates through the world
    # (non-rigid outliers, as moving objects are on real sequences).
    dynamic_frac: float = 0.0
    dynamic_amp: float = 0.4            # metres of peak excursion
    dynamic_omega: float = 1.3          # rad/s


class SyntheticWorld:
    """Landmark field + descriptor bank + texture stamps."""

    def __init__(self, cfg: WorldConfig = WorldConfig()):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        e = np.asarray(cfg.extent)
        n = cfg.n_landmarks
        pts = rng.rand(n, 3) * e - e / 2
        face = rng.randint(0, 4, n)
        pts[face == 0, 0] = -e[0] / 2     # walls
        pts[face == 1, 0] = e[0] / 2
        pts[face == 2, 1] = -e[1] / 2
        pts[face == 3, 1] = e[1] / 2
        self.pw = pts.astype(np.float32)
        # The JAX package's world draws its descriptor bank next, with the
        # same generator, so the same seed gives the same descriptors.
        self.desc = rng.randint(0, 2 ** 32, (n, 8), np.uint64).astype(
            np.uint32)
        # The JAX world's octave and saliency draws (its feature-level
        # observer's), kept so that the dynamic subset below is drawn from
        # the same generator state.
        rng.randint(0, 3, n)
        rng.rand(n)
        self._patches = None
        n_dyn = int(round(cfg.dynamic_frac * n))
        self.dynamic_ids = rng.choice(n, n_dyn, replace=False) \
            if n_dyn else np.zeros(0, np.int64)
        self._dyn_dir = rng.randn(n_dyn, 3).astype(np.float32)
        if n_dyn:
            self._dyn_dir /= np.linalg.norm(self._dyn_dir, axis=1,
                                            keepdims=True)
        self._dyn_phase = rng.rand(n_dyn).astype(np.float32) * 2 * np.pi

    def pw_at(self, t: float) -> np.ndarray:
        """Landmark positions at time t (the dynamic subset oscillates)."""
        if not len(self.dynamic_ids):
            return self.pw
        pw = self.pw.copy()
        off = np.sin(self.cfg.dynamic_omega * t + self._dyn_phase)
        pw[self.dynamic_ids] += (self.cfg.dynamic_amp
                                 * off[:, None] * self._dyn_dir)
        return pw

    def _landmark_patches(self, size: int = 12):
        """Per-landmark fixed texture stamp: a 2x-upsampled random block
        pattern, constant across views."""
        if self._patches is None:
            rng = np.random.RandomState(self.cfg.seed + 7777)
            n = self.cfg.n_landmarks
            coarse = rng.randint(30, 226, (n, size // 2, size // 2))
            self._patches = np.repeat(
                np.repeat(coarse, 2, axis=1), 2, axis=2).astype(np.float32)
        return self._patches

    def render_view(self, cam: cm.Camera, Rcw, tcw, *, bg_level: float = 96.0,
                    min_depth: float = 0.2, t: float = 0.0,
                    noise_sigma: float = 0.0,
                    gain: float = 1.0, bias: float = 0.0, rng=None,
                    return_depth: bool = False,
                    depth_outlier_frac: float = 0.0):
        """Grayscale [H, W] f32 view: each visible landmark stamps its
        texture at its projected sub-pixel position (bilinear shift),
        far to near, over a flat background.

        t: scene time (dynamic landmarks move); noise_sigma: additive
        Gaussian photometric noise (drawn from `rng`,
        a numpy RandomState, or numpy's global generator); gain/bias:
        brightness drift I' = gain * I + bias; return_depth: also return
        the per-pixel depth map of an RGB-D sensor (0 = no reading), with
        depth_outlier_frac of the landmark stamps carrying a corrupted
        depth."""
        H, W = cam.height, cam.width
        img = np.full((H, W), bg_level, np.float32)
        depth_map = np.zeros((H, W), np.float32) if return_depth else None
        pc = self.pw_at(t) @ np.asarray(Rcw).T + np.asarray(tcw)
        uv = cm.project(cam, torch.from_numpy(
            np.ascontiguousarray(pc, np.float32))).numpy()
        patches = self._landmark_patches()
        P = patches.shape[1]
        h = P // 2
        vis = ((pc[:, 2] > min_depth)
               & (uv[:, 0] >= h + 1) & (uv[:, 0] < W - h - 2)
               & (uv[:, 1] >= h + 1) & (uv[:, 1] < H - h - 2))
        order = np.argsort(-pc[vis, 2], kind="stable")
        if depth_map is not None and depth_outlier_frac > 0:
            r_out = rng if rng is not None else np.random
            outlier = r_out.rand(len(self.pw)) < depth_outlier_frac
            out_scale = 1.0 + (r_out.rand(len(self.pw)) - 0.3)
        for li in np.nonzero(vis)[0][order]:
            u, v = uv[li]
            iu, iv = int(np.floor(u)), int(np.floor(v))
            fu, fv = u - iu, v - iv
            pp = np.pad(patches[li], 1, mode="edge")
            p00 = pp[0:P, 0:P]
            p01 = pp[0:P, 1:P + 1]
            p10 = pp[1:P + 1, 0:P]
            p11 = pp[1:P + 1, 1:P + 1]
            sh = ((1 - fv) * (1 - fu) * p11 + (1 - fv) * fu * p10
                  + fv * (1 - fu) * p01 + fv * fu * p00)
            img[iv - h + 1: iv + P - h + 1, iu - h + 1: iu + P - h + 1] = sh
            if depth_map is not None:
                z = pc[li, 2]
                if depth_outlier_frac > 0 and outlier[li]:
                    z = z * out_scale[li]
                depth_map[iv - h + 1: iv + P - h + 1,
                          iu - h + 1: iu + P - h + 1] = z
        img = gain * img + bias
        if noise_sigma > 0:
            r = rng if rng is not None else np.random
            img = img + r.randn(H, W).astype(np.float32) * noise_sigma
        img = np.clip(img, 0.0, 255.0).astype(np.float32)
        if return_depth:
            return img, depth_map
        return img

    def render_stereo(self, cam: cm.Camera, Rcw, tcw, baseline: float, **kw):
        """Rectified stereo pair: right camera displaced +baseline along
        the left camera's x axis."""
        left = self.render_view(cam, Rcw, tcw, **kw)
        tcw_r = np.asarray(tcw) - np.asarray([baseline, 0.0, 0.0], np.float32)
        return left, self.render_view(cam, Rcw, tcw_r, **kw)


def circle_trajectory(t, radius=4.0, omega=0.3, z=0.0, look_outward=False,
                      z_amp=0.0, z_omega=1.1, pitch_amp=0.0, pitch_omega=0.8):
    """Camera circling the origin looking inward (or outward), with
    optional vertical bobbing (z_amp) and nodding (pitch_amp): a flat
    yaw-only circle leaves the accelerometer bias along gravity
    unobservable, so VIO runs want some excitation.

    Returns (Rwc [T, 3, 3], twc [T, 3], v_w [T, 3], a_w [T, 3]):
    world-from-camera poses and the world velocity and acceleration
    (without gravity), f32."""
    t = np.asarray(t, np.float64)
    ang = omega * t
    zt = z + z_amp * np.sin(z_omega * t)
    pos = np.stack([radius * np.cos(ang), radius * np.sin(ang), zt], -1)
    fwd = -np.stack([pos[:, 0], pos[:, 1], np.zeros_like(ang)], -1)
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    if look_outward:
        fwd = -fwd
    if pitch_amp:
        th = pitch_amp * np.sin(pitch_omega * t)
        fwd = np.stack([fwd[:, 0] * np.cos(th), fwd[:, 1] * np.cos(th),
                        np.sin(th)], -1)
    up = np.tile([0.0, 0.0, -1.0], (len(t), 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    Rwc = np.stack([right, down, fwd], axis=-1)  # columns = cam axes
    v = np.stack([-radius * omega * np.sin(ang),
                  radius * omega * np.cos(ang),
                  z_amp * z_omega * np.cos(z_omega * t)], -1)
    a_w = np.stack([-radius * omega ** 2 * np.cos(ang),
                    -radius * omega ** 2 * np.sin(ang),
                    -z_amp * z_omega ** 2 * np.sin(z_omega * t)], -1)
    return (Rwc.astype(np.float32), pos.astype(np.float32),
            v.astype(np.float32), a_w.astype(np.float32))


def trajectory_to_tcw(Rwc, twc):
    Rcw = np.swapaxes(Rwc, -1, -2)
    tcw = -np.einsum("tij,tj->ti", Rcw, twc)
    return Rcw.astype(np.float32), tcw.astype(np.float32)


def body_rates_from_poses(Rwb, t):
    """Angular velocity in the body frame from a rotation sequence, by
    finite differences."""
    dR = np.einsum("tji,tjk->tik", Rwb[:-1], Rwb[1:])
    dt = np.maximum(np.diff(np.asarray(t, np.float64)), 1e-9)
    w = np.zeros((len(t), 3), np.float32)
    w[1:] = _so3_log(dR) / dt[:, None]
    w[0] = w[1]
    return w


def _so3_log(R):
    return lie.so3_log(torch.from_numpy(np.ascontiguousarray(R))).numpy()


def interp(t_out, t_in, vals):
    """Per-channel linear interpolation of vals [T, C] at t_out."""
    return np.stack([np.interp(t_out, t_in, vals[:, i])
                     for i in range(vals.shape[1])], -1)


def make_imu_samples(t_frames, Rwb, v_w, a_w, rate_hz=200.0,
                     gravity=(0.0, 0.0, -9.81), bg=None, ba=None,
                     noise_g=0.0, noise_a=0.0, seed=0):
    """A dense IMU stream between the frame timestamps: gyro = the body
    rates, acc = R_wb^T (a_w - g) at the attitude interpolated on SO(3)
    between frames, plus biases and white noise (numpy RandomState(seed)).
    Returns (t [S] f64, gyro [S, 3], acc [S, 3])."""
    rng = np.random.RandomState(seed)
    ts = np.arange(t_frames[0], t_frames[-1], 1.0 / rate_hz)
    g = np.asarray(gravity)
    bg = np.zeros(3) if bg is None else np.asarray(bg)
    ba = np.zeros(3) if ba is None else np.asarray(ba)
    w_b = interp(ts, t_frames, body_rates_from_poses(Rwb, t_frames))
    a_world = interp(ts, t_frames, a_w)
    i1 = np.clip(np.searchsorted(t_frames, ts, side="right"), 1,
                 len(t_frames) - 1)
    i0 = i1 - 1
    denom = np.maximum(t_frames[i1] - t_frames[i0], 1e-9)
    frac = np.clip((ts - t_frames[i0]) / denom, 0.0, 1.0)
    R0, R1 = Rwb[i0], Rwb[i1]
    dphi = _so3_log(np.einsum("tji,tjk->tik", R0, R1))
    dRot = lie.so3_exp(torch.from_numpy(
        np.ascontiguousarray(dphi * frac[:, None]))).numpy()
    Rb = np.einsum("tij,tjk->tik", R0, dRot)
    a_b = np.einsum("tij,ti->tj", Rb, a_world - g)   # R^T (a - g)
    gyro = w_b + bg + rng.randn(*w_b.shape) * noise_g
    acc = a_b + ba + rng.randn(*a_b.shape) * noise_a
    return ts.astype(np.float64), gyro.astype(np.float32), \
        acc.astype(np.float32)
