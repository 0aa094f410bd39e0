"""Synthetic worlds for end-to-end runs of the image pipeline.

Port of vieo_slam_tpu/sim/world.py: a field of landmarks with fixed
texture stamps, rendered through any camera model into grayscale views
(optionally with a per-pixel depth map, photometric noise and brightness
drift) and stereo pairs; the feature-level observer (`observe`: a frame's
keypoints straight from the landmarks, for system runs without images);
the circle and figure-eight trajectories; and the IMU and wheel-encoder
streams along a trajectory.
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
        self.level = rng.randint(0, 3, n).astype(np.int32)
        # Persistent per-landmark saliency: a detector fires on the same
        # corners every frame.
        self.saliency = rng.rand(n).astype(np.float32)
        self.rng = rng          # observe's default generator
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

    def observe(self, Rcw, tcw, cam: cm.Camera, *, bf: float = 0.0,
                n_kp: int = 600, pixel_noise: float = 0.3,
                bit_flips: int = 4, clutter: int = 60,
                dropout: float = 0.05, min_depth: float = 0.3,
                max_depth: float = 25.0, rng=None):
        """One frame's feature set, straight from the landmarks.

        The visible landmarks (random dropout, strongest saliency first)
        with pixel noise and a few flipped descriptor bits, then `clutter`
        random detections; with bf > 0 the depth comes from the same noisy
        disparity a stereo matcher would measure.  Draws from `rng` (numpy
        RandomState; default the world's own).  Returns dict(uv, level,
        angle, desc, ur, depth, valid, lm_id) of capacity n_kp; lm_id is
        the true landmark (-1 clutter)."""
        rng = rng or self.rng
        pc = self.pw @ Rcw.T + tcw
        z = pc[:, 2]
        uv = cm.project(cam, torch.from_numpy(
            np.ascontiguousarray(pc, np.float32))).numpy()
        vis = ((z > min_depth) & (z < max_depth)
               & (uv[:, 0] >= 1) & (uv[:, 0] < cam.width - 1)
               & (uv[:, 1] >= 1) & (uv[:, 1] < cam.height - 1))
        vis &= rng.rand(len(z)) > dropout
        ids = np.nonzero(vis)[0]
        ids = ids[np.argsort(-self.saliency[ids], kind="stable")]
        n_real = min(len(ids), n_kp - clutter)
        ids = ids[:n_real]

        out_uv = np.zeros((n_kp, 2), np.float32)
        out_level = np.zeros(n_kp, np.int32)
        out_angle = np.zeros(n_kp, np.float32)
        out_desc = np.zeros((n_kp, 8), np.uint32)
        out_ur = np.full(n_kp, -1.0, np.float32)
        out_depth = np.full(n_kp, -1.0, np.float32)
        out_valid = np.zeros(n_kp, bool)
        out_lmid = np.full(n_kp, -1, np.int64)

        out_uv[:n_real] = uv[ids] + rng.randn(n_real, 2) * pixel_noise
        out_level[:n_real] = self.level[ids]
        desc = self.desc[ids].copy()
        for _ in range(bit_flips):
            word = rng.randint(0, 8, n_real)
            bit = rng.randint(0, 32, n_real).astype(np.uint32)
            desc[np.arange(n_real), word] ^= (np.uint32(1) << bit)
        out_desc[:n_real] = desc
        if bf > 0:
            disp_meas = bf / z[ids] + rng.randn(n_real) * pixel_noise
            out_ur[:n_real] = out_uv[:n_real, 0] - disp_meas
            out_depth[:n_real] = bf / np.maximum(disp_meas, 1e-3)
        out_valid[:n_real] = True
        out_lmid[:n_real] = ids

        c0, c1 = n_real, min(n_kp, n_real + clutter)
        nc = c1 - c0
        if nc > 0:
            out_uv[c0:c1] = rng.rand(nc, 2) * [cam.width - 2, cam.height - 2]
            out_desc[c0:c1] = rng.randint(0, 2 ** 32, (nc, 8), np.uint64)
            out_valid[c0:c1] = True
        return dict(uv=out_uv, level=out_level, angle=out_angle,
                    desc=out_desc, ur=out_ur, depth=out_depth,
                    valid=out_valid, lm_id=out_lmid)

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
        ids = np.nonzero(vis)[0][order]
        # The bilinear sub-pixel shifts of all stamps at once (the same f32
        # operations, in the same order, as one stamp at a time), then the
        # stamps far to near.
        u, v = uv[ids, 0], uv[ids, 1]
        fl_u, fl_v = np.floor(u), np.floor(v)
        fu, fv = (u - fl_u)[:, None, None], (v - fl_v)[:, None, None]
        pp = np.pad(patches[ids], ((0, 0), (1, 1), (1, 1)), mode="edge")
        shifted = ((1 - fv) * (1 - fu) * pp[:, 1:P + 1, 1:P + 1]
                   + (1 - fv) * fu * pp[:, 1:P + 1, 0:P]
                   + fv * (1 - fu) * pp[:, 0:P, 1:P + 1]
                   + fv * fu * pp[:, 0:P, 0:P])
        for li, iu, iv, sh in zip(ids, fl_u.astype(int), fl_v.astype(int),
                                  shifted):
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


def figure_eight_trajectory(t, a=2.0, b=1.2, omega=0.35, z=0.0,
                            heading="tangent"):
    """Lemniscate p(t) = (a sin(wt), b sin(2wt), z): each lap revisits
    every pose.  heading="tangent" faces along the travel (the view sweeps
    360 degrees a lap, so a revisit needs place recognition); a point
    (x, y, z) makes the camera look away from it.

    Returns (Rwc, twc, v_world, a_world), f32."""
    t = np.asarray(t, np.float64)
    w = omega
    pos = np.stack([a * np.sin(w * t), b * np.sin(2 * w * t),
                    np.full_like(t, z)], -1)
    v = np.stack([a * w * np.cos(w * t), 2 * b * w * np.cos(2 * w * t),
                  np.zeros_like(t)], -1)
    a_w = np.stack([-a * w ** 2 * np.sin(w * t),
                    -4 * b * w ** 2 * np.sin(2 * w * t),
                    np.zeros_like(t)], -1)
    if isinstance(heading, str) and heading == "tangent":
        fwd = v.copy()
    else:
        fwd = pos - np.asarray(heading, np.float64)[None, :]
    fwd = fwd / np.maximum(np.linalg.norm(fwd, axis=-1, keepdims=True),
                           1e-9)
    up = np.tile([0.0, 0.0, -1.0], (len(t), 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    Rwc = np.stack([right, down, fwd], axis=-1)
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
    Rb, _ = _interpolate_pose(t_frames, Rwb, None, ts)
    a_b = np.einsum("tij,ti->tj", Rb, a_world - g)   # R^T (a - g)
    gyro = w_b + bg + rng.randn(*w_b.shape) * noise_g
    acc = a_b + ba + rng.randn(*a_b.shape) * noise_a
    return ts.astype(np.float64), gyro.astype(np.float32), \
        acc.astype(np.float32)


def _interpolate_pose(t_frames, Rwb, p_wb, te):
    """Body attitude (interpolated on SO(3)) and, if p_wb is given,
    position (linearly) at the times te, between the frame samples."""
    i1 = np.clip(np.searchsorted(t_frames, te, side="right"), 1,
                 len(t_frames) - 1)
    i0 = i1 - 1
    denom = np.maximum(t_frames[i1] - t_frames[i0], 1e-9)
    frac = np.clip((te - t_frames[i0]) / denom, 0.0, 1.0)
    R0, R1 = Rwb[i0], Rwb[i1]
    dphi = _so3_log(np.einsum("tji,tjk->tik", R0, R1))
    dRot = lie.so3_exp(torch.from_numpy(
        np.ascontiguousarray(dphi * frac[:, None]))).numpy()
    Rb = np.einsum("tij,tjk->tik", R0, dRot)
    if p_wb is None:
        return Rb, None
    return Rb, p_wb[i0] + (p_wb[i1] - p_wb[i0]) * frac[:, None]


def make_encoder_samples(t_frames, Rwb, p_wb, Rbe, tbe, rate_hz=100.0,
                         half_track=0.28, noise_v=0.0, seed=0):
    """Differential-drive wheel speeds consistent with the trajectory (the
    VEO / VIEO input).  The encoder frame E (x forward, y left, z up)
    rides on the body, T_we = T_wb T_be; each sample interval's exact
    SE(3) delta of E is projected to SE(2) (yaw and in-plane translation)
    and inverted through the preintegrator's midpoint model, so that
    preintegrating the speeds reproduces planar motion to rounding.  Noise
    from numpy RandomState(seed).  Returns (ts [T] f64, v_left [T],
    v_right [T])."""
    rng = np.random.RandomState(seed)
    t_frames = np.asarray(t_frames, np.float64)
    ts = np.arange(t_frames[0], t_frames[-1], 1.0 / rate_hz)
    te = np.concatenate([ts, [min(ts[-1] + 1.0 / rate_hz, t_frames[-1])]])
    Rb, pb = _interpolate_pose(t_frames, Rwb, p_wb, te)
    Rbe = np.asarray(Rbe, np.float64)
    tbe = np.asarray(tbe, np.float64)
    R_we = Rb @ Rbe
    p_we = pb + np.einsum("tij,j->ti", Rb, tbe)
    dR_e = np.einsum("tji,tjk->tik", R_we[:-1], R_we[1:])
    dp_e = np.einsum("tji,tj->ti", R_we[:-1], p_we[1:] - p_we[:-1])
    ang = _so3_log(dR_e)
    dt = np.maximum(np.diff(te), 1e-9)
    w = ang[:, 2] / dt
    # The midpoint translation model, inverted: project onto the midpoint
    # heading (theta starts at 0 each interval).
    c = np.cos(0.5 * ang[:, 2])
    s = np.sin(0.5 * ang[:, 2])
    v = (dp_e[:, 0] * c + dp_e[:, 1] * s) / dt
    v_left = v - w * half_track + rng.randn(len(v)) * noise_v
    v_right = v + w * half_track + rng.randn(len(v)) * noise_v
    return ts.astype(np.float64), v_left.astype(np.float32), \
        v_right.astype(np.float32)
