"""The benchmark's frozen generator: synthetic worlds, rendering, paths, IMU.

A frozen copy of vieo_slam_tpu_torch/sim/world.py (the landmark field with
its texture stamps, the renderer, the circle and figure-eight paths and the
IMU stream) and of the rows' photometric hardening of
vieo_slam_tpu_torch/examples/evaluate_ntimes.py (noise, brightness drift,
moving landmarks).  The program's generator may change; this copy does not,
and portbench/tests/test_portbench_generator.py holds it equal to the
program's as long as the program's stays as it was.  `portbench.render` renders the same views on the
device; this numpy renderer is its reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# The pinhole camera and SO(3) maps the generator renders and moves with
# (from vieo_slam_tpu_torch/cameras/models.py and math/lie.py, frozen with
# it: the interpolated attitudes and projections are the program's to the
# last bit).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera: fx, fy, cx, cy (f32-rounded floats), width and
    height in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def make_pinhole(fx, fy, cx, cy, width, height) -> Camera:
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return Camera(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                  width=int(width), height=int(height))


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2] (guarded divide;
    callers gate on positive depth)."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = pc[..., 0:2] * inv_z[..., None]
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


_EPS = 1e-8


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3]."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc_ratios(theta_sq: torch.Tensor):
    """(sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-guarded."""
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    s, c = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, s / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - c) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - s) / (safe_sq * theta))
    return A, B, C


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] -> [..., 3, 3]."""
    if phi.dim() == 1:
        # Forward-mode AD (torch.func.jacfwd) gives a 0-d angle meeting a
        # Python scalar an f64 tangent: run it with a batch of one.
        return so3_exp(phi[None])[0]
    A, B, _ = _sinc_ratios(_sq_norm(phi))
    K = hat(phi)
    return (_eye_like(phi, K.shape) + A[..., None, None] * K
            + B[..., None, None] * (K @ K))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of SO(3), robust near 0 and pi: [..., 3, 3] -> [..., 3]."""
    if R.dim() == 2:        # see so3_exp
        return so3_log(R[None])[0]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-15, 1.0)
    small = cos_t > 1.0 - 1e-6
    cos_safe = torch.where(small, torch.zeros_like(cos_t), cos_t)
    theta = torch.where(small, torch.zeros_like(cos_t), torch.arccos(cos_safe))
    w = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    near_pi = cos_t < -1.0 + 1e-6
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_t), sin_t)
    phi_generic = (theta / safe_sin)[..., None] * w
    w_sq = torch.sum(w * w, dim=-1, keepdim=True)
    phi_small = (1.0 + w_sq / 6.0) * w
    one_m_cos = torch.clamp_min(1.0 - cos_t, 1e-12)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) / one_m_cos[..., None],
                          0.0, 1.0)
    axis_abs = torch.sqrt(axis_sq)
    xy = R[..., 0, 1] + R[..., 1, 0]
    xz = R[..., 0, 2] + R[..., 2, 0]
    yz = R[..., 1, 2] + R[..., 2, 1]
    ax, ay, az = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    one = torch.ones_like(ax)
    sx = torch.where(x_major, one, torch.where(y_major, torch.sign(xy),
                                               torch.sign(xz)))
    sy = torch.where(x_major, torch.sign(xy),
                     torch.where(y_major, one, torch.sign(yz)))
    sz = torch.where(x_major, torch.sign(xz),
                     torch.where(y_major, torch.sign(yz), one))
    sx = torch.where(sx == 0, one, sx)
    sy = torch.where(sy == 0, one, sy)
    sz = torch.where(sz == 0, one, sz)
    axis = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    w_dot = torch.sum(axis * w, dim=-1)
    gsign = torch.where(w_dot < 0, -one, one)
    phi_pi = (gsign * theta)[..., None] * axis
    phi = torch.where(small[..., None], phi_small, phi_generic)
    return torch.where(near_pi[..., None], phi_pi, phi)



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


# The rows' photometric hardening (examples/evaluate_ntimes.py).
NOISE_SIGMA = 2.0
DYNAMIC_FRAC = 0.02


def gain_bias(t):
    """Slow brightness drift (exposure wander on real cameras)."""
    return 1.0 + 0.10 * np.sin(0.5 * t), 8.0 * np.sin(0.3 * t)


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

    def render_view(self, cam: Camera, Rcw, tcw, *, bg_level: float = 96.0,
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
        uv = project(cam, torch.from_numpy(
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

    def render_stereo(self, cam: Camera, Rcw, tcw, baseline: float, **kw):
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
    return so3_log(torch.from_numpy(np.ascontiguousarray(R))).numpy()


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
    dRot = so3_exp(torch.from_numpy(
        np.ascontiguousarray(dphi * frac[:, None]))).numpy()
    Rb = np.einsum("tij,tjk->tik", R0, dRot)
    if p_wb is None:
        return Rb, None
    return Rb, p_wb[i0] + (p_wb[i1] - p_wb[i0]) * frac[:, None]
