"""Batched camera models: pinhole, radtan (radial-tangential), KB8 fisheye.

Port of vieo_slam_tpu/cameras/models.py: project / unproject with
analytic Jacobians through the distortion map, image bounds, the
rectified stereo pair and multi-view DLT triangulation.  Unprojection
inverts the distortion with 8 clipped Newton steps, a Python loop over
tensors (the JAX package's `fori_loop`); the 2x2 Jacobian of the
distortion map is written out analytically where the JAX package takes
two forward-mode derivatives.

A `Camera` holds its intrinsics and distortion coefficients as f32-rounded
values (the JAX package's numpy leaves) and its extrinsic as numpy arrays,
so one Camera serves tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = 0
RADTAN = 1
KB8 = 2


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera of a rig: fx, fy, cx, cy (floats); dist [4] f32
    coefficients (radtan: k1 k2 p1 p2; KB8: k1..k4; zeros for a pinhole);
    Rcr [3, 3], tcr [3] camera-from-rig extrinsic (numpy f32); kind
    (PINHOLE, RADTAN or KB8); width, height in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: np.ndarray
    Rcr: np.ndarray
    tcr: np.ndarray
    kind: int
    width: int
    height: int

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _f32(x) -> float:
    return float(np.float32(x))


def make_pinhole(fx, fy, cx, cy, width, height, Rcr=None, tcr=None) -> Camera:
    return Camera(
        fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
        dist=np.zeros(4, np.float32),
        Rcr=np.eye(3, dtype=np.float32) if Rcr is None
        else np.asarray(Rcr, np.float32),
        tcr=np.zeros(3, np.float32) if tcr is None
        else np.asarray(tcr, np.float32),
        kind=PINHOLE, width=int(width), height=int(height))


def make_radtan(fx, fy, cx, cy, dist, width, height, Rcr=None,
                tcr=None) -> Camera:
    cam = make_pinhole(fx, fy, cx, cy, width, height, Rcr, tcr)
    return cam._replace(kind=RADTAN, dist=np.asarray(dist, np.float32))


def make_kb8(fx, fy, cx, cy, dist, width, height, Rcr=None,
             tcr=None) -> Camera:
    cam = make_pinhole(fx, fy, cx, cy, width, height, Rcr, tcr)
    return cam._replace(kind=KB8, dist=np.asarray(dist, np.float32))


# ---------------------------------------------------------------------------
# Normalized-plane distortion maps d: (x, y) -> (xd, yd) and their Jacobians.
# ---------------------------------------------------------------------------


def _coeffs(cam: Camera):
    return tuple(float(c) for c in cam.dist[:4])


def _radtan_distort_with_jac(cam: Camera, xy, jac: bool):
    k1, k2, p1, p2 = _coeffs(cam)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    f = torch.stack([xd, yd], dim=-1)
    if not jac:
        return f, None
    drad = 2.0 * (k1 + 2.0 * k2 * r2)       # d radial / d(r2) * 2
    j00 = radial + x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    j01 = x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    j10 = x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    j11 = radial + y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    J = torch.stack([torch.stack([j00, j01], -1),
                     torch.stack([j10, j11], -1)], -2)
    return f, J


def _kb8_distort_with_jac(cam: Camera, xy, jac: bool):
    """Kannala-Brandt: theta-polynomial fisheye; the identity within 1e-8
    of the axis (the JAX package's guard)."""
    k1, k2, k3, k4 = _coeffs(cam)
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-8
    safe_r = torch.where(small, torch.ones_like(r), r)
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(small, torch.ones_like(r), theta_d / safe_r)
    f = xy * scale[..., None]
    if not jac:
        return f, None
    # d(theta_d)/dr = (1 + 3 k1 t^2 + 5 k2 t^4 + 7 k3 t^6 + 9 k4 t^8)
    # / (1 + r^2); d scale / dr = (theta_d' - scale) / r; J = scale I +
    # (d scale/dr / r) xy xy^T.
    dtd = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (
        7.0 * k3 + t2 * 9.0 * k4)))) / (1.0 + safe_r * safe_r)
    g = torch.where(small, torch.zeros_like(r),
                    (dtd - scale) / (safe_r * safe_r))
    J = scale[..., None, None] * torch.eye(2, dtype=xy.dtype,
                                           device=xy.device) \
        + g[..., None, None] * xy[..., :, None] * xy[..., None, :]
    return f, J


def _distort_with_jac(cam: Camera, xy, jac: bool = True):
    """(d(xy) [..., 2], its Jacobian [..., 2(out), 2(in)] or None)."""
    if cam.kind == PINHOLE:
        if not jac:
            return xy, None
        eye = torch.eye(2, dtype=xy.dtype, device=xy.device)
        return xy, eye.expand(*xy.shape[:-1], 2, 2)
    if cam.kind == RADTAN:
        return _radtan_distort_with_jac(cam, xy, jac)
    if cam.kind == KB8:
        return _kb8_distort_with_jac(cam, xy, jac)
    raise ValueError(f"unknown camera kind {cam.kind}")


def _distort(cam: Camera, xy):
    return _distort_with_jac(cam, xy, jac=False)[0]


def _undistort_iterative(cam: Camera, xyd, iters: int = 8):
    """Invert the distortion map: Newton steps on d(xy) - xyd with the
    exact Jacobian, each step clipped to +-0.5 and the iterate to +-8 (far
    outside the calibrated field of view the polynomial is not monotonic;
    the bounds keep every lane finite, and callers mask those pixels)."""
    if cam.kind == PINHOLE:
        return xyd
    xy = xyd
    for _ in range(iters):
        f, J = _distort_with_jac(cam, xy)
        r = f - xyd
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
        inv00 = J[..., 1, 1] / det
        inv01 = -J[..., 0, 1] / det
        inv10 = -J[..., 1, 0] / det
        inv11 = J[..., 0, 0] / det
        dx = inv00 * r[..., 0] + inv01 * r[..., 1]
        dy = inv10 * r[..., 0] + inv11 * r[..., 1]
        step = torch.clamp(torch.stack([dx, dy], dim=-1), -0.5, 0.5)
        xy = torch.clamp(xy - step, -8.0, 8.0)
    return xy


# ---------------------------------------------------------------------------
# Public project / unproject.
# ---------------------------------------------------------------------------


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2] (guarded divide;
    callers gate on positive depth)."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = _distort(cam, pc[..., 0:2] * inv_z[..., None])
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def project_jacobian(cam: Camera, pc: torch.Tensor):
    """Returns (uv [..., 2], J [..., 2, 3] = d(uv)/d(pc))."""
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / safe_z
    xyd, Jd = _distort_with_jac(cam, pc[..., 0:2] * inv_z[..., None],
                                jac=cam.kind != PINHOLE)
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
    uv = torch.stack([u, v], dim=-1)
    x, y = pc[..., 0], pc[..., 1]
    zeros = torch.zeros_like(z)
    Jnorm = torch.stack([
        torch.stack([inv_z, zeros, -x * inv_z * inv_z], dim=-1),
        torch.stack([zeros, inv_z, -y * inv_z * inv_z], dim=-1),
    ], dim=-2)                                            # [..., 2, 3]
    if Jd is not None:
        Jnorm = Jd @ Jnorm
    # Scalars, not a tensor of (fx, fy): no host copy, so that a CUDA graph
    # can capture the call.
    return uv, torch.stack([cam.fx * Jnorm[..., 0, :],
                            cam.fy * Jnorm[..., 1, :]], dim=-2)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> unit-depth rays [..., 3]."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    xy = _undistort_iterative(cam, torch.stack([xd, yd], dim=-1))
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, margin: float = 0.0):
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))


def triangulate_dlt(rays: torch.Tensor, R_cw: torch.Tensor,
                    t_cw: torch.Tensor, mask=None) -> torch.Tensor:
    """Multi-view DLT from unit-plane rays [..., V, 3] and world->camera
    poses [..., V, 3, 3], [..., V, 3] -> world point [..., 3]."""
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    r1, r2, r3 = R_cw[..., 0, :], R_cw[..., 1, :], R_cw[..., 2, :]
    t1, t2, t3 = t_cw[..., 0], t_cw[..., 1], t_cw[..., 2]
    rowA = x[..., None] * r3 - r1
    rowB = y[..., None] * r3 - r2
    cA = x * t3 - t1
    cB = y * t3 - t2
    A = torch.cat([rowA, rowB], dim=-2)                  # [..., 2V, 3]
    b = -torch.cat([cA, cB], dim=-1)                     # [..., 2V]
    if mask is not None:
        m = torch.cat([mask, mask], dim=-1).to(A.dtype)
        A = A * m[..., None]
        b = b * m
    AtA = A.transpose(-1, -2) @ A
    Atb = torch.einsum("...vi,...v->...i", A, b)
    tr = AtA[..., 0, 0] + AtA[..., 1, 1] + AtA[..., 2, 2]
    ridge = (100.0 * torch.finfo(A.dtype).eps) * (tr[..., None, None] + 1e-30)
    AtA = AtA + ridge * torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]


def triangulation_checks(pw: torch.Tensor, cams_R_cw, cams_t_cw, rays):
    """Positive-depth + parallax checks: (depths [..., V], cos_par [...])."""
    pc = torch.einsum("...vij,...j->...vi", cams_R_cw, pw) + cams_t_cw
    centers = -torch.einsum("...vji,...vj->...vi", cams_R_cw, cams_t_cw)
    d0 = pw[..., None, :] - centers
    d0n = d0 / torch.linalg.norm(d0, dim=-1, keepdim=True).clamp_min(1e-9)
    cos_par = torch.sum(d0n[..., 0, :] * d0n[..., 1, :], dim=-1)
    return pc[..., 2], cos_par


def stereo_rectified_cameras(fx, fy, cx, cy, baseline, width, height):
    """Rectified stereo pair: right camera displaced by -baseline in x.
    Returns (left, right, bf) with bf = fx * baseline (f32-rounded)."""
    left = make_pinhole(fx, fy, cx, cy, width, height)
    right = make_pinhole(fx, fy, cx, cy, width, height,
                         Rcr=np.eye(3, dtype=np.float32),
                         tcr=np.asarray([-baseline, 0.0, 0.0], np.float32))
    return left, right, _f32(fx * baseline)
