"""Pinhole camera model on batched tensors.

Port of the pinhole part of vieo_slam_tpu/cameras/models.py: project /
unproject with analytic Jacobians, image bounds, the rectified stereo
pair and multi-view DLT triangulation.  Radtan and KB8 distortion come
with the multi-camera slice.

A `Camera` holds its intrinsics as Python floats (the f32-rounded values
of the JAX package's numpy leaves) and its extrinsic as numpy arrays, so
one Camera serves tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = 0


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera of a rig: fx, fy, cx, cy (floats); dist [4] zeros for a
    pinhole; Rcr [3, 3], tcr [3] camera-from-rig extrinsic (numpy f32);
    kind (PINHOLE); width, height in pixels."""

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


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2] (guarded divide;
    callers gate on positive depth)."""
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = pc[..., 0:2] * inv_z[..., None]
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def project_jacobian(cam: Camera, pc: torch.Tensor):
    """Returns (uv [..., 2], J [..., 2, 3] = d(uv)/d(pc))."""
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / safe_z
    xy = pc[..., 0:2] * inv_z[..., None]
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    uv = torch.stack([u, v], dim=-1)
    x, y = pc[..., 0], pc[..., 1]
    zeros = torch.zeros_like(z)
    Jnorm = torch.stack([
        torch.stack([inv_z, zeros, -x * inv_z * inv_z], dim=-1),
        torch.stack([zeros, inv_z, -y * inv_z * inv_z], dim=-1),
    ], dim=-2)                                            # [..., 2, 3]
    K = torch.tensor([cam.fx, cam.fy], dtype=pc.dtype, device=pc.device)
    return uv, K[:, None] * Jnorm


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> unit-depth rays [..., 3]."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([xd, yd, torch.ones_like(xd)], dim=-1)


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
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


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
