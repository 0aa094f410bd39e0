"""SO(3) / SE(3) toolbox on batched tensors.

Port of the SO(3)/SE(3)/Sim(3) part of vieo_slam_tpu/math/lie.py: every
function broadcasts over leading batch dimensions, small angles go
through Taylor branches selected with torch.where (no data-dependent
Python branching).  Sim(3), for loop closing, is at the end.

Conventions: rotations are 3x3 matrices acting on column vectors;
SE(3) tangent ordering is [rho(3), phi(3)] (translation first).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., i, j] x [..., j] -> [..., i]."""
    return torch.einsum("...ij,...j->...i", M, v)


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


def so3_jr(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3)."""
    if phi.dim() == 1:      # see so3_exp
        return so3_jr(phi[None])[0]
    _, B, C = _sinc_ratios(_sq_norm(phi))
    K = hat(phi)
    return (_eye_like(phi, K.shape) - B[..., None, None] * K
            + C[..., None, None] * (K @ K))


def so3_jl(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian: Jl(phi) = Jr(-phi)."""
    return so3_jr(-phi)


def so3_jr_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian, Taylor-guarded."""
    if phi.dim() == 1:      # see so3_exp
        return so3_jr_inv(phi[None])[0]
    theta_sq = _sq_norm(phi)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    half = 0.5 * theta
    cot_half = torch.cos(half) / torch.sin(
        torch.where(small, torch.ones_like(half), half))
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       1.0 / safe_sq - cot_half / (2.0 * theta))
    K = hat(phi)
    return (_eye_like(phi, K.shape) + 0.5 * K
            + coef[..., None, None] * (K @ K))


def so3_jl_inv(phi: torch.Tensor) -> torch.Tensor:
    return so3_jr_inv(-phi)


def normalize_rotation_np(R):
    """Project [..., 3, 3] numpy near-rotations onto SO(3) (host side).

    Applied wherever an optimized rotation becomes long-lived state: the
    constant-velocity prediction amplifies off-manifold residue
    geometrically."""
    R = np.asarray(R)
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    det = np.linalg.det(U @ Vt)
    fix = np.ones(R.shape[:-2] + (3,))
    fix[..., 2] = det
    return ((U * fix[..., None, :]) @ Vt).astype(R.dtype)


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp_min(1.0 + tr, 1e-12)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 1e-12)) * 0.5
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 1e-12)) * 0.5
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 1e-12)) * 0.5
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    best = best[..., None]
    q = torch.where(best == 0, q0, torch.where(
        best == 1, q1, torch.where(best == 2, q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
    ], dim=-2)


def se3_exp(xi: torch.Tensor):
    """xi = [rho, phi] [..., 6] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_jl(phi), rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_jl_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, p):
    return torch.einsum("...ij,...j->...i", R, p) + t


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] near-rotations onto SO(3) (SVD, det +1)."""
    U, _, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    one = torch.ones_like(det)
    fix = torch.stack([one, one, det], dim=-1)
    return (U * fix[..., None, :]) @ Vh


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s), used by loop closing.  Tangent [rho(3), phi(3), sigma].
# ---------------------------------------------------------------------------


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)
    return (Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t),
            s_inv)


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return (Ra @ Rb,
            sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta,
            sa * sb)


def sim3_apply(R, t, s, p):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The closed-form W of Sim(3)'s exponential (t = W rho), with the
    small-angle and small-sigma branches of the JAX package."""
    s = torch.exp(sigma)
    theta_sq = _sq_norm(phi)
    small_t = theta_sq < _EPS
    safe_sq = torch.where(small_t, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    small_s = torch.abs(sigma) < 1e-5
    safe_sigma = torch.where(small_s, torch.ones_like(sigma), sigma)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = sigma * sigma + theta_sq
    C_ = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                     (s - 1.0) / safe_sigma)
    A_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (theta * a)
    A_small_sigma = (1.0 - cos_t) / safe_sq
    A_small_theta = ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    A_tiny = 0.5 + sigma / 6.0
    A_ = torch.where(small_s & small_t, A_tiny, torch.where(
        small_s, A_small_sigma, torch.where(small_t, A_small_theta, A_gen)))
    B_gen = (C_ - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / a) \
        / safe_sq
    B_small_sigma = (theta - sin_t) / (safe_sq * theta)
    B_tiny = 1.0 / 6.0 + sigma / 24.0
    B_ = torch.where(small_s & small_t, B_tiny, torch.where(
        small_s, B_small_sigma, torch.where(small_t, B_tiny, B_gen)))
    K = hat(phi)
    return (C_[..., None, None] * _eye_like(phi, K.shape)
            + A_[..., None, None] * K + B_[..., None, None] * (K @ K))


def sim3_exp(xi: torch.Tensor):
    """xi = [rho, phi, sigma] [..., 7] -> (R, t, s)."""
    if xi.dim() == 1:
        # A 0-d sigma meets Python scalars here, which forward-mode AD
        # (torch.func.jacfwd) promotes to f64: run it with a batch of one.
        return tuple(x[0] for x in sim3_exp(xi[None]))
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(phi, sigma)
    return (so3_exp(phi), torch.einsum("...ij,...j->...i", W, rho),
            torch.exp(sigma))


def sim3_log(R, t, s):
    """Inverse of sim3_exp: solves W rho = t with the closed-form W."""
    if t.dim() == 1:            # see sim3_exp
        return sim3_log(R[None], t[None], s[None])[0]
    phi = so3_log(R)
    sigma = torch.log(s)
    W = _sim3_W(phi, sigma)
    rho = torch.linalg.solve_ex(W, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
