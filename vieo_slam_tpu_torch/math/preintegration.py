"""On-manifold IMU and wheel-encoder preintegration.

Port of vieo_slam_tpu/math/preintegration.py.  The JAX package integrates
one padded window with a `lax.scan` and vmaps it over windows; here the
scan is a Python loop over the sample axis whose every step acts on all
windows at once, so the inputs carry any leading batch dimensions
([..., T, 3] samples, [..., T] intervals) and the loop length is the
window length T, not the number of windows.  Padded samples (dt == 0 or
mask False) are exact no-ops, and do not average into their midpoint
neighbours, so callers may cut trailing padding (io.odom_ring.trim_padding).
A step is ~150 tensor operators (scripts/count_vio_ops.py): T samples cost
~150 T launches on a GPU whatever the batch, unless replayed from a CUDA
graph as the VIO front end does.

Covariance state ordering is (phi, v, p) internally; `cov_prv` and
`cov_pvr` reorder it for the edges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .lie import mv as _mv


class ImuPreint(NamedTuple):
    """Result of IMU preintegration over a window [i, j] (any leading batch
    dimensions): dR [..., 3, 3] body_i from body_j; dv, dp [..., 3] in the
    body_i frame; cov [..., 9, 9] in (phi, v, p) order; the bias Jacobians
    Jg_R, Jg_v, Ja_v, Jg_p, Ja_p [..., 3, 3]; dt [...] integrated time;
    bg, ba [..., 3] the bias linearization point."""

    dR: torch.Tensor
    dv: torch.Tensor
    dp: torch.Tensor
    cov: torch.Tensor
    Jg_R: torch.Tensor
    Jg_v: torch.Tensor
    Ja_v: torch.Tensor
    Jg_p: torch.Tensor
    Ja_p: torch.Tensor
    dt: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor

    @property
    def cov_prv(self) -> torch.Tensor:
        """Covariance in (p, phi, v) order."""
        return _reorder_cov(self.cov, (2, 0, 1))

    @property
    def cov_pvr(self) -> torch.Tensor:
        """Covariance in (p, v, phi) order."""
        return _reorder_cov(self.cov, (2, 1, 0))

    def corrected(self, dbg: torch.Tensor, dba: torch.Tensor):
        """First-order bias-corrected deltas (dR', dv', dp')."""
        dR = self.dR @ lie.so3_exp(_mv(self.Jg_R, dbg))
        dv = self.dv + _mv(self.Jg_v, dbg) + _mv(self.Ja_v, dba)
        dp = self.dp + _mv(self.Jg_p, dbg) + _mv(self.Ja_p, dba)
        return dR, dv, dp


def _reorder_cov(cov: torch.Tensor, block_order) -> torch.Tensor:
    idx = torch.cat([torch.arange(3, device=cov.device) + 3 * b
                     for b in block_order])
    return cov[..., idx, :][..., :, idx]


def _blocks(rows) -> torch.Tensor:
    """Assemble a block matrix from a list of rows of [..., a, b] blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def preintegrate_imu(gyro, acc, dt, bg, ba, sigma_g, sigma_a, *, mask=None,
                     integrate_midpoint: bool = True) -> ImuPreint:
    """Preintegrate windows of IMU samples.

    gyro, acc [..., T, 3] body-frame rates and specific forces; dt [..., T]
    the interval each sample is applied over (0 for padding; f64 is cast
    to the samples' dtype); bg, ba [..., 3] (or [3]) bias linearization
    points; sigma_g, sigma_a continuous-time noise densities (per-sample
    discrete covariance sigma^2 / dt); mask [..., T] optional validity.
    integrate_midpoint averages samples k and k+1 (the last pairs with
    itself); otherwise sample k holds over its interval."""
    dtype, dev = gyro.dtype, gyro.device
    dt = dt.to(dtype)
    if mask is not None:
        dt = torch.where(mask, dt, torch.zeros_like(dt))
    if integrate_midpoint:
        gyro_next = torch.cat([gyro[..., 1:, :], gyro[..., -1:, :]], dim=-2)
        acc_next = torch.cat([acc[..., 1:, :], acc[..., -1:, :]], dim=-2)
        if mask is not None:
            # Do not average into padded neighbours.
            m_next = torch.cat([mask[..., 1:], mask[..., -1:]],
                               dim=-1)[..., None]
            gyro_next = torch.where(m_next, gyro_next, gyro)
            acc_next = torch.where(m_next, acc_next, acc)
        gyro_mid = 0.5 * (gyro + gyro_next)
        acc_mid = 0.5 * (acc + acc_next)
    else:
        gyro_mid, acc_mid = gyro, acc
    batch = gyro.shape[:-2]
    bg = bg.to(dtype).expand(batch + (3,))
    ba = ba.to(dtype).expand(batch + (3,))
    w = gyro_mid - bg[..., None, :]
    a = acc_mid - ba[..., None, :]
    sg2_c = float(sigma_g) ** 2
    sa2_c = float(sigma_a) ** 2

    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))
    zero3 = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    dR, dv, dp = eye3, zero3[..., 0], zero3[..., 0]
    cov = torch.zeros(batch + (9, 9), dtype=dtype, device=dev)
    Jg_R = Jg_v = Ja_v = Jg_p = Ja_p = zero3
    t = torch.zeros(batch, dtype=dtype, device=dev)
    for k in range(gyro.shape[-2]):
        w_k, a_k, dt_k = w[..., k, :], a[..., k, :], dt[..., k]
        dt1 = dt_k[..., None]
        dt2 = dt1 * dt1
        dtm = dt1[..., None]              # [..., 1, 1]
        dtm2 = dtm * dtm
        phi = w_k * dt1
        dR_k = lie.so3_exp(phi)
        Jr_k = lie.so3_jr(phi)
        Ra = dR @ lie.hat(a_k)
        Rak = _mv(dR, a_k)
        # State update (order matters: p uses the old v and R).
        dp_n = dp + dv * dt1 + 0.5 * Rak * dt2
        dv_n = dv + Rak * dt1
        dR_n = dR @ dR_k
        # Bias Jacobians.
        RaJ = Ra @ Jg_R
        Jg_p_n = Jg_p + Jg_v * dtm - 0.5 * RaJ * dtm2
        Ja_p_n = Ja_p + Ja_v * dtm - 0.5 * dR * dtm2
        Jg_v_n = Jg_v - RaJ * dtm
        Ja_v_n = Ja_v - dR * dtm
        Jg_R_n = dR_k.transpose(-1, -2) @ Jg_R - Jr_k * dtm
        # Covariance propagation, (phi, v, p) ordering.
        A = _blocks([[dR_k.transpose(-1, -2), zero3, zero3],
                     [-Ra * dtm, eye3, zero3],
                     [-0.5 * Ra * dtm2, eye3 * dtm, eye3]])
        inv_dt = torch.where(dt_k > 0, 1.0 / torch.clamp_min(dt_k, 1e-12),
                             torch.zeros_like(dt_k))[..., None, None]
        sg2 = sg2_c * inv_dt
        sa2 = sa2_c * inv_dt
        Bg = Jr_k * dtm
        Bv = dR * dtm
        Bp = 0.5 * dR * dtm2
        Bp_T = Bp.transpose(-1, -2)
        Bv_T = Bv.transpose(-1, -2)
        Q = _blocks([[sg2 * (Bg @ Bg.transpose(-1, -2)), zero3, zero3],
                     [zero3, sa2 * (Bv @ Bv_T), sa2 * (Bv @ Bp_T)],
                     [zero3, sa2 * (Bp @ Bv_T), sa2 * (Bp @ Bp_T)]])
        cov = A @ cov @ A.transpose(-1, -2) + Q
        dR, dv, dp = dR_n, dv_n, dp_n
        Jg_R, Jg_v, Ja_v, Jg_p, Ja_p = Jg_R_n, Jg_v_n, Ja_v_n, Jg_p_n, Ja_p_n
        t = t + dt_k
    return ImuPreint(dR=dR, dv=dv, dp=dp, cov=cov, Jg_R=Jg_R, Jg_v=Jg_v,
                     Ja_v=Ja_v, Jg_p=Jg_p, Ja_p=Ja_p, dt=t, bg=bg, ba=ba)


class EncPreint(NamedTuple):
    """Differential-drive encoder preintegration (6D delta): dR [..., 3, 3]
    yaw-only rotation and dp [..., 3] planar translation of the encoder
    frame, cov [..., 6, 6] of (phi, p), dt [...] total time."""

    dR: torch.Tensor
    dp: torch.Tensor
    cov: torch.Tensor
    dt: torch.Tensor


def preintegrate_encoder(v_left, v_right, dt, half_track, sigma_v, *,
                         sigma_eta: float = 1e-4, mask=None) -> EncPreint:
    """Preintegrate wheel speeds [..., T] into a 6D {dphi, dp} delta:
    v = (vl + vr) / 2, w = (vr - vl) / (2 rc) integrated on SE(2) with a
    midpoint heading, lifted to 3D with small regularizing noise on the
    out-of-plane dimensions."""
    dtype, dev = v_left.dtype, v_left.device
    dt = dt.to(dtype)
    if mask is not None:
        dt = torch.where(mask, dt, torch.zeros_like(dt))
    rc = float(half_track)
    q_c = float(sigma_v) ** 2
    v = 0.5 * (v_left + v_right)
    w = (v_right - v_left) / (2.0 * rc)
    batch = v_left.shape[:-1]
    zero = torch.zeros(batch, dtype=dtype, device=dev)
    one = torch.ones(batch, dtype=dtype, device=dev)
    theta, px, py, t = zero, zero, zero, zero
    cov = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    for k in range(v_left.shape[-1]):
        v_k, w_k, dt_k = v[..., k], w[..., k], dt[..., k]
        theta_mid = theta + 0.5 * w_k * dt_k
        c, s = torch.cos(theta_mid), torch.sin(theta_mid)
        px = px + v_k * c * dt_k
        py = py + v_k * s * dt_k
        theta = theta + w_k * dt_k
        F = torch.stack([
            torch.stack([one, zero, zero], -1),
            torch.stack([-v_k * s * dt_k, one, zero], -1),
            torch.stack([v_k * c * dt_k, zero, one], -1)], -2)
        G = torch.stack([
            torch.stack([-dt_k / (2 * rc), dt_k / (2 * rc)], -1),
            torch.stack([0.5 * c * dt_k, 0.5 * c * dt_k], -1),
            torch.stack([0.5 * s * dt_k, 0.5 * s * dt_k], -1)], -2)
        inv_dt = torch.where(dt_k > 0, 1.0 / torch.clamp_min(dt_k, 1e-12),
                             zero)
        q = (q_c * inv_dt)[..., None, None]
        cov = F @ cov @ F.transpose(-1, -2) + q * (G @ G.transpose(-1, -2))
        t = t + dt_k
    c, s = torch.cos(theta), torch.sin(theta)
    dR = torch.stack([torch.stack([c, -s, zero], -1),
                      torch.stack([s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    dp = torch.stack([px, py, zero], -1)
    reg = (float(sigma_eta) ** 2 * (1.0 + t))[..., None]
    z1 = torch.zeros(batch + (1,), dtype=dtype, device=dev)
    # 6x6 (phi, p): rows phi_x, phi_y, phi_z, x, y, z.
    cov6 = torch.stack([
        torch.cat([reg, z1, z1, z1, z1, z1], -1),
        torch.cat([z1, reg, z1, z1, z1, z1], -1),
        torch.cat([z1, z1, cov[..., 0, 0:1], cov[..., 0, 1:3], z1], -1),
        torch.cat([z1, z1, cov[..., 1, 0:1], cov[..., 1, 1:3], z1], -1),
        torch.cat([z1, z1, cov[..., 2, 0:1], cov[..., 2, 1:3], z1], -1),
        torch.cat([z1, z1, z1, z1, z1, reg], -1)], -2)
    return EncPreint(dR=dR, dp=dp, cov=cov6, dt=t)
