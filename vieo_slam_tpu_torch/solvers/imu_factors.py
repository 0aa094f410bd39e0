"""IMU / encoder / prior factor residuals on NavState pairs.

Port of vieo_slam_tpu/solvers/imu_factors.py: the preintegration edge
(PRV order [eP, eR, eV]), the bias random walk, the wheel-encoder SE(2)
edge and the 15D marginal prior, with their information matrices.  The
solvers differentiate these with torch.func.jacfwd, so every function is
pure tensor code (no in-place writes, no host reads).

  eR = Log( (dR Exp(Jg_R dbg))^T R_i^T R_j )
  eV = R_i^T (v_j - v_i - g dt)            - (dv + Jg_v dbg + Ja_v dba)
  eP = R_i^T (p_j - p_i - v_i dt - .5 g dt^2) - (dp + Jg_p dbg + Ja_p dba)
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import lie
from ..math.lie import mv as _mv
from ..math.navstate import NavState
from ..math.preintegration import EncPreint, ImuPreint

GRAVITY = np.asarray([0.0, 0.0, -9.81], np.float32)


def _T(M):
    return M.transpose(-1, -2)


def imu_residual_prv(ns_i: NavState, ns_j: NavState, pre: ImuPreint,
                     gravity=GRAVITY) -> torch.Tensor:
    """9D preintegration residual [eP, eR, eV]."""
    dtype = ns_i.p.dtype
    g = torch.as_tensor(gravity, dtype=dtype, device=ns_i.p.device)
    dt = pre.dt[..., None]
    dbg = ns_i.bg + ns_i.dbg - pre.bg
    dba = ns_i.ba + ns_i.dba - pre.ba
    dR_c, dv_c, dp_c = pre.corrected(dbg, dba)
    Ri_T = _T(ns_i.R)
    eR = lie.so3_log(_T(dR_c) @ Ri_T @ ns_j.R)
    eV = _mv(Ri_T, ns_j.v - ns_i.v - g * dt) - dv_c
    eP = _mv(Ri_T, ns_j.p - ns_i.p - ns_i.v * dt - 0.5 * g * dt * dt) - dp_c
    return torch.cat([eP, eR, eV], dim=-1)


def bias_rw_residual(ns_i: NavState, ns_j: NavState) -> torch.Tensor:
    """6D bias random-walk residual: the full-bias difference."""
    ebg = (ns_j.bg + ns_j.dbg) - (ns_i.bg + ns_i.dbg)
    eba = (ns_j.ba + ns_j.dba) - (ns_i.ba + ns_i.dba)
    return torch.cat([ebg, eba], dim=-1)


def bias_rw_info(sigma_bg_rw, sigma_ba_rw, dt: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Diagonal information of the bias random walk over dt (a 0-d
    tensor)."""
    dt = torch.clamp_min(dt, 1e-6)
    ig = 1.0 / (sigma_bg_rw ** 2 * dt)
    ia = 1.0 / (sigma_ba_rw ** 2 * dt)
    d = torch.cat([ig.expand(3), ia.expand(3)])
    return torch.diag(d.to(dtype))


def encoder_residual(ns_i: NavState, ns_j: NavState, pre: EncPreint,
                     Rbe: torch.Tensor, tbe: torch.Tensor) -> torch.Tensor:
    """6D encoder residual [ePhi, eP] against the predicted encoder-frame
    motion T_ei_ej = T_be^-1 T_bi_w T_w_bj T_be."""
    Reb = _T(Rbe)
    Rij = _T(ns_i.R) @ ns_j.R
    pij = _mv(_T(ns_i.R), ns_j.p - ns_i.p)
    R_e = Reb @ Rij @ Rbe
    p_e = _mv(Reb, _mv(Rij, tbe) + pij - tbe)
    ePhi = lie.so3_log(_T(pre.dR) @ R_e)
    return torch.cat([ePhi, p_e - pre.dp], dim=-1)


def prior_residual(ns: NavState, ns_prior: NavState) -> torch.Tensor:
    """15D prior residual [eP, eV, eR, ebg, eba] against a marginal
    prior's linearization point."""
    Rp_T = _T(ns_prior.R)
    eP = _mv(Rp_T, ns.p - ns_prior.p)
    eV = ns.v - ns_prior.v
    eR = lie.so3_log(Rp_T @ ns.R)
    ebg = (ns.bg + ns.dbg) - (ns_prior.bg + ns_prior.dbg)
    eba = (ns.ba + ns.dba) - (ns_prior.ba + ns_prior.dba)
    return torch.cat([eP, eV, eR, ebg, eba], dim=-1)


def imu_info_prv(pre: ImuPreint, *, eps: float = 1e-8) -> torch.Tensor:
    """Information of the (P, R, V)-ordered covariance, symmetrized and
    regularized by eps I (unchecked: no host read)."""
    cov = pre.cov_prv
    cov = 0.5 * (cov + _T(cov))
    cov = cov + eps * torch.eye(9, dtype=cov.dtype, device=cov.device)
    return torch.linalg.inv_ex(cov)[0]
