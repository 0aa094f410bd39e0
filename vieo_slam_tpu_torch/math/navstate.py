"""NavState: the 15D navigation state of the VIO backend.

Port of vieo_slam_tpu/math/navstate.py.  The state is {Rwb in SO(3), pwb,
vwb, bg + dbg, ba + dba} with the right-disturbance retraction
p <- p + R dp, R <- R Exp(dphi), v <- v + dv.  A NamedTuple of tensors
with arbitrary leading batch dimensions (one state per keyframe in the
backend windows); torch.func transforms pass through it as a pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .lie import mv as _mv


class NavState(NamedTuple):
    """R [..., 3, 3] world-from-body rotation; p, v [..., 3] position and
    velocity in the world; bg, ba [..., 3] bias linearization points;
    dbg, dba [..., 3] optimized bias increments."""

    R: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    dbg: torch.Tensor
    dba: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device="cpu") -> "NavState":
        z3 = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                         device=device)
        eye = torch.eye(3, dtype=dtype, device=device).expand(
            tuple(batch_shape) + (3, 3))
        return NavState(R=eye, p=z3, v=z3, bg=z3, ba=z3, dbg=z3, dba=z3)

    @property
    def bg_full(self) -> torch.Tensor:
        return self.bg + self.dbg

    @property
    def ba_full(self) -> torch.Tensor:
        return self.ba + self.dba

    def inc_small(self, dx: torch.Tensor) -> "NavState":
        """Retraction for the 9D (PRV) tangent [dp, dphi, dv]."""
        dp, dphi, dv = dx[..., 0:3], dx[..., 3:6], dx[..., 6:9]
        return self._replace(p=self.p + _mv(self.R, dp),
                             R=self.R @ lie.so3_exp(dphi), v=self.v + dv)

    def inc_bias(self, dbias: torch.Tensor) -> "NavState":
        """6D bias-delta increment [dbg, dba]."""
        return self._replace(dbg=self.dbg + dbias[..., 0:3],
                             dba=self.dba + dbias[..., 3:6])

    def inc_pvr_bias(self, dx: torch.Tensor) -> "NavState":
        """Full 15D increment [dp, dv, dphi, dbg, dba]."""
        dp, dv, dphi = dx[..., 0:3], dx[..., 3:6], dx[..., 6:9]
        out = self._replace(p=self.p + _mv(self.R, dp), v=self.v + dv,
                            R=self.R @ lie.so3_exp(dphi))
        return out.inc_bias(dx[..., 9:15])


def tcw_from_navstate(ns: NavState, Rcb: torch.Tensor, tcb: torch.Tensor):
    """Camera-from-world pose of a NavState given the camera-from-body
    extrinsic: Tcw = Tcb Tbw."""
    Rbw = ns.R.transpose(-1, -2)
    tbw = -_mv(Rbw, ns.p)
    return Rcb @ Rbw, _mv(Rcb, tbw) + tcb


def navstate_from_tcw(Rcw, tcw, Rcb, tcb, v=None) -> NavState:
    """Inverse of tcw_from_navstate, with zero biases (and velocity unless
    given)."""
    Rbc = Rcb.transpose(-1, -2)
    tbc = -_mv(Rbc, tcb)
    Rwc = Rcw.transpose(-1, -2)
    twc = -_mv(Rwc, tcw)
    pwb = _mv(Rwc, tbc) + twc
    if v is None:
        v = torch.zeros_like(pwb)
    z = torch.zeros_like(pwb)
    return NavState(R=Rwc @ Rbc, p=pwb, v=v, bg=z, ba=z, dbg=z, dba=z)
