"""The port's Lie-group and pinhole-camera functions against the JAX
package's, on the same seeded numpy inputs (cases from test_lie.py and
test_cameras.py).

Tolerance: atol 1e-5 in f32 -- both sides evaluate the same closed forms,
so only f32 rounding (a few ulps of O(1) values) may differ; pixel
coordinates and their Jacobians (values of hundreds) to 1e-3, the same
relative precision; DLT points to 1e-4 (a 3x3 solve).  The SO(3)
Jacobians are compared in f64 (atol 1e-9): the inverse Jacobian's
coefficient 1/t^2 - cot(t/2)/(2t) cancels catastrophically in f32 for
angles of 1e-4..1e-2 rad, where each library's sin/cos decides the digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.math import lie as tlie

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

ATOL = 1e-5


def _phi(seed, n, scale):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(np.float32)


def _close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 2.5])
def test_so3_exp_log_jacobians(scale):
    phi = _phi(0, 64, scale)
    _close(tlie.hat(T(phi)), jlie.hat(J(phi)))
    _close(tlie.so3_exp(T(phi)), jlie.so3_exp(J(phi)))
    R = np.array(jlie.so3_exp(J(phi)))
    _close(tlie.so3_log(T(R)), jlie.so3_log(J(R)))
    phi64 = phi.astype(np.float64)
    for name in ("so3_jr", "so3_jl", "so3_jr_inv", "so3_jl_inv"):
        _close(getattr(tlie, name)(T(phi64)), getattr(jlie, name)(J(phi64)),
               atol=1e-9)


def test_so3_log_near_pi():
    axis = np.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1],
                     [0.6, 0.8, 0.0], [-0.6, 0.0, 0.8]], np.float32)
    for theta in (np.pi - 1e-2, np.pi - 1e-4):
        R = np.asarray(jlie.so3_exp(J(axis * np.float32(theta))))
        # Compare the rotations the logs map back to (phi may flip sign).
        _close(tlie.so3_exp(tlie.so3_log(T(R))),
               jlie.so3_exp(jlie.so3_log(J(R))), atol=1e-4)


def test_se3_and_quaternion():
    rng = np.random.RandomState(3)
    xi = (rng.randn(32, 6) * 0.7).astype(np.float32)
    Rt, tt = tlie.se3_exp(T(xi))
    Rj, tj = jlie.se3_exp(J(xi))
    _close(Rt, Rj)
    _close(tt, tj)
    _close(tlie.se3_log(Rt, tt), jlie.se3_log(Rj, tj), atol=1e-4)
    Ri, ti = tlie.se3_inverse(Rt, tt)
    _close(Ri, jlie.se3_inverse(Rj, tj)[0])
    _close(ti, jlie.se3_inverse(Rj, tj)[1])
    Rc, tc = tlie.se3_compose(Rt, tt, Ri.flip(0), ti.flip(0))
    Rcj, tcj = jlie.se3_compose(Rj, tj, Rj[::-1].swapaxes(-1, -2),
                                jlie.se3_inverse(Rj, tj)[1][::-1])
    _close(Rc, Rcj)
    _close(tc, tcj)
    p = rng.randn(32, 3).astype(np.float32)
    _close(tlie.se3_apply(Rt, tt, T(p)), jlie.se3_apply(Rj, tj, J(p)))
    _close(tlie.quat_from_rotmat(Rt), jlie.quat_from_rotmat(Rj))
    noisy = np.asarray(Rj) + rng.randn(32, 3, 3).astype(np.float32) * 1e-3
    np.testing.assert_allclose(tlie.normalize_rotation_np(noisy),
                               jlie.normalize_rotation_np(noisy), atol=ATOL)


def _points(seed, n=128):
    rng = np.random.RandomState(seed)
    p = rng.randn(n, 3) * [0.5, 0.4, 0.0]
    p[:, 2] = 2.0 + rng.rand(n) * 4
    return p.astype(np.float32)


def test_project_unproject_jacobian():
    args = (458.6, 457.3, 367.2, 248.4, 752, 480)
    jc, tc = jcm.make_pinhole(*args), tcm.make_pinhole(*args)
    pc = _points(0)
    _close(tcm.project(tc, T(pc)), jcm.project(jc, J(pc)), atol=1e-3)
    uv_t, J_t = tcm.project_jacobian(tc, T(pc))
    uv_j, J_j = jcm.project_jacobian(jc, J(pc))
    _close(uv_t, uv_j, atol=1e-3)
    _close(J_t, J_j, atol=1e-3)
    uv = np.asarray(uv_j)
    _close(tcm.unproject(tc, T(uv)), jcm.unproject(jc, J(uv)))
    probe = np.array([[10.0, 10.0], [-1.0, 5.0], [751.5, 100.0],
                      [700.0, 479.0], [5.0, 480.0]], np.float32)
    np.testing.assert_array_equal(tcm.in_image(tc, T(probe)).numpy(),
                                  np.asarray(jcm.in_image(jc, J(probe))))
    np.testing.assert_array_equal(
        tcm.in_image(tc, T(probe), margin=8.0).numpy(),
        np.asarray(jcm.in_image(jc, J(probe), margin=8.0)))


def test_stereo_rig_and_triangulation():
    jl, jr, jbf = jcm.stereo_rectified_cameras(435.2, 435.2, 367.4, 252.2,
                                               0.11, 752, 480)
    tl, tr, tbf = tcm.stereo_rectified_cameras(435.2, 435.2, 367.4, 252.2,
                                               0.11, 752, 480)
    assert np.float32(tbf) == np.asarray(jbf)
    np.testing.assert_array_equal(tr.tcr, np.asarray(jr.tcr))

    pw = np.array([0.3, -0.2, 4.0], np.float32)
    R1 = np.asarray(jlie.so3_exp(J(np.array([0.0, 0.05, 0.0], np.float32))))
    t1 = np.array([-0.5, 0.0, 0.02], np.float32)
    garbage = np.array([5.0, 5.0, 1.0], np.float32)
    p1 = R1 @ pw + t1
    rays = np.stack([pw / pw[2], p1 / p1[2], garbage]).astype(np.float32)
    Rcw = np.stack([np.eye(3), R1, np.eye(3)]).astype(np.float32)
    tcw = np.stack([np.zeros(3), t1, np.zeros(3)]).astype(np.float32)
    mask = np.array([True, True, False])
    _close(tcm.triangulate_dlt(T(rays), T(Rcw), T(tcw), mask=T(mask)),
           jcm.triangulate_dlt(J(rays), J(Rcw), J(tcw), mask=J(mask)),
           atol=1e-4)
    _close(tcm.triangulate_dlt(T(rays[:2]), T(Rcw[:2]), T(tcw[:2])),
           jcm.triangulate_dlt(J(rays[:2]), J(Rcw[:2]), J(tcw[:2])),
           atol=1e-4)
    d_t, c_t = tcm.triangulation_checks(T(pw), T(Rcw[:2]), T(tcw[:2]),
                                        T(rays[:2]))
    d_j, c_j = jcm.triangulation_checks(J(pw), J(Rcw[:2]), J(tcw[:2]),
                                        J(rays[:2]))
    _close(d_t, d_j)
    _close(c_t, c_j)
