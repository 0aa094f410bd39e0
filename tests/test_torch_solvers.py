"""The port's solvers -- motion-only BA in its three modes, two-view
triangulation and windowed local BA -- against the JAX package on the
same seeded problems.

Tolerances: poses within 1e-4 (rotation entries and metres); landmark
positions within 1e-4 relative.  Both sides run the same iterations in
f32, and the small dense solves and reductions round in another order, so
f32 noise (~1e-6 relative per step) may accumulate over 40 iterations;
inlier sets, accepted matches and triangulation checks must be identical.
Two-view DLT points within 1e-3 relative: the f32 normal equations have a
condition number near (depth / baseline)^2 ~ 1e3, so the two sides' f32
roundings differ by up to ~3e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.backend.triangulation import triangulate_pair as j_tri
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu.solvers import local_ba as jlba
from vieo_slam_tpu.solvers import motion_ba as jmba
from vieo_slam_tpu_torch.backend.triangulation import triangulate_pair as t_tri
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.solvers import local_ba as tlba
from vieo_slam_tpu_torch.solvers import motion_ba as tmba

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
CAM_ARGS = (458.0, 458.0, 376.0, 240.0, 752, 480)


def se3(xi):
    R, t = jlie.se3_exp(J(np.asarray(xi, np.float32)))
    return np.array(R), np.array(t)


def project(pc):
    fx, fy, cx, cy = CAM_ARGS[:4]
    return np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                     fy * pc[:, 1] / pc[:, 2] + cy], -1)


def pose_problem(seed, n=200, outlier_frac=0.2):
    rng = np.random.RandomState(seed)
    bf = 458.0 * 0.11
    pw = (rng.randn(n, 3) * [2.0, 1.5, 1.0] + [0, 0, 6.0]).astype(np.float32)
    R, t = se3([0.1, -0.05, 0.2, 0.03, -0.02, 0.05])
    pc = pw @ R.T + t
    uv = project(pc) + rng.randn(n, 2) * 0.3
    ur = np.where(rng.rand(n) < 0.5, uv[:, 0] - bf / pc[:, 2]
                  + rng.randn(n) * 0.3, -1.0)
    n_out = int(n * outlier_frac)
    uv[:n_out] += rng.randn(n_out, 2) * 80 + 40
    obs = dict(pw=pw, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
               inv_sigma2=(1.2 ** (-2.0 * rng.randint(0, 4, n))
                           ).astype(np.float32),
               valid=rng.rand(n) > 0.05)
    dR, dt = se3([0.03, -0.02, 0.04, 0.05, 0.02, -0.08])
    return bf, obs, dR @ R, dR @ t + dt


@pytest.mark.parametrize("mode", ["lm", "plm", "gn"])
def test_pose_optimization(mode):
    bf, obs, R0, t0 = pose_problem(1)
    want = jmba.pose_optimization(
        J(R0), J(t0), jmba.PoseObs(**{k: J(v) for k, v in obs.items()}),
        jcm.make_pinhole(*CAM_ARGS), bf, mode=mode)
    got = tmba.pose_optimization(
        T(R0), T(t0), tmba.PoseObs(**{k: T(v) for k, v in obs.items()}),
        tcm.make_pinhole(*CAM_ARGS), bf, mode=mode)
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 120
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), rtol=1e-3,
                               atol=1e-3 * float(np.abs(want.H).max()))


def test_triangulate_pair():
    rng = np.random.RandomState(4)
    n_lm, n_kp = 260, 300
    pw = (rng.randn(n_lm, 3) * [2.0, 1.5, 1.0] + [0, 0, 6.0]).astype(
        np.float32)
    R1, t1 = se3([0, 0, 0, 0, 0, 0])
    R2, t2 = se3([-0.25, 0.02, 0.01, 0.0, 0.04, 0.01])
    desc_lm = rng.randint(0, 2 ** 32, (n_lm, 8), np.uint64).astype(np.uint32)
    scales = (1.2 ** np.arange(8)).astype(np.float32)
    inv_sigma2 = (1.0 / scales ** 2).astype(np.float32)
    views = []
    for R, t in ((R1, t1), (R2, t2)):
        ids = rng.permutation(n_lm)[:n_kp - 40]
        uv = project(pw[ids] @ R.T + t) + rng.randn(len(ids), 2) * 0.5
        uv = np.concatenate([uv, rng.rand(40, 2) * [752, 480]])
        desc = np.concatenate([desc_lm[ids], rng.randint(
            0, 2 ** 32, (40, 8), np.uint64).astype(np.uint32)])
        desc[rng.rand(n_kp, 8) < 0.03] ^= np.uint32(1 << 9)
        views.append(dict(uv=uv.astype(np.float32),
                          level=rng.randint(0, 3, n_kp).astype(np.int32),
                          desc=desc, free=rng.rand(n_kp) > 0.1))
    v1, v2 = views
    want = j_tri(J(R1), J(t1), J(v1["uv"]), J(v1["level"]), J(v1["desc"]),
                 J(v1["free"]), J(R2), J(t2), J(v2["uv"]), J(v2["level"]),
                 J(v2["desc"]), J(v2["free"]), J(inv_sigma2), J(scales),
                 jcm.make_pinhole(*CAM_ARGS))

    def t_desc(d):
        return T(d.view(np.int32))

    got = t_tri(T(R1), T(t1), T(v1["uv"]), T(v1["level"]), t_desc(v1["desc"]),
                T(v1["free"]), T(R2), T(t2), T(v2["uv"]), T(v2["level"]),
                t_desc(v2["desc"]), T(v2["free"]), T(inv_sigma2), T(scales),
                tcm.make_pinhole(*CAM_ARGS))
    good = np.asarray(want.good)
    assert good.sum() > 100
    np.testing.assert_array_equal(got.good.numpy(), good)
    np.testing.assert_array_equal(got.kp2.numpy(), np.asarray(want.kp2))
    np.testing.assert_allclose(got.pw.numpy()[good],
                               np.asarray(want.pw)[good], rtol=1e-3)


def ba_problem(seed=0, K=5, M=80, O=5, noise=0.3):
    """K poses on an arc observing M landmarks, each seen by O consecutive
    poses; mixed mono/stereo; a few gross outliers; poses and points
    perturbed from the truth."""
    rng = np.random.RandomState(seed)
    bf = 458.0 * 0.1
    pw = (rng.randn(M, 3) * [3.0, 2.0, 1.5] + [0, 0, 8.0]).astype(np.float32)
    poses = [se3([0.15 * k, 0.0, 0.0, 0.0, 0.02 * k, 0.0]) for k in range(K)]
    obs_kf = np.full((M, O), -1, np.int32)
    obs_uv = np.zeros((M, O, 2), np.float32)
    obs_ur = np.full((M, O), -1.0, np.float32)
    obs_valid = np.zeros((M, O), bool)
    for m in range(M):
        k0 = rng.randint(0, max(K - O + 1, 1))
        for o in range(O):
            k = min(k0 + o, K - 1)
            R, t = poses[k]
            pc = R @ pw[m] + t
            uv = project(pc[None])[0]
            if pc[2] < 0.5 or not (0 <= uv[0] < 752 and 0 <= uv[1] < 480):
                continue
            obs_kf[m, o] = k
            obs_uv[m, o] = uv + rng.randn(2) * noise
            obs_valid[m, o] = True
            if rng.rand() < 0.5:
                obs_ur[m, o] = uv[0] - bf / pc[2] + rng.randn() * noise
    obs_uv[:4, 1] += 60.0                      # gross outliers
    Rcw = np.stack([p[0] for p in poses])
    tcw = np.stack([p[1] for p in poses])
    for k in range(1, K):
        dR, dt = se3(rng.randn(6) * 0.01)
        Rcw[k], tcw[k] = dR @ Rcw[k], dR @ tcw[k] + dt
    fields = dict(
        Rcw=Rcw.astype(np.float32), tcw=tcw.astype(np.float32),
        fixed=np.array([True] + [False] * (K - 1)),
        pw=(pw + rng.randn(M, 3) * 0.05).astype(np.float32),
        lm_valid=np.ones(M, bool), obs_kf=obs_kf, obs_uv=obs_uv,
        obs_ur=obs_ur, obs_inv_sigma2=np.ones((M, O), np.float32),
        obs_valid=obs_valid)
    return bf, fields


def test_local_ba():
    bf, fields = ba_problem()
    want = jlba.local_ba(jlba.BAProblem(**{k: J(v) for k, v in
                                           fields.items()}),
                         jcm.make_pinhole(*CAM_ARGS), bf)
    got = tlba.local_ba(tlba.BAProblem(**{k: T(v) for k, v in
                                          fields.items()}),
                        tcm.make_pinhole(*CAM_ARGS), bf)
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.pw.numpy(), np.asarray(want.pw),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.obs_inlier.numpy(),
                                  np.asarray(want.obs_inlier))
    assert not got.obs_inlier.numpy()[:4, 1].any()
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
