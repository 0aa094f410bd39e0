"""The port's VIO components against the JAX package's, on the same numpy
inputs made from a seed: IMU and encoder preintegration (single windows,
batched windows, padding and mask no-ops, f64 intervals), every IMU
factor, the VIO motion BA (with and without the encoder term), the
NavState-window BA (a perturbed window, fixed states, the init global BA
with scale and gravity direction), every VI-initialization solve, and
the odometry ring against the JAX package's numpy fallback.

Tolerances (f32 on both sides): preintegrated deltas and Jacobians within
1e-5 (covariances relative 1e-4); factor residuals within 1e-5 and
information matrices relative 1e-4; motion BA states within 1e-4 m /
1e-4 rad / 1e-3 m/s and equal inlier sets; window BA states within
1e-3 m, 1e-3 rad, 1e-2 m/s and 1e-3 in the biases (two 10-iteration LM
stages of float accumulations in different orders); VI-init biases
within 1e-4, gravity within 1e-3 m/s^2, velocities within 2e-3 m/s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu import native as jnative
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu.math import navstate as jnav
from vieo_slam_tpu.math import preintegration as jpre
from vieo_slam_tpu.solvers import imu_factors as jfac
from vieo_slam_tpu.solvers import vio_ba as jvba
from vieo_slam_tpu.solvers import vio_local_ba as jvlba
from vieo_slam_tpu.vio import initialization as jinit
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.io.odom_ring import OdomRing
from vieo_slam_tpu_torch.math import navstate as tnav
from vieo_slam_tpu_torch.math.navstate import NavState
from vieo_slam_tpu_torch.math import preintegration as tpre
from vieo_slam_tpu_torch.solvers import imu_factors as tfac
from vieo_slam_tpu_torch.solvers import vio_ba as tvba
from vieo_slam_tpu_torch.solvers import vio_local_ba as tvlba
from vieo_slam_tpu_torch.solvers.motion_ba import PoseObs
from vieo_slam_tpu_torch.vio import initialization as tinit

from test_vio_ba import make_vio_problem
from test_vio_init import simulate
from test_vio_local_ba import _perturb, make_problem

torch.set_num_threads(1)


def T(x):
    """numpy / JAX array -> torch tensor (floats as f32)."""
    a = np.array(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def tree(cls, jtup):
    return cls(*(T(x) for x in jtup))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def imu_window(rng, shape, T_):
    gyro = rng.randn(*shape, T_, 3).astype(np.float32) * 0.5
    acc = (rng.randn(*shape, T_, 3) * 2.0 + [0, 0, 9.81]).astype(np.float32)
    dt = np.full(shape + (T_,), 0.005, np.float32) \
        + rng.rand(*shape, T_).astype(np.float32) * 1e-3
    return gyro, acc, dt


def assert_preint_close(got: tpre.ImuPreint, want):
    for name in ("dR", "dv", "dp", "Jg_R", "Jg_v", "Ja_v", "Jg_p", "Ja_p",
                 "dt", "bg", "ba"):
        close(getattr(got, name), getattr(want, name), 1e-5)
    scale = np.abs(np.asarray(want.cov)).max()
    close(got.cov, want.cov, 1e-4 * scale)
    close(got.cov_prv, want.cov_prv, 1e-4 * scale)
    close(got.cov_pvr, want.cov_pvr, 1e-4 * scale)


# ---------------------------------------------------------------------------
# Preintegration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("midpoint", [True, False])
def test_preintegrate_imu_single_window(midpoint):
    rng = np.random.RandomState(0)
    gyro, acc, dt = imu_window(rng, (), 30)
    bg = np.array([0.01, -0.02, 0.03], np.float32)
    ba = np.array([0.1, 0.05, -0.08], np.float32)
    want = jpre.preintegrate_imu(jnp.asarray(gyro), jnp.asarray(acc),
                                 jnp.asarray(dt), jnp.asarray(bg),
                                 jnp.asarray(ba), 1.7e-4, 2e-3,
                                 integrate_midpoint=midpoint)
    got = tpre.preintegrate_imu(T(gyro), T(acc), T(dt), T(bg), T(ba),
                                1.7e-4, 2e-3, integrate_midpoint=midpoint)
    assert_preint_close(got, want)
    dbg = np.array([0.003, -0.001, 0.002], np.float32)
    dba = np.array([-0.01, 0.02, 0.01], np.float32)
    for g, w in zip(got.corrected(T(dbg), T(dba)),
                    want.corrected(jnp.asarray(dbg), jnp.asarray(dba))):
        close(g, w, 1e-5)


def test_preintegrate_imu_batched_windows():
    """Leading batch dimensions run in one loop over the samples and equal
    the JAX package's vmap over windows."""
    rng = np.random.RandomState(1)
    gyro, acc, dt = imu_window(rng, (2, 3), 20)
    bg = rng.randn(2, 3, 3).astype(np.float32) * 0.01
    ba = rng.randn(2, 3, 3).astype(np.float32) * 0.05
    mask = rng.rand(2, 3, 20) > 0.2
    one = lambda g, a, d, b1, b2, m: jpre.preintegrate_imu(  # noqa: E731
        g, a, d, b1, b2, 1.7e-4, 2e-3, mask=m)
    want = jax.vmap(jax.vmap(one))(*(jnp.asarray(x) for x in
                                     (gyro, acc, dt, bg, ba, mask)))
    got = tpre.preintegrate_imu(T(gyro), T(acc), T(dt), T(bg), T(ba),
                                1.7e-4, 2e-3, mask=torch.from_numpy(mask))
    assert got.dR.shape == (2, 3, 3, 3)
    assert_preint_close(got, want)


def test_preintegrate_imu_padding_is_a_no_op():
    """Padded samples (mask False, or dt 0) change nothing, and the last
    valid sample does not average into a padded neighbour; f64 intervals
    integrate in the samples' dtype."""
    rng = np.random.RandomState(2)
    gyro, acc, dt = imu_window(rng, (), 24)
    n = 17
    mask = np.arange(24) < n
    gyro_pad, acc_pad = gyro.copy(), acc.copy()
    gyro_pad[n:] = 50.0           # garbage behind the mask
    acc_pad[n:] = -30.0
    z = torch.zeros(3)
    short = tpre.preintegrate_imu(T(gyro[:n]), T(acc[:n]), T(dt[:n]), z, z,
                                  1.7e-4, 2e-3)
    padded = tpre.preintegrate_imu(T(gyro_pad), T(acc_pad), T(dt), z, z,
                                   1.7e-4, 2e-3, mask=torch.from_numpy(mask))
    for g, w in zip(padded, short):
        close(g, w, 1e-6)
    dt0 = np.where(mask, dt, 0.0).astype(np.float32)
    zero_dt = tpre.preintegrate_imu(T(gyro), T(acc), T(dt0), z, z, 1.7e-4,
                                    2e-3, integrate_midpoint=False)
    short_hold = tpre.preintegrate_imu(T(gyro[:n]), T(acc[:n]), T(dt[:n]), z,
                                       z, 1.7e-4, 2e-3,
                                       integrate_midpoint=False)
    for g, w in zip(zero_dt, short_hold):
        close(g, w, 1e-6)
    dt64 = torch.from_numpy(dt.astype(np.float64))
    got64 = tpre.preintegrate_imu(T(gyro_pad), T(acc_pad), dt64, z, z,
                                  1.7e-4, 2e-3, mask=torch.from_numpy(mask))
    assert got64.dp.dtype == torch.float32 and got64.dt.dtype == torch.float32
    want = jpre.preintegrate_imu(
        jnp.asarray(gyro_pad), jnp.asarray(acc_pad),
        jnp.asarray(dt.astype(np.float64)), jnp.zeros(3, jnp.float32),
        jnp.zeros(3, jnp.float32), 1.7e-4, 2e-3, mask=jnp.asarray(mask))
    assert_preint_close(got64, want)


def test_preintegrate_encoder_single_and_batched():
    rng = np.random.RandomState(3)
    vl = (0.4 + rng.randn(2, 25) * 0.05).astype(np.float32)
    vr = (0.5 + rng.randn(2, 25) * 0.05).astype(np.float32)
    dt = np.full((2, 25), 0.01, np.float32)
    mask = np.arange(25) < 21
    mask = np.stack([mask, np.ones(25, bool)])
    one = lambda a, b, d, m: jpre.preintegrate_encoder(  # noqa: E731
        a, b, d, 0.28, 0.01, mask=m)
    want = jax.vmap(one)(*(jnp.asarray(x) for x in (vl, vr, dt, mask)))
    got = tpre.preintegrate_encoder(T(vl), T(vr), T(dt), 0.28, 0.01,
                                    mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w, 1e-6, 1e-4)
    single = tpre.preintegrate_encoder(T(vl[0]), T(vr[0]), T(dt[0]), 0.28,
                                       0.01, mask=torch.from_numpy(mask[0]))
    for g, w in zip(single, got):
        close(g, np.asarray(w)[0], 1e-7)


# ---------------------------------------------------------------------------
# Factors
# ---------------------------------------------------------------------------


def random_states(rng, n=2):
    """n random NavStates (numpy f32 fields)."""
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(n, 3) * 0.5,
                                            jnp.float32)))
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)  # noqa: E731
    return [dict(R=R[i].astype(np.float32), p=f(3) * 10, v=f(3) * 5,
                 bg=f(3) * 0.1, ba=f(3), dbg=f(3) * 0.01, dba=f(3) * 0.1)
            for i in range(n)]


def both_ns(d):
    return (jnav.NavState(**{k: jnp.asarray(v) for k, v in d.items()}),
            NavState(**{k: torch.from_numpy(v) for k, v in d.items()}))


def test_navstate_retractions_and_poses():
    """inc_small, inc_bias, inc_pvr_bias, the full biases, the camera pose
    of a NavState and the NavState of a camera pose."""
    rng = np.random.RandomState(7)
    d = random_states(rng, 1)[0]
    jns, tns = both_ns(d)
    dx = (rng.randn(15) * 0.1).astype(np.float32)
    for name, n in (("inc_small", 9), ("inc_bias", 6), ("inc_pvr_bias", 15)):
        got = getattr(tns, name)(T(dx[:n]))
        want = getattr(jns, name)(jnp.asarray(dx[:n]))
        for g, w in zip(got, want):
            close(g, w, 1e-6)
    close(tns.bg_full, jns.bg_full, 0)
    close(tns.ba_full, jns.ba_full, 0)
    Rcb = np.asarray(random_states(rng, 1)[0]["R"])
    tcb = np.array([0.05, -0.02, 0.1], np.float32)
    want = jnav.tcw_from_navstate(jns, jnp.asarray(Rcb), jnp.asarray(tcb))
    got = tnav.tcw_from_navstate(tns, T(Rcb), T(tcb))
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    back = tnav.navstate_from_tcw(*got, T(Rcb), T(tcb))
    want = jnav.navstate_from_tcw(*want, jnp.asarray(Rcb), jnp.asarray(tcb))
    for g, w in zip(back, want):
        close(g, w, 1e-5)


def test_imu_factors_residuals_and_information():
    rng = np.random.RandomState(4)
    si, sj, sp = random_states(rng, 3)
    (ji, ti), (jj, tj), (jp, tp) = both_ns(si), both_ns(sj), both_ns(sp)
    gyro, acc, dt = imu_window(rng, (), 40)
    bg = np.array([0.01, 0.0, -0.01], np.float32)
    jpi = jpre.preintegrate_imu(jnp.asarray(gyro), jnp.asarray(acc),
                                jnp.asarray(dt), jnp.asarray(bg),
                                jnp.zeros(3, jnp.float32), 1.7e-4, 2e-3)
    tpi = convert.imu_preint_from_jax(jpi)
    close(tfac.imu_residual_prv(ti, tj, tpi),
          jfac.imu_residual_prv(ji, jj, jpi), 1e-5)
    g = np.array([0.1, -0.2, -9.7], np.float32)
    close(tfac.imu_residual_prv(ti, tj, tpi, torch.from_numpy(g)),
          jfac.imu_residual_prv(ji, jj, jpi, g), 1e-5)
    close(tfac.bias_rw_residual(ti, tj), jfac.bias_rw_residual(ji, jj), 1e-6)
    close(tfac.prior_residual(ti, tp), jfac.prior_residual(ji, jp), 1e-5)
    close(tfac.bias_rw_info(2e-4, 2e-3, tpi.dt),
          jfac.bias_rw_info(2e-4, 2e-3, jpi.dt), 0.0, 1e-5)
    want = np.asarray(jfac.imu_info_prv(jpi))
    close(tfac.imu_info_prv(tpi), want, 1e-4 * np.abs(want).max())
    vl = (0.4 + rng.randn(30) * 0.05).astype(np.float32)
    vr = (0.5 + rng.randn(30) * 0.05).astype(np.float32)
    jenc = jpre.preintegrate_encoder(jnp.asarray(vl), jnp.asarray(vr),
                                     jnp.full(30, 0.01, jnp.float32), 0.28,
                                     0.01)
    tenc = tpre.EncPreint(*(T(x) for x in jenc))
    Rbe = np.asarray(random_states(rng, 1)[0]["R"])
    tbe = np.array([0.1, -0.05, 0.2], np.float32)
    close(tfac.encoder_residual(ti, tj, tenc, T(Rbe), T(tbe)),
          jfac.encoder_residual(ji, jj, jenc, jnp.asarray(Rbe),
                                jnp.asarray(tbe)), 1e-5)


# ---------------------------------------------------------------------------
# VIO motion BA
# ---------------------------------------------------------------------------


def rot_err(Ra, Rb):
    M = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1)))


def assert_ns_close(got, want, p_tol, r_tol, v_tol, b_tol):
    assert np.abs(np.asarray(got.p) - np.asarray(want.p)).max() < p_tol
    R_got, R_want = np.asarray(got.R), np.asarray(want.R)
    for a, b in zip(R_got.reshape(-1, 3, 3), R_want.reshape(-1, 3, 3)):
        assert rot_err(a, b) < r_tol
    assert np.abs(np.asarray(got.v) - np.asarray(want.v)).max() < v_tol
    for name in ("bg", "ba", "dbg", "dba"):
        close(getattr(got, name), getattr(want, name), b_tol)


@pytest.mark.parametrize("with_encoder", [False, True])
def test_vio_pose_optimization(with_encoder):
    """A perturbed current state, the last state floating under its prior
    (and with the wheel-encoder factor): states, inliers and the
    marginal prior equal the JAX package's."""
    cam, bf, Rcb, tcb, pre, obs, ns_i, ns_j = make_vio_problem(seed=1)
    dx = np.zeros(15, np.float32)
    dx[0:3] = [0.05, -0.03, 0.04]
    dx[6:9] = [0.02, 0.01, -0.03]
    ns_i = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ns_i)
    ns0 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                       ns_j.inc_pvr_bias(jnp.asarray(dx)))
    prior = np.diag(np.linspace(1.0, 100.0, 15)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if with_encoder:
        jenc = jpre.preintegrate_encoder(
            jnp.full(40, 0.3, jnp.float32), jnp.full(40, 0.32, jnp.float32),
            jnp.full(40, 0.005, jnp.float32), 0.28, 0.01)
        Rbe = np.eye(3, dtype=np.float32)
        tbe = np.array([0.0, 0.1, 0.0], np.float32)
        kw_j = dict(enc_pre=jenc, Rbe=jnp.asarray(Rbe), tbe=jnp.asarray(tbe))
        kw_t = dict(enc_pre=tpre.EncPreint(*(T(x) for x in jenc)),
                    Rbe=T(Rbe), tbe=T(tbe))
    jobs = jax.tree.map(lambda a: jnp.asarray(a), obs)
    want = jvba.vio_pose_optimization(
        ns_i, ns0, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pre),
        jobs, cam, jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), bf, prior_info=jnp.asarray(prior),
        last_fixed=False, **kw_j)
    tcam = convert.camera_from_jax(cam)
    got = tvba.vio_pose_optimization(
        convert.navstate_from_jax(ns_i), convert.navstate_from_jax(ns0),
        convert.imu_preint_from_jax(pre), tree(PoseObs, obs), tcam,
        torch.eye(3), torch.zeros(3), bf, prior_info=T(prior),
        last_fixed=False, **kw_t)
    assert_ns_close(got.ns, want.ns, 1e-4, 1e-4, 1e-3, 1e-4)
    assert_ns_close(got.ns_last, want.ns_last, 1e-4, 1e-4, 1e-3, 1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    scale = np.abs(np.asarray(want.prior_info)).max()
    close(got.prior_info, want.prior_info, 2e-3 * scale)


def test_vio_pose_optimization_holds_the_last_state_without_prior():
    cam, bf, Rcb, tcb, pre, obs, ns_i, ns_j = make_vio_problem(seed=1)
    dx = np.zeros(15, np.float32)
    dx[0:3] = [0.05, -0.03, 0.04]
    ns_i = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ns_i)
    ns0 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                       ns_j.inc_pvr_bias(jnp.asarray(dx)))
    want = jvba.vio_pose_optimization(
        ns_i, ns0, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pre),
        jax.tree.map(jnp.asarray, obs), cam, jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), bf)
    got = tvba.vio_pose_optimization(
        convert.navstate_from_jax(ns_i), convert.navstate_from_jax(ns0),
        convert.imu_preint_from_jax(pre), tree(PoseObs, obs),
        convert.camera_from_jax(cam), torch.eye(3), torch.zeros(3), bf)
    assert_ns_close(got.ns, want.ns, 1e-4, 1e-4, 1e-3, 1e-4)
    np.testing.assert_array_equal(got.ns_last.p.numpy(),
                                  np.asarray(ns_i.p, np.float32))


def test_clamp_blocks():
    dx = np.linspace(-3, 3, 30).astype(np.float32)
    close(tvba._clamp_blocks(T(dx)), jvba._clamp_blocks(jnp.asarray(dx)), 0)


# ---------------------------------------------------------------------------
# NavState-window BA
# ---------------------------------------------------------------------------


def port_problem(jprob) -> tvlba.VioBAProblem:
    f = {}
    for name, value in jprob._asdict().items():
        if name == "ns":
            f[name] = convert.navstate_from_jax(value)
        elif name == "imu_pre":
            f[name] = convert.imu_preint_from_jax(value)
        elif name == "enc_pre":
            f[name] = tpre.EncPreint(*(T(x) for x in value))
        elif name == "prior_idx":
            f[name] = int(value)
        elif name in ("chain_i", "chain_j", "obs_kf"):
            f[name] = torch.from_numpy(np.asarray(value, np.int64))
        else:
            f[name] = T(value)
    return tvlba.VioBAProblem(**f)


def port_cfg(jcfg) -> tvlba.VioBAConfig:
    return tvlba.VioBAConfig(
        Rcb=T(jcfg.Rcb), tcb=T(jcfg.tcb), bf=T(jcfg.bf),
        gravity=T(jcfg.gravity), sigma_bg_rw=jcfg.sigma_bg_rw,
        sigma_ba_rw=jcfg.sigma_ba_rw,
        Rbe=None if jcfg.Rbe is None else T(jcfg.Rbe),
        tbe=None if jcfg.tbe is None else T(jcfg.tbe))


def f32_problem(jprob):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        jprob)


def run_both(jprob, cam, jcfg, **kw):
    jprob = f32_problem(jprob)
    want = jvlba.vio_ba(jprob, cam, jcfg, **kw)
    got = tvlba.vio_ba(port_problem(jprob), convert.camera_from_jax(cam),
                       port_cfg(jcfg), **kw)
    return got, want


def test_vio_ba_perturbed_window_and_fixed_states():
    prob, _, cam, cfg = make_problem(seed=1, K=5, M=60)
    pert = _perturb(prob, np.random.RandomState(2), db=0.005)
    # Hold the second keyframe's velocity and bias as well (a fixed ring
    # keyframe of the local BA), with the window prior on the last one.
    fixed_vb = np.zeros(5, bool)
    fixed_vb[1] = True
    pert = pert._replace(fixed_vb=jnp.asarray(fixed_vb),
                         prior_idx=jnp.asarray(4, jnp.int32),
                         prior_info6=jnp.full(6, 25.0, jnp.float32))
    got, want = run_both(pert, cam, cfg, stage_iters=(4, 6))
    assert_ns_close(got.ns, want.ns, 1e-3, 1e-3, 1e-2, 1e-3)
    close(got.pw, want.pw, 2e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(),
                                  np.asarray(want.obs_inlier))
    # Fixed states stay as they were.
    ns0 = convert.navstate_from_jax(f32_problem(pert).ns)
    for name in ("R", "p"):
        np.testing.assert_array_equal(getattr(got.ns, name)[0].numpy(),
                                      getattr(ns0, name)[0].numpy())
    for name in ("v", "bg", "ba", "dbg", "dba"):
        np.testing.assert_array_equal(getattr(got.ns, name)[1].numpy(),
                                      getattr(ns0, name)[1].numpy())


def test_vio_ba_init_gba_scale_and_gravity():
    """The init global BA: the map 20 % too small and gravity tilted; the
    port recovers the same scale and gravity as the JAX package, with the
    robust chains and the initial-bias prior on."""
    tilt = np.array([0.15, -0.1, -9.81], np.float32)
    tilt = tilt / np.linalg.norm(tilt) * 9.81
    prob, _, cam, cfg = make_problem(seed=5, K=6, M=60, scale_map=0.8,
                                     gravity_used=tilt)
    prob = prob._replace(prior_info6=jnp.full(6, 10.0, jnp.float32))
    got, want = run_both(prob, cam, cfg, stage_iters=(3, 4), opt_scale=True,
                         opt_gdir=True, robust_chains=True)
    close(got.scale, want.scale, 1e-3)
    close(got.gravity, want.gravity, 2e-3)
    assert_ns_close(got.ns, want.ns, 2e-3, 1e-3, 1e-2, 1e-3)


# ---------------------------------------------------------------------------
# VI initialization
# ---------------------------------------------------------------------------


def sim_tensors(sim):
    return {k: T(v) for k, v in sim.items()
            if k in ("t_kf", "R_wb", "R_wc", "p_wc", "gyro_w", "acc_w",
                     "dt_w")} | {"mask_w": torch.from_numpy(
                         np.asarray(sim["mask_w"]))}


@pytest.mark.parametrize("solve_scale", [False, True])
def test_try_init_vio(solve_scale):
    bg = np.array([0.015, -0.02, 0.01], np.float32)
    ba = np.array([0.08, -0.05, 0.1], np.float32)
    sim = simulate(bg=bg, ba=ba, n_kf=14, scale=2.0 if solve_scale else 1.0)
    s = sim_tensors(sim)
    args = ("t_kf", "R_wc", "p_wc")
    imu = ("gyro_w", "acc_w", "dt_w", "mask_w")
    want = jinit.try_init_vio(
        *(jnp.asarray(np.asarray(sim[k], np.float32)) for k in args),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        *(sim[k] for k in imu), 1.7e-4, 2e-3, solve_scale=solve_scale)
    got = tinit.try_init_vio(*(s[k] for k in args), torch.eye(3),
                             torch.zeros(3), *(s[k] for k in imu), 1.7e-4,
                             2e-3, solve_scale=solve_scale)
    close(got.bg, want.bg, 1e-4)
    close(got.ba, want.ba, 2e-3)
    close(got.gw, want.gw, 1e-3)
    close(got.scale, want.scale, 1e-4)
    close(got.v, want.v, 2e-3)


def test_gyro_bias_and_linear_alignment():
    sim = simulate(bg=np.array([0.02, -0.015, 0.03], np.float32), n_kf=10)
    s = sim_tensors(sim)
    z = jnp.zeros(3, jnp.float32)
    jpre0 = jax.vmap(lambda g, a, d, m: jpre.preintegrate_imu(
        g, a, d, z, z, 1.7e-4, 2e-3, mask=m))(
        sim["gyro_w"], sim["acc_w"], sim["dt_w"], sim["mask_w"])
    tpre0 = tpre.preintegrate_imu(s["gyro_w"], s["acc_w"], s["dt_w"],
                                  torch.zeros(3), torch.zeros(3), 1.7e-4,
                                  2e-3, mask=s["mask_w"])
    R_wb = jnp.asarray(np.asarray(sim["R_wb"], np.float32))
    close(tinit.solve_gyro_bias(s["R_wb"], tpre0),
          jinit.solve_gyro_bias(R_wb, jpre0), 1e-5)
    pcb = np.zeros(3, np.float32)
    p_wc = jnp.asarray(np.asarray(sim["p_wc"], np.float32))
    want = jinit.linear_alignment(sim["t_kf"], R_wb, p_wc, R_wb,
                                  jnp.asarray(pcb), jpre0)
    got = tinit.linear_alignment(s["t_kf"], s["R_wb"], s["p_wc"], s["R_wb"],
                                 T(pcb), tpre0)
    close(got[0], want[0], 1e-3)
    close(got[1], want[1], 1e-2)
    close(got[2], want[2], 1e-2)
    want = jinit.refine_with_gravity_mag(sim["t_kf"], R_wb, p_wc, R_wb,
                                         jnp.asarray(pcb), jpre0, want[1])
    got = tinit.refine_with_gravity_mag(s["t_kf"], s["R_wb"], s["p_wc"],
                                        s["R_wb"], T(pcb), tpre0, got[1])
    for g, w in zip(got[:4], want[:4]):
        close(g, w, 1e-2)


def test_recompute_bias_navstate():
    from vieo_slam_tpu.sim.world import circle_trajectory, make_imu_samples
    n = 12
    ts = np.arange(n) * 0.1
    Rwc, twc, v_w, a_w = circle_trajectory(
        ts, radius=1.0, omega=0.4, z_amp=0.1, z_omega=0.9, pitch_amp=0.12,
        pitch_omega=0.7)
    t_imu, gyro, acc = make_imu_samples(
        ts, Rwc.astype(np.float64), v_w, a_w, rate_hz=200.0,
        bg=np.array([0.012, -0.018, 0.01]), ba=np.array([0.06, -0.04, 0.03]),
        noise_g=1e-4, noise_a=5e-4, seed=3)
    Tc = 32
    w = np.zeros((4, n - 1, Tc, 3), np.float32)
    dt_w = np.zeros((n - 1, Tc), np.float32)
    mask_w = np.zeros((n - 1, Tc), bool)
    for i in range(n - 1):
        sel = (t_imu >= ts[i]) & (t_imu < ts[i + 1])
        k = sel.sum()
        w[0, i, :k], w[1, i, :k] = gyro[sel], acc[sel]
        dt_w[i, :k] = 1.0 / 200.0
        mask_w[i, :k] = True
    g0 = np.array([0.0, 0.0, -9.81], np.float32)
    want = jinit.recompute_bias_navstate(
        jnp.asarray(ts.astype(np.float32)), jnp.asarray(Rwc),
        jnp.asarray(twc), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), jnp.asarray(w[0]), jnp.asarray(w[1]),
        jnp.asarray(dt_w), jnp.asarray(mask_w), g0, 1.7e-4, 2e-3)
    got = tinit.recompute_bias_navstate(
        T(ts), T(Rwc), T(twc), torch.eye(3), torch.zeros(3), T(w[0]),
        T(w[1]), T(dt_w), torch.from_numpy(mask_w), g0, 1.7e-4, 2e-3)
    close(got.bg, want.bg, 1e-4)
    close(got.ba, want.ba, 2e-3)
    close(got.gw, want.gw, 1e-3)
    close(got.v, want.v, 2e-3)


# ---------------------------------------------------------------------------
# Odometry ring
# ---------------------------------------------------------------------------


def test_odom_ring_matches_numpy_fallback(monkeypatch):
    """Same pushes, same windows as the JAX package's numpy fallback,
    across wrap-around, partial windows, an overfull window and the
    zero-order-hold tail fill; the converted ring reads the same."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    jring, tring = jnative.OdomRing(64), OdomRing(64)
    assert not jring.native
    rng = np.random.RandomState(6)
    t = np.cumsum(rng.uniform(0.004, 0.006, 100))
    v = rng.randn(100, 6).astype(np.float32)
    for ring in (jring, tring):
        ring.push_bulk(t[:60], v[:60])
        for i in range(60, 100):
            ring.push(t[i], v[i])
    assert tring.size() == jring.size() == 64
    assert tring.latest_time() == jring.latest_time()
    copied = convert.odom_ring_from_jax(jring)
    for t0, t1, cap in ((t[40], t[50], 16), (t[40] - 0.002, t[60], 8),
                        (t[30], t[45], 32), (t[90], t[99] + 0.05, 16),
                        (t[95], t[99] + 0.2, 4)):
        want = jring.window(t0, t1, cap)
        for ring in (tring, copied):
            got = ring.window(t0, t1, cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        want = jring.window_filled(t0, t1, cap, tail_tol=0.01)
        got = tring.window_filled(t0, t1, cap, tail_tol=0.01)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tring.wait_until(t[99], 0.0)
    assert not tring.wait_until(t[99] + 1.0, 0.0)
