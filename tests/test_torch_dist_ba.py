"""The port's landmark-sharded distributed BA (parallel/dist_ba.py) against
the JAX package's, on CPU meshes: the port's mesh is a list of CPU
devices, the JAX package's the suite's 8 virtual CPU devices.

- One distributed step on test_local_ba.make_world(K=4, M=40, O=3)
  padded to 8 landmark shards, against the JAX step under each of its
  two pair fills (one-hot and scatter; the port has the scatter alone),
  within the JAX package's own tolerances of tests/test_dist_ba.py (R
  2e-5, t and pw 2e-4), and against the port's single-device
  _ba_iteration over 1, 2, 4 and 8 shards (the same tolerances: the
  shards sum the same f32 terms in another order).
- Convergence from perturbed poses and points, with the bars of the JAX
  test_converges.
- The global BA's distributed branch on a port System built as
  tests/test_async_gba.py's _build_small_map builds its map, over an
  explicit 8-entry CPU mesh: an abort between the stages leaves the map
  bit for bit as it was; an unaborted solve brings the keyframe ATE under
  0.02 m, with keyframe poses within 1e-4 and landmarks within 2e-4 of
  the JAX package's distributed GBA of the same map with the same edits.
  The branch rule: which runs, and one distributed_ba call a stage.
- Two gloo ranks (parallel/multiprocess.py) against the in-process
  2-shard solve, within 1e-5; a NCCL world larger than the visible GPUs
  is refused.
- make_ba_mesh() without a list takes CUDA devices only, and raises
  without a GPU; the dry run (parallel/dryrun.py) over 4 CPU entries
  equals its single-device run.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dist_ba import _pad_problem_lms
from test_local_ba import make_world
from vieo_slam_tpu.backend.local_mapping import LocalMapper as JLocalMapper
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.map.map_state import MapConfig as JMapConfig
from vieo_slam_tpu.map.map_state import MapState as JMapState
from vieo_slam_tpu.parallel import dist_ba as jdba
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend import local_mapping as tlm
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend.frame import make_frame_from_features
from vieo_slam_tpu_torch.io.evaluate import ate
from vieo_slam_tpu_torch.map.map_state import MapState
from vieo_slam_tpu_torch.math import lie
from vieo_slam_tpu_torch.parallel import dist_ba as tdba
from vieo_slam_tpu_torch.parallel.dryrun import dryrun_multichip
from vieo_slam_tpu_torch.parallel.multiprocess import run_distributed_ba
from vieo_slam_tpu_torch.parallel.synthetic import scaling_problem
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.solvers import local_ba as tlba
from vieo_slam_tpu_torch.system import System, SystemConfig

# One intra-op thread: the suite runs several worker processes at once.
torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2
TOL = {"R": 2e-5, "t": 2e-4, "pw": 2e-4}       # tests/test_dist_ba.py


def f32(prob):
    """make_world's problem with every float field in f32 (the suite runs
    JAX with x64 on, and make_world's points are f64)."""
    return prob._replace(**{k: jnp.asarray(v, jnp.float32)
                            for k, v in prob._asdict().items()
                            if jnp.issubdtype(v.dtype, jnp.floating)})


def port_problem(prob):
    return tlba.BAProblem(**{k: torch.from_numpy(np.array(v))
                             for k, v in f32(prob)._asdict().items()})


def cpu_mesh(n):
    return tdba.make_ba_mesh(["cpu"] * n)


def assert_step_close(got, want):
    for g, w, name in zip(got, want, ("R", "t", "pw")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=TOL[name], err_msg=name)


@pytest.fixture(scope="module")
def padded_world():
    cam, bf, prob, _ = make_world(K=4, M=40, O=3, noise=0.1)
    return cam, bf, f32(_pad_problem_lms(prob, 8))


@pytest.mark.parametrize("fill", ["onehot", "scatter"])
def test_step_matches_jax(padded_world, fill, monkeypatch):
    cam, bf, prob = padded_world
    monkeypatch.setattr(jdba, "PAIRFILL_MODE", fill)
    mesh = jdba.make_ba_mesh()
    # jitted: shard_map run op by op takes half a minute here
    want = jax.jit(lambda p: jdba.distributed_ba_step(
        p, cam, jnp.asarray(bf, jnp.float32), p.obs_valid,
        jnp.asarray(1e-3, jnp.float32), mesh))(jdba.shard_problem(prob, mesh))
    tprob = port_problem(prob)
    got = tdba.distributed_ba_step(tprob, convert.camera_from_jax(cam), bf,
                                   tprob.obs_valid, 1e-3, cpu_mesh(8))
    assert_step_close(got, want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_step_matches_single_device(padded_world, n):
    cam, bf, prob = padded_world
    cam, prob = convert.camera_from_jax(cam), port_problem(prob)
    lam = torch.tensor(1e-3)
    want = tlba._ba_iteration(prob.Rcw, prob.tcw, prob.pw, prob, cam,
                              torch.tensor(bf, dtype=torch.float32),
                              prob.obs_valid, lam)
    got = tdba.distributed_ba_step(prob, cam, bf, prob.obs_valid, lam,
                                   cpu_mesh(n))
    assert_step_close(got, want)
    assert got[2].shape == prob.pw.shape


def test_converges():
    cam, bf, prob, (R_t, t_t, pw_t) = make_world(K=5, M=64, O=5, noise=0.1)
    cam, prob = convert.camera_from_jax(cam), port_problem(prob)
    rng = np.random.RandomState(5)
    dx = np.zeros((5, 6), np.float32)
    dx[1:] = rng.randn(4, 6) * 0.01
    dRs, dts = lie.se3_exp(torch.from_numpy(dx))
    prob = prob._replace(
        Rcw=dRs @ prob.Rcw,
        tcw=torch.einsum("kij,kj->ki", dRs, prob.tcw) + dts,
        pw=prob.pw + torch.from_numpy(
            0.03 * rng.randn(64, 3).astype(np.float32)))
    prob = tdba.pad_landmarks(prob, 8)
    Rf, tf, pf = tdba.distributed_ba(prob, cam, bf, cpu_mesh(8), iters=12)
    for k in range(1, 5):
        dR = Rf[k].numpy() @ R_t[k].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 1e-2, k
        assert np.linalg.norm(tf[k].numpy() - t_t[k]) < 5e-2, k
    err = np.linalg.norm(pf.numpy()[:64] - pw_t, axis=1)
    assert np.median(err) < 6e-2


# ---------------------------------------------------------------------------
# The global BA's distributed branch on a System's map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_map():
    """A port System's map, built as tests/test_async_gba.py's
    _build_small_map builds the JAX package's (24 frames of the same
    feature-level world), with the true camera positions."""
    cam = tcm.make_pinhole(*CAM)
    world = tworld.SyntheticWorld(tworld.WorldConfig(
        n_landmarks=2500, seed=5, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(24) * 0.1
    Rwc, twc, _, _ = tworld.circle_trajectory(ts, radius=1.0, omega=0.3,
                                              look_outward=True)
    Rcw, tcw = tworld.trajectory_to_tcw(Rwc, twc)
    system = System(cam, BF, SystemConfig(), device="cpu")
    rng = np.random.RandomState(2)
    for i in range(len(ts)):
        obs = world.observe(Rcw[i], tcw[i], cam, bf=BF, n_kp=400,
                            pixel_noise=0.3, bit_flips=4, clutter=30,
                            rng=rng, max_depth=10.0)
        system.track_frame(make_frame_from_features(
            obs["uv"], obs["level"], obs["angle"], obs["desc"],
            obs["valid"], ur=obs["ur"], depth=obs["depth"], timestamp=ts[i],
            device="cpu"))
    return system.map, (ts, twc)


def system_on(m, mesh):
    """A port System over a copy of map m, its global BA over `mesh`."""
    system = System(tcm.make_pinhole(*CAM), BF, SystemConfig(), device="cpu")
    copy = MapState(m.cfg)
    for name, value in m.__dict__.items():
        if name not in ("lock", "_covis_cache"):
            setattr(copy, name, value.copy() if hasattr(value, "copy")
                    else value)
    system.map = system.tracker.map = system.mapper.map = copy
    system.mapper.ba_mesh = mesh
    return system


def jax_mapper_on(m):
    """The JAX package's mapper over a copy of the port's map m."""
    jm = JMapState(JMapConfig(**{f.name: getattr(m.cfg, f.name)
                                 for f in dataclasses.fields(JMapConfig)}))
    for name in convert._MAP_ARRAYS:
        setattr(jm, name, np.array(getattr(m, name), copy=True))
    for name in ("version", "big_change_idx", "_next_kf", "_next_lm"):
        setattr(jm, name, int(getattr(m, name)))
    jm._lm_free = list(m._lm_free)
    return JLocalMapper(jcm.make_pinhole(*CAM), BF, jm)


class AbortAfter:
    """A stand-in for threading.Event that reads as set from its n-th
    is_set() on."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


def count_distributed_calls(monkeypatch):
    calls = []

    def spy(*args, **kw):
        calls.append(kw["iters"])
        return tdba.distributed_ba(*args, **kw)

    monkeypatch.setattr(tlm, "distributed_ba", spy)
    return calls


def test_mid_solve_abort_discards_result(small_map, monkeypatch):
    m, _ = small_map
    system = system_on(m, cpu_mesh(8))
    pm = system.map
    before = (pm.kf_Rcw.copy(), pm.kf_tcw.copy(), pm.lm_pw.copy())
    calls = count_distributed_calls(monkeypatch)
    ev, jev = AbortAfter(1), AbortAfter(1)
    ok = system.mapper.run_global_ba(abort=ev, distributed=True,
                                     stage_iters=(2, 3))
    jmapper = jax_mapper_on(m)
    ok_j = jmapper.run_global_ba(abort=jev, distributed=True,
                                 stage_iters=(2, 3))
    assert ok is ok_j is False
    assert ev.calls == jev.calls == 2          # the between-stage check
    assert calls == [2]
    np.testing.assert_array_equal(pm.kf_Rcw, before[0])
    np.testing.assert_array_equal(pm.kf_tcw, before[1])
    np.testing.assert_array_equal(pm.lm_pw, before[2])
    np.testing.assert_array_equal(pm.lm_valid, jmapper.map.lm_valid)


def test_unaborted_distributed_gba_improves_map(small_map, monkeypatch):
    m, (ts, twc) = small_map
    system = system_on(m, cpu_mesh(8))
    pm = system.map
    jmapper = jax_mapper_on(m)
    jm = jmapper.map
    kfs = pm.keyframe_ids()
    pm.kf_tcw[kfs[1:]] += np.float32(0.01)
    jm.kf_tcw[kfs[1:]] += np.float32(0.01)
    calls = count_distributed_calls(monkeypatch)
    ok = system.mapper.run_global_ba(abort=threading.Event(),
                                     distributed=True, stage_iters=(3, 3))
    ok_j = jmapper.run_global_ba(abort=threading.Event(), distributed=True,
                                 stage_iters=(3, 3))
    assert ok is ok_j is True
    assert calls == [3, 3]
    p = np.stack([-(pm.kf_Rcw[k].T @ pm.kf_tcw[k]) for k in kfs])
    res = ate(pm.kf_timestamp[kfs], p, ts, twc)
    assert res["rmse"] < 0.02, res
    np.testing.assert_allclose(pm.kf_Rcw[kfs], jm.kf_Rcw[kfs], atol=1e-4)
    np.testing.assert_allclose(pm.kf_tcw[kfs], jm.kf_tcw[kfs], atol=1e-4)
    np.testing.assert_array_equal(pm.lm_valid, jm.lm_valid)
    np.testing.assert_allclose(pm.lm_pw[pm.lm_valid], jm.lm_pw[jm.lm_valid],
                               atol=2e-4)


@pytest.mark.parametrize("shards, distributed, lm_pad, stages", [
    (8, None, 1024, []),          # auto: 1024 padded landmarks < 8192
    (8, None, 8192, [2, 3]),      # auto: 8192 padded landmarks
    (1, True, 1024, []),          # one shard: the single-device solve
    (8, True, 1024, [2, 3]),
], ids=["auto_small", "auto_8192", "one_shard", "forced"])
def test_branch_rule(small_map, monkeypatch, shards, distributed, lm_pad,
                     stages):
    m, _ = small_map
    system = system_on(m, cpu_mesh(shards))
    system.mapper.cfg = dataclasses.replace(system.mapper.cfg,
                                            ba_lm_pad=lm_pad)
    calls = count_distributed_calls(monkeypatch)
    assert system.mapper.run_global_ba(distributed=distributed,
                                       stage_iters=(2, 3)) is True
    assert calls == stages


# ---------------------------------------------------------------------------
# Across processes, meshes, the dry run
# ---------------------------------------------------------------------------


def test_two_gloo_ranks_match_in_process():
    cam, bf, prob = scaling_problem(K=8, M=512, O=8, seed=3)
    R, t = run_distributed_ba(prob, cam, bf, 2, stage_iters=(3, 2),
                              backend="gloo", timeout=120.0)
    mesh, p = cpu_mesh(2), prob
    for it in (3, 2):
        R2, t2, pw2 = tdba.distributed_ba(p, cam, bf, mesh, iters=it)
        p = p._replace(Rcw=R2, tcw=t2, pw=pw2)
    np.testing.assert_allclose(R, R2.numpy(), atol=1e-5)
    np.testing.assert_allclose(t, t2.numpy(), atol=1e-5)
    assert np.abs(t - prob.tcw.numpy()).max() > 1e-3     # it did move


def test_nccl_world_larger_than_the_gpus_is_refused():
    cam, bf, prob = scaling_problem(K=4, M=64, O=4)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="one GPU a rank"):
        run_distributed_ba(prob, cam, bf, n + 1, backend="nccl",
                           stage_iters=(1,))


def test_default_mesh_takes_cuda_devices_only():
    if torch.cuda.is_available():
        mesh = tdba.make_ba_mesh()
        assert mesh.devices and all(d.type == "cuda" for d in mesh.devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdba.make_ba_mesh()
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.local_rows(12) == slice(0, 12)


def test_dryrun_equals_one_device():
    out = dryrun_multichip(["cpu"] * 4)
    assert out["extraction"]["max_abs_diff"] == 0.0
    assert out["matching"]["max_abs_diff"] == 0.0
    assert out["matching"]["matched"] > 0
    assert out["ba_step"]["max_abs_diff"] < TOL["t"]
    assert out["ba_step"]["pw_max_abs_diff"] < TOL["pw"]
    for part in out.values():
        assert part["devices"] == ["cpu"] * 4
