"""The port's run_euroc.py, lazy top-level API and entry against the JAX
package's examples/run_euroc.py, vieo_slam_tpu/__init__.py and
__graft_entry__.entry.

Tolerances:
- run_euroc: the same frames tracked by both packages, TUM timestamps
  equal, camera positions within 2e-3 m and orientations within 2e-3 rad
  (test_torch_system.py's bound for the two Systems);
- the entry's inputs equal.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import vieo_slam_tpu_torch
from vieo_slam_tpu_torch import entry as tentry
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.examples import run_euroc
from vieo_slam_tpu_torch.io.png import write_png
from vieo_slam_tpu_torch.sim import world as tworld

from test_torch_io import EUROC_YAML
from test_torch_system import rot_angle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# A small EuRoC folder at test_torch_io.py's EUROC_YAML (752x480, fx
# 435.2, bf 47.9, 375 features on 8 levels, no loop closing): 5 stereo
# frames of a textured world at 20 Hz.
EUROC_FRAMES = 5


@pytest.fixture(scope="module")
def euroc_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    fx, cx, cy, bf = 435.2, 367.4, 252.2, 47.9
    cam = tcm.make_pinhole(fx, fx, cx, cy, 752, 480)
    world = tworld.SyntheticWorld(tworld.WorldConfig(
        n_landmarks=2200, seed=4, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(EUROC_FRAMES) * 0.05
    Rwc, twc, _, _ = tworld.circle_trajectory(ts, radius=1.0, omega=0.35,
                                              look_outward=True)
    Rcw, tcw = tworld.trajectory_to_tcw(Rwc, twc)
    mav = root / "mav0"
    ns = [int(1e9 * (100 + t)) for t in ts]
    for c in ("cam0", "cam1"):
        (mav / c / "data").mkdir(parents=True)
        (mav / c / "data.csv").write_text(
            "#timestamp [ns],filename\n"
            + "".join(f"{t},{t}.png\n" for t in ns))
    for i, t in enumerate(ns):
        for c, img in zip(("cam0", "cam1"), world.render_stereo(
                cam, Rcw[i], tcw[i], bf / fx)):
            write_png(str(mav / c / "data" / f"{t}.png"),
                      np.clip(np.rint(img), 0, 255).astype(np.uint8))
    (mav / "imu0").mkdir()
    (mav / "imu0" / "data.csv").write_text(
        "#timestamp,wx,wy,wz,ax,ay,az\n" + "".join(
            f"{int(1e9 * (100 + 0.005 * i))},0,0,0,0,0,9.81\n"
            for i in range(50)))
    settings = root / "euroc.yaml"
    settings.write_text(EUROC_YAML)
    out_t, out_j = str(root / "traj_port.txt"), str(root / "traj_jax.txt")
    system = run_euroc.main([str(root), str(settings), "--out", out_t,
                             "--device", "cpu"])
    jax_run_euroc = _load("jax_run_euroc", os.path.join(ROOT, "examples",
                                                        "run_euroc.py"))
    argv = sys.argv
    sys.argv = ["run_euroc.py", str(root), str(settings), "--out", out_j]
    try:
        jax_run_euroc.main()
    finally:
        sys.argv = argv
    return system, out_t, out_j


@pytest.mark.parametrize("suffix", ["_NO_FULLBA.txt", ".txt"])
def test_run_euroc_matches_jax(euroc_runs, suffix):
    system, out_t, out_j = euroc_runs
    got = np.loadtxt(out_t.replace(".txt", suffix))
    want = np.loadtxt(out_j.replace(".txt", suffix))
    assert got.shape == want.shape == (EUROC_FRAMES, 8)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], atol=2e-3)
    from vieo_slam_tpu_torch.math import lie as tlie
    for a, b in zip(got, want):
        Ra = tlie.rotmat_from_quat(torch.tensor(a[[7, 4, 5, 6]])).numpy()
        Rb = tlie.rotmat_from_quat(torch.tensor(b[[7, 4, 5, 6]])).numpy()
        assert rot_angle(Ra, Rb) < 2e-3
    assert system.loop_closer is None           # GBA.NoLoopClosing: 1
    assert system.map.n_keyframes() >= 1
    assert np.ptp(got[:, 1:4], axis=0).max() > 0.01     # it moved


def test_lazy_api_names_the_port():
    from vieo_slam_tpu_torch.backend.loop_closing import LoopCloser
    from vieo_slam_tpu_torch.system import System
    from vieo_slam_tpu_torch.vio.frontend import VioConfig

    assert vieo_slam_tpu_torch.System is System
    assert vieo_slam_tpu_torch.LoopCloser is LoopCloser
    assert vieo_slam_tpu_torch.VioConfig is VioConfig
    jinit = _load("jax_init_api", os.path.join(ROOT, "vieo_slam_tpu",
                                               "__init__.py"))
    assert vieo_slam_tpu_torch._API == jinit._API
    with pytest.raises(AttributeError):
        vieo_slam_tpu_torch.NoSuchName


def test_entry_matches_jax():
    graft = _load("jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    _, jargs = graft.entry()
    fn, args = tentry.entry(device="cpu")
    assert len(args) == len(jargs) == 7
    for a, j in zip(args, jargs):
        j = np.asarray(j)
        a = a.numpy()
        if j.dtype == np.uint32:           # descriptors: int32 bit patterns
            a = a.view(np.uint32)
        assert a.shape == j.shape
        np.testing.assert_array_equal(a, j.astype(a.dtype))
    Rcw, tcw, n_inl, uv, desc = fn(*args)
    assert Rcw.shape == (3, 3) and tcw.shape == (3,) and n_inl.ndim == 0
    assert uv.shape == (1200, 2) and desc.shape == (1200, 8)
    assert bool(torch.isfinite(Rcw).all() and torch.isfinite(tcw).all())
