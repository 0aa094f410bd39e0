"""The port's examples against the JAX package's: examples/
evaluate_ntimes.py (the setup of all 17 scenarios, a hardened frame of
its renderer) and run_synthetic.py.  (The keys of a row's numbers:
test_torch_rows.py; run_euroc.py, the lazy API and the entry:
test_torch_entry_points.py.)

Tolerances: scenario setup (worlds, paths, black frames, map reuse
frame, cameras, ORB and loop-closer configuration) and rendered images
equal.
"""

import importlib.util
import os
import tempfile

import numpy as np
import pytest
import torch

from vieo_slam_tpu.backend.loop_closing import (
    LoopClosingConfig as JLoopClosingConfig)
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
from vieo_slam_tpu_torch.examples import run_synthetic
from vieo_slam_tpu_torch.sim import world as tworld

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The JAX package's examples (their top levels import numpy alone).
JEV = _load("jax_evaluate_ntimes", os.path.join(ROOT, "examples",
                                                "evaluate_ntimes.py"))
SCENARIOS = ",".join((JEV.ALL, JEV.LOOP_SCENARIOS, JEV.LEM_SCENARIOS,
                      JEV.RECOVERY_SCENARIOS)).split(",")


def test_scenario_matrix_and_constants_match_jax():
    assert len(SCENARIOS) == 17
    for k in ("ALL", "LOOP_SCENARIOS", "LEM_SCENARIOS", "RECOVERY_SCENARIOS",
              "NOISE_SIGMA", "DYNAMIC_FRAC", "DEPTH_OUTLIER_FRAC",
              "LOOP_RADIUS", "LOOP_FRAMES_PER_LAP"):
        assert getattr(ev, k) == getattr(JEV, k), k
    for t in (0.0, 1.3, 17.9):
        assert ev.gain_bias(t) == JEV._gain_bias(t)


def _jax_setup(name, n_frames):
    """The setup of examples/evaluate_ntimes.py's run_once, built from the
    JAX modules with that file's constants."""
    is_lem = name.endswith("_lem")
    is_loop = name.endswith("_loop") or is_lem
    base = {"stereo_loop": "stereo", "mono_loop": "mono",
            "vio_loop": "stereo_vio",
            "stereo_lem": "stereo", "vio_lem": "stereo_vio",
            "stereo_blackout": "stereo", "vio_blackout": "stereo_vio",
            "map_reuse": "stereo",
            "multicam4_kb8": "multicam_kb8"}.get(name, name)
    bo = ((3 * n_frames) // 5, (3 * n_frames) // 5 + 12) \
        if name.endswith("_blackout") else (-1, -1)
    reuse_at = (3 * n_frames) // 5 if name == "map_reuse" else -1
    ts = np.arange(n_frames) * 0.1
    omega = 2 * np.pi / (JEV.LOOP_FRAMES_PER_LAP * 0.1)
    if is_lem:
        wcfg = jworld.WorldConfig(n_landmarks=4000, seed=4,
                                  extent=(10.0, 7.0, 3.0),
                                  dynamic_frac=JEV.DYNAMIC_FRAC)
        path = jworld.figure_eight_trajectory(ts, a=3.0, b=1.0, omega=omega)
    elif is_loop:
        wcfg = jworld.WorldConfig(n_landmarks=4000, seed=4,
                                  extent=(8.0, 6.0, 3.0),
                                  dynamic_frac=JEV.DYNAMIC_FRAC)
        path = jworld.circle_trajectory(ts, radius=JEV.LOOP_RADIUS,
                                        omega=omega, look_outward=True)
    else:
        wcfg = jworld.WorldConfig(n_landmarks=2200, seed=4,
                                  extent=(6.0, 4.5, 3.0),
                                  dynamic_frac=JEV.DYNAMIC_FRAC)
        path = jworld.circle_trajectory(ts, radius=1.0, omega=0.35,
                                        look_outward=True)
    cam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    rig = None
    if base == "multicam_kb8":
        offsets = [np.zeros(3), np.asarray([-0.2, 0, 0])]
        if name == "multicam4_kb8":
            offsets += [np.asarray([0, -0.1, 0]), np.asarray([-0.2, -0.1, 0])]
        rig = [jcm.make_kb8(400.0, 400.0, 320.0, 240.0,
                            [0.02, 0.002, -0.001, 0.0005], 640, 480,
                            Rcr=np.eye(3, dtype=np.float32),
                            tcr=off.astype(np.float32)) for off in offsets]
    return dict(
        base=base, is_lem=is_lem, is_loop=is_loop, world_cfg=wcfg, ts=ts,
        path=path, bo=bo, reuse_at=reuse_at, cam=cam, bf=400.0 * 0.2,
        rig=rig, ocfg=jorb.OrbConfig(
            n_features=1000 if base == "mono" else 600, n_levels=4),
        lc_cfg=JLoopClosingConfig(min_kf_gap=30 if is_loop else 8,
                                  fix_scale=(base != "mono")))


def _cams_equal(a, b):
    assert a.kind == b.kind
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("dist", "Rcr", "tcr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_setup_matches_jax(name):
    n = 360 if name.endswith(("_loop", "_lem")) else 60
    got, want = ev.scenario(name, n), _jax_setup(name, n)
    for k in ("base", "is_lem", "is_loop", "bo", "reuse_at", "bf"):
        assert getattr(got, k) == want[k], k
    assert got.world_cfg.__dict__ == want["world_cfg"].__dict__
    np.testing.assert_array_equal(got.ts, want["ts"])
    for g, w in zip((got.Rwc, got.twc, got.v_w, got.a_w), want["path"]):
        np.testing.assert_array_equal(g, w)
    _cams_equal(got.cam, want["cam"])
    assert (got.rig is None) == (want["rig"] is None)
    for a, b in zip(got.rig or [], want["rig"] or []):
        _cams_equal(a, b)
    for f in ("n_features", "n_levels", "scale_factor", "fast_threshold",
              "fast_min_threshold", "cell_size", "cell_topk", "border"):
        assert getattr(got.ocfg, f) == getattr(want["ocfg"], f), f
    assert got.lc_cfg.__dict__ == want["lc_cfg"].__dict__
    if name in ("stereo_lem", "vio_lem", "mono_loop"):
        # the world itself (landmarks, descriptors)
        wt = tworld.SyntheticWorld(got.world_cfg)
        wj = jworld.SyntheticWorld(want["world_cfg"])
        np.testing.assert_array_equal(wt.pw, wj.pw)
        np.testing.assert_array_equal(wt.desc, wj.desc)


def test_hardened_render_matches_jax():
    """A figure-eight row's frame with every hardening on (moving
    landmarks, noise, drift, RGB-D depth outliers) renders as in JAX."""
    sc, want = ev.scenario("stereo_lem", 40), _jax_setup("stereo_lem", 40)
    wt = tworld.SyntheticWorld(sc.world_cfg)
    wj = jworld.SyntheticWorld(want["world_cfg"])
    Rcw, tcw = tworld.trajectory_to_tcw(sc.Rwc, sc.twc)
    for i in (0, 23, 39):
        t = float(sc.ts[i])
        g, b = ev.gain_bias(t)
        kw = dict(t=t, noise_sigma=ev.NOISE_SIGMA, gain=g, bias=b,
                  return_depth=True,
                  depth_outlier_frac=ev.DEPTH_OUTLIER_FRAC)
        got = wt.render_view(sc.cam, Rcw[i], tcw[i],
                             rng=np.random.RandomState(i), **kw)
        exp = wj.render_view(want["cam"], Rcw[i], tcw[i],
                             rng=np.random.RandomState(i), **kw)
        for a, e in zip(got, exp):
            np.testing.assert_array_equal(a, e)


def test_run_synthetic_with_viewer(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = run_synthetic.main(["--frames", "12", "--viewer", "--device",
                              "cpu"])
    assert res["n"] == 12 and res["rmse"] < 0.01
    assert (tmp_path / "vieo_viewer").is_dir()
    traj = np.loadtxt(tmp_path / "traj_synthetic.txt")
    assert traj.shape == (12, 8)
    assert (tmp_path / "map_synthetic.npz").stat().st_size > 0
