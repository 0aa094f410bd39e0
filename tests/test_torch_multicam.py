"""The port's distorted cameras, rotation-consistency check and multi-camera
frame builders against the JAX package's, on the same seeded inputs (cases
from test_cameras.py and test_multicam_frame.py), and a short multicam
System run.

Tolerances:
- camera maps in f32: pixels within 1e-3 px and their Jacobians within
  1e-3 (values of hundreds: a few ulps), unprojected rays within 2e-6
  plus 4e-6 relative (8 Newton steps, each library's arctan and
  divisions rounding apart: rays of the 512-pixel KB8 camera reach 4 in
  the normalized plane);
- the rotation histogram's bins and its top-3 choice exactly, ties too;
- a KB8 rendering within 0.05 gray levels, 99 % of the pixels equal;
- multicam frames (the same rendered KB8 images through both
  extractions): keypoints within 1e-3 px and validity equal; the depth of
  a keypoint may be present on one side only for at most 3 % of the
  valid keypoints (ORB's tail may flip descriptor bits and round IC
  angles apart, which moves a match across the ratio, Hamming or
  rotation-histogram gate); where both triangulated, 95 % agree to 1e-3
  relative depth; per view, matches and accepted triangulations within
  3 % and the mean squared reprojection error within 10 %;
- the multicam System: identical track states, keyframe counts within
  one, per-frame positions within 5 mm (frames that differ as above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.backend.loop_closing import LoopCloser as JLoopCloser
from vieo_slam_tpu.backend.loop_closing import (
    LoopClosingConfig as JLoopClosingConfig)
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.frontend.tracking import TrackerConfig as JTrackerConfig
from vieo_slam_tpu.ops import matching as jmatching
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend.loop_closing import (LoopCloser,
                                                      LoopClosingConfig)
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
from vieo_slam_tpu_torch.ops import matching as tmatching
from vieo_slam_tpu_torch.ops import orb as torb
from vieo_slam_tpu_torch.sim import world as tworld
from vieo_slam_tpu_torch.system import System, SystemConfig

torch.set_num_threads(1)

KB8_DIST = [0.02, 0.002, -0.001, 0.0005]
BASE = 0.11
# test_cameras.py's models (EuRoC radtan, TUM-VI KB8).
MODELS = {
    "radtan": ("make_radtan", (458.6, 457.3, 367.2, 248.4),
               [-0.283, 0.0739, 0.0002, 1.76e-5], 752, 480),
    "kb8": ("make_kb8", (190.97, 190.97, 254.93, 256.89),
            [0.0034, 0.00077, -0.0025, 0.00069], 512, 512),
    "kb8_rig": ("make_kb8", (300.0, 300.0, 320.0, 240.0), KB8_DIST, 640,
                480),
}
T = torch.from_numpy


def _cams(name):
    mk, k, dist, w, h = MODELS[name]
    return (getattr(jcm, mk)(*k, dist, w, h),
            getattr(tcm, mk)(*k, dist, w, h))


def _same_camera(a, b):
    for f in ("fx", "fy", "cx", "cy", "kind", "width", "height"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("dist", "Rcr", "tcr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", list(MODELS))
def test_camera_maps_match_jax(name):
    jc, tc = _cams(name)
    _same_camera(convert.camera_from_jax(jc), tc)
    rng = np.random.RandomState(0)
    pc = np.concatenate([rng.randn(256, 2) * 0.6,
                         2.0 + rng.rand(256, 1) * 4.0], 1).astype(np.float32)
    pc[0, :2] = 0.0                       # on the axis (KB8's r < 1e-8)
    pc[1, :2] = 1e-9
    np.testing.assert_allclose(tcm.project(tc, T(pc)).numpy(),
                               np.asarray(jcm.project(jc, jnp.asarray(pc))),
                               atol=1e-3)
    uv_t, J_t = tcm.project_jacobian(tc, T(pc))
    uv_j, J_j = jcm.project_jacobian(jc, jnp.asarray(pc))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-3)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-3)
    uv = np.stack([rng.rand(512) * tc.width, rng.rand(512) * tc.height],
                  1).astype(np.float32)
    rays = tcm.unproject(tc, T(uv)).numpy()
    assert np.isfinite(rays).all()
    np.testing.assert_allclose(rays, np.asarray(jcm.unproject(
        jc, jnp.asarray(uv))), rtol=4e-6, atol=2e-6)


def test_rotation_consistency_mask_ties():
    """Four bins hold 6, 6, 6 and 6 matches: the three lowest bins win,
    as lax.top_k breaks ties; a histogram with distinct counts too."""
    for counts in ((0, 6, 0, 6, 6, 0, 6), (5, 2, 9, 2, 1, 3, 9)):
        bins = np.repeat(np.arange(len(counts)) * 4, counts)
        n = len(bins)
        rng = np.random.RandomState(1)
        angle_b = (rng.rand(n) * 2 * np.pi).astype(np.float32)
        frac = (bins + 0.5) / jmatching.HISTO_BINS
        angle_a = (angle_b + frac * 2 * np.pi).astype(np.float32)
        match = rng.permutation(n).astype(np.int32)
        angle_b = angle_b[np.argsort(match)]      # b[match[i]] pairs a[i]
        valid = rng.rand(n) > 0.1
        want = np.asarray(jmatching.rotation_consistency_mask(
            jnp.asarray(angle_a), jnp.asarray(angle_b), jnp.asarray(match),
            jnp.asarray(valid)))
        got = tmatching.rotation_consistency_mask(
            T(angle_a), T(angle_b), T(match), T(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() < valid.sum()


@pytest.fixture(scope="module")
def rig():
    """test_multicam_frame.py's KB8 rig (640x480) and a second pair 0.055 m
    below it, rendered once by the JAX package's world."""
    offsets = [np.zeros(3), np.array([-BASE, 0, 0]),
               np.array([0, -0.5 * BASE, 0]),
               np.array([-BASE, -0.5 * BASE, 0])]
    jcams = [jcm.make_kb8(300.0, 300.0, 320.0, 240.0, KB8_DIST, 640, 480,
                          Rcr=np.eye(3, dtype=np.float32),
                          tcr=o.astype(np.float32)) for o in offsets]
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=1200, seed=5, extent=(6.0, 4.5, 3.0)))
    Rwc, twc, _, _ = jworld.circle_trajectory(np.zeros(1), radius=1.0,
                                              omega=0.25, look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    imgs = [world.render_view(c, c.Rcr @ Rcw[0], c.Rcr @ tcw[0] + c.tcr)
            for c in jcams]
    return dict(jcams=jcams, tcams=[convert.camera_from_jax(c)
                                    for c in jcams],
                jgeom=jcm.make_pinhole(300.0, 300.0, 320.0, 240.0, 640, 480),
                tgeom=tcm.make_pinhole(300.0, 300.0, 320.0, 240.0, 640, 480),
                imgs=imgs, pose=(Rcw[0], tcw[0]), world=world)


def test_render_view_kb8_matches_jax(rig):
    tw = tworld.SyntheticWorld(tworld.WorldConfig(
        n_landmarks=1200, seed=5, extent=(6.0, 4.5, 3.0)))
    Rcw, tcw = rig["pose"]
    got = tw.render_view(rig["tcams"][1], Rcw, tcw + rig["tcams"][1].tcr)
    # The stamps sit where KB8 projects the landmarks: f32 arctan rounds
    # apart in the last bits, which moves a stamp's sub-pixel blend.
    np.testing.assert_allclose(got, rig["imgs"][1], rtol=0, atol=0.05)
    assert np.mean(got == rig["imgs"][1]) > 0.99


def _frames_agree(jf, tf):
    np.testing.assert_allclose(tf.uv.numpy(), np.asarray(jf.uv), atol=1e-3)
    valid = np.asarray(jf.valid)
    np.testing.assert_array_equal(tf.valid.numpy(), valid)
    dj, dt = np.asarray(jf.depth), tf.depth.numpy()
    one_side = valid & ((dj > 0) != (dt > 0))
    assert one_side.sum() <= 0.03 * valid.sum(), (one_side.sum(),
                                                  valid.sum())
    both = valid & (dj > 0) & (dt > 0)
    assert both.sum() > 100
    rel = np.abs(dt[both] - dj[both]) / dj[both]
    assert np.mean(rel < 1e-3) >= 0.95, np.sort(rel)[-10:]
    ur_ok = np.abs(tf.ur.numpy()[both] - np.asarray(jf.ur)[both]) \
        <= 1e-3 + 40.0 * rel
    assert ur_ok.all()


@pytest.mark.parametrize("n_cams", [2, 4])
def test_multicam_frame_matches_jax(rig, n_cams):
    cfg = jorb.OrbConfig(n_features=500, n_levels=4)
    jf, js = jframe.build_multicam_frame(
        [jnp.asarray(x) for x in rig["imgs"][:n_cams]], rig["jcams"][:n_cams],
        cfg, geom_cam=rig["jgeom"], virt_bf=300.0 * BASE, max_depth=15.0,
        return_stats=True)
    tf, ts = tframe.build_multicam_frame(
        rig["imgs"][:n_cams], rig["tcams"][:n_cams],
        convert.orb_config_from_jax(cfg), geom_cam=rig["tgeom"],
        virt_bf=300.0 * BASE, max_depth=15.0, return_stats=True,
        device="cpu")
    _frames_agree(jf, tf)
    assert len(ts) == len(js) == n_cams - 1
    for a, b in zip(js, ts):
        for key, rtol in (("matches", 0.03), ("accepted", 0.03),
                          ("mean_err2", 0.10)):
            assert isinstance(b[key], torch.Tensor)
            np.testing.assert_allclose(float(b[key]), float(a[key]),
                                       rtol=rtol, err_msg=key)
        assert float(b["accepted"]) > 0


def test_undistorted_mono_frame_matches_jax(rig):
    cfg = jorb.OrbConfig(n_features=400, n_levels=4)
    jf = jframe.build_undistorted_mono_frame(
        jnp.asarray(rig["imgs"][0]), rig["jcams"][0], cfg,
        geom_cam=rig["jgeom"], timestamp=0.5)
    tf = tframe.build_undistorted_mono_frame(
        rig["imgs"][0], rig["tcams"][0], convert.orb_config_from_jax(cfg),
        geom_cam=rig["tgeom"], timestamp=0.5, device="cpu")
    np.testing.assert_allclose(tf.uv.numpy(), np.asarray(jf.uv), atol=1e-3)
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    assert (tf.depth.numpy() < 0).all() and tf.timestamp == 0.5
    assert tf.valid.sum() > 150


def test_multicam_builders_need_a_device_or_cuda(rig):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = torb.OrbConfig(n_features=100, n_levels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.build_multicam_frame(rig["imgs"][:2], rig["tcams"][:2], cfg,
                                    geom_cam=rig["tgeom"], virt_bf=33.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tframe.build_undistorted_mono_frame(rig["imgs"][0], rig["tcams"][0],
                                            cfg, geom_cam=rig["tgeom"])


N_SYS = 8


def test_multicam_system_matches_jax():
    """evaluate_ntimes.py's multicam_kb8 rig (fx 400, the stereo row's 0.2 m
    baseline) over the first frames of its world, each package building
    its own frames from the same rendered images."""
    fx, base = 400.0, 0.2
    jcams = [jcm.make_kb8(fx, fx, 320.0, 240.0, KB8_DIST, 640, 480,
                          Rcr=np.eye(3, dtype=np.float32),
                          tcr=np.asarray(o, np.float32))
             for o in ([0, 0, 0], [-base, 0, 0])]
    tcams = [convert.camera_from_jax(c) for c in jcams]
    jgeom = jcm.make_pinhole(fx, fx, 320.0, 240.0, 640, 480)
    tgeom = convert.camera_from_jax(jgeom)
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=2200, seed=4, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(N_SYS) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.35,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    cfg = jorb.OrbConfig(n_features=500, n_levels=4)
    js = JSystem(jgeom, fx * base, JSystemConfig(
        tracker=JTrackerConfig(use_predicted_scale=True)))
    js.loop_closer = JLoopCloser(jgeom, fx * base, js.map,
                                 JLoopClosingConfig(min_kf_gap=8))
    ps = System(tgeom, fx * base, SystemConfig(
        tracker=TrackerConfig(use_predicted_scale=True)), device="cpu")
    ps.loop_closer = LoopCloser(tgeom, fx * base, ps.map,
                                LoopClosingConfig(min_kf_gap=8),
                                device="cpu")
    sj, st = [], []
    for i in range(N_SYS):
        imgs = [world.render_view(c, c.Rcr @ Rcw[i], c.Rcr @ tcw[i] + c.tcr)
                for c in jcams]
        jf = jframe.build_multicam_frame(
            [jnp.asarray(x) for x in imgs], jcams, cfg, geom_cam=jgeom,
            virt_bf=fx * base, max_depth=15.0, timestamp=float(ts[i]))
        tf = tframe.build_multicam_frame(
            imgs, tcams, convert.orb_config_from_jax(cfg), geom_cam=tgeom,
            virt_bf=fx * base, max_depth=15.0, timestamp=float(ts[i]),
            device="cpu")
        sj.append(js.track_frame(jf).name)
        st.append(ps.track_frame(tf).name)
    assert sj == st and "LOST" not in st, (sj, st)
    assert abs(js.map.n_keyframes() - ps.map.n_keyframes()) <= 1
    for a, b in zip(js.tracker.trajectory, ps.tracker.trajectory):
        pa = -np.asarray(a[1]).T @ np.asarray(a[2])
        pb = -b[1].T @ b[2]
        assert np.linalg.norm(pa - pb) < 5e-3
        # both within 2 cm of the truth (camera 0 of the rig)
        i = int(round(a[0] / 0.1))
        p_true = Rwc[0].T @ (twc[i] - twc[0])
        assert np.linalg.norm(pb - p_true) < 0.02
