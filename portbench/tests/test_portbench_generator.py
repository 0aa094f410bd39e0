"""The frozen generator against the program's generator at the commit that
froze it, and the device renderer against the frozen numpy renderer."""

import numpy as np
import pytest
import torch

from portbench import generator as gen
from portbench import render
from vieo_slam_tpu_torch.cameras import models as cm
from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
from vieo_slam_tpu_torch.sim import world as sim

WORLD = dict(n_landmarks=4000, seed=4, extent=(8.0, 6.0, 3.0),
             dynamic_frac=0.02)


def _path(n=4):
    ts = np.arange(n) * 0.05
    return ts, sim.circle_trajectory(ts, radius=1.5, omega=0.2,
                                     look_outward=True)


def test_world_and_frames_equal_the_programs():
    ts, (Rwc, twc, _, _) = _path()
    Rcw, tcw = sim.trajectory_to_tcw(Rwc, twc)
    ours = gen.SyntheticWorld(gen.WorldConfig(**WORLD))
    theirs = sim.SyntheticWorld(sim.WorldConfig(**WORLD))
    for key in ("pw", "desc", "level", "saliency", "dynamic_ids"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(theirs, key))
    cam_o = gen.make_pinhole(435.2, 435.2, 367.45, 252.2, 752, 480)
    cam_t = cm.make_pinhole(435.2, 435.2, 367.45, 252.2, 752, 480)
    r_o, r_t = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(2):
        g, b = gen.gain_bias(ts[i])
        assert (g, b) == ev.gain_bias(ts[i])
        kw = dict(t=ts[i], noise_sigma=gen.NOISE_SIGMA, gain=g, bias=b)
        left_o, right_o = ours.render_stereo(cam_o, Rcw[i], tcw[i], 0.11,
                                             rng=r_o, **kw)
        left_t, right_t = theirs.render_stereo(cam_t, Rcw[i], tcw[i], 0.11,
                                               rng=r_t, **kw)
        np.testing.assert_array_equal(left_o, left_t)
        np.testing.assert_array_equal(right_o, right_t)
    assert gen.NOISE_SIGMA == ev.NOISE_SIGMA
    assert gen.DYNAMIC_FRAC == ev.DYNAMIC_FRAC


def test_paths_and_imu_equal_the_programs():
    ts = np.arange(40) * 0.05
    ours = gen.circle_trajectory(ts, radius=1.5, omega=0.2, look_outward=True)
    theirs = sim.circle_trajectory(ts, radius=1.5, omega=0.2,
                                   look_outward=True)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    Rwc, _, v_w, a_w = ours
    kw = dict(rate_hz=200.0, bg=ev.VIO_BG, ba=ev.VIO_BA, noise_g=1e-4,
              noise_a=1e-3, seed=0)
    for a, b in zip(gen.make_imu_samples(ts, Rwc.astype(np.float64), v_w,
                                         a_w, **kw),
                    sim.make_imu_samples(ts, Rwc.astype(np.float64), v_w,
                                         a_w, **kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drift", [False, True])
def test_device_renderer_matches_the_numpy_renderer(drift):
    """Without noise, every pixel within 0.05 grey levels of the numpy
    renderer's (the products of the projection round in another order,
    which moves a stamp by ~1e-6 px) but for a few stamp edges."""
    ts, (Rwc, twc, _, _) = _path(3)
    ts = ts + 7.0
    Rcw, tcw = gen.trajectory_to_tcw(Rwc, twc)
    world = gen.SyntheticWorld(gen.WorldConfig(**WORLD))
    cam = dict(fx=435.2, fy=435.2, cx=367.45, cy=252.2, width=752,
               height=480)
    gains, biases = gen.gain_bias(ts) if drift else (np.ones(3), np.zeros(3))
    got = render.render_views(world, cam, Rcw, tcw, ts, gains, biases, 0.0,
                              None, torch.device("cpu"), quantize=False)
    c = gen.make_pinhole(435.2, 435.2, 367.45, 252.2, 752, 480)
    for i in range(3):
        want = world.render_view(c, Rcw[i], tcw[i], t=ts[i], gain=gains[i],
                                 bias=biases[i])
        d = np.abs(got[i].numpy() - want)
        assert (d > 0.05).mean() < 1e-3
        assert d.max() < 1.0
