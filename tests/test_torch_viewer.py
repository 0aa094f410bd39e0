"""The port's viewer (viz/viewer.py) against the JAX package's: the same
frusta, the same poll cadence and file names over one sequence of maps,
and PNGs written without matplotlib that the port's own reader reads back
at the expected size, with drawn pixels and the title in tEXt.

Tolerances: frustum corners within 1e-6 m; poll returns and file names
equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vieo_slam_tpu.map.map_state import MapConfig as JMapConfig
from vieo_slam_tpu.map.map_state import MapState as JMapState
from vieo_slam_tpu.viz import viewer as jviewer
from vieo_slam_tpu_torch.io.png import read_png, write_png
from vieo_slam_tpu_torch.map.map_state import MapConfig, MapState
from vieo_slam_tpu_torch.viz import viewer as tviewer
from vieo_slam_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [0.1, 0.15])
def test_frustum_matches_jax(seed, scale):
    rng = np.random.RandomState(seed)
    R, t = _rot(rng), rng.randn(3).astype(np.float32)
    got, e_got = tviewer.MapDrawer()._frustum(R, t, scale)
    want, e_want = jviewer.MapDrawer()._frustum(R, t, scale)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert e_got == e_want


def _grow(m, i, rng):
    """Keyframe i at a pose on a circle, with 12 landmarks."""
    N = 16
    a = 0.3 * i
    Rcw = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                    [np.sin(a), 0, np.cos(a)]], np.float32)
    m.add_keyframe(
        Rcw=Rcw, tcw=np.asarray([0.1 * i, 0.02 * i, 0], np.float32),
        timestamp=0.1 * i, frame_id=i,
        uv=rng.rand(N, 2).astype(np.float32) * 64,
        level=np.zeros(N, np.int32), desc=np.zeros((N, 8), np.uint32),
        ur=np.full(N, -1.0, np.float32), depth=np.full(N, -1.0, np.float32),
        kp_valid=np.ones(N, bool), lm_idx=np.full(N, -1, np.int32))
    m.add_landmarks(rng.randn(12, 3).astype(np.float32) * 2 + [0, 0, 4],
                    np.zeros((12, 8), np.uint32), first_kf=i)


class _Stub:
    """What poll reads of a System: its map and its tracker's pose and
    trajectory."""

    def __init__(self, m, n):
        self.map = m

        class tracker:
            trajectory = [(0.1 * j, np.eye(3, dtype=np.float32),
                           np.asarray([0.1 * j, 0, 0], np.float32), "OK")
                          for j in range(n)]
            Rcw = np.eye(3, dtype=np.float32)
            tcw = np.asarray([0.1 * n, 0, 0], np.float32)

        self.tracker = tracker


def test_poll_cadence_and_files_match_jax(tmp_path):
    cfg = dict(max_keyframes=16, max_landmarks=256, max_kp=16)
    mt, mj = MapState(MapConfig(**cfg)), JMapState(JMapConfig(**cfg))
    vt = Viewer(str(tmp_path / "port"), every_n_kf=3)
    vj = jviewer.Viewer(str(tmp_path / "jax"), every_n_kf=3)
    got, want, titles = [], [], {}
    for i in range(10):
        # a poll without a new keyframe, then one after it
        for grow in (False, True):
            if grow:
                _grow(mt, i, np.random.RandomState(i))
                _grow(mj, i, np.random.RandomState(i))
            pt, pj = vt.poll(_Stub(mt, i + 1)), vj.poll(_Stub(mj, i + 1))
            got.append(None if pt is None else os.path.basename(pt))
            want.append(None if pj is None else os.path.basename(pj))
            if pj is not None:      # the title JAX draws into its figure
                titles[got[-1]] = (f"{mj.n_keyframes()} KFs / "
                                   f"{int(np.sum(mj.lm_valid))} points")
    assert got == want
    assert [x for x in got if x] == ["map_00003.png", "map_00006.png",
                                     "map_00009.png"]
    for name in filter(None, got):
        pix, text = read_png(str(tmp_path / "port" / name))
        assert pix.shape == tviewer.MAP_SIZE + (3,) and pix.dtype == np.uint8
        assert (pix != 255).any()                       # drawn, not blank
        assert text["Title"] == titles[name]
        # the frusta in blue, the trajectory in green, the camera in red
        for color in ((0, 0, 255), (0, 128, 0), (255, 0, 0), (0, 0, 0)):
            assert (pix == color).all(axis=-1).any(), color


def test_map_drawer_without_title_or_landmarks(tmp_path):
    m = MapState(MapConfig(max_keyframes=4, max_landmarks=8, max_kp=16))
    _grow(m, 0, np.random.RandomState(0))
    m.lm_valid[:] = False
    p = MapDrawer().draw(m, str(tmp_path / "m.png"))
    pix, text = read_png(p)
    assert text == {} and (pix == (0, 0, 255)).all(axis=-1).any()
    # an empty map draws an empty canvas
    empty = MapState(MapConfig(max_keyframes=4, max_landmarks=8, max_kp=16))
    pix, _ = read_png(MapDrawer().draw(empty, str(tmp_path / "e.png")))
    assert (pix == 255).all()


@pytest.mark.parametrize("color_image", [False, True])
def test_frame_drawer(tmp_path, color_image):
    rng = np.random.RandomState(1)
    img = rng.rand(48, 64).astype(np.float32) * 200
    if color_image:
        img = np.stack([img, img * 0.5, img * 0.25], -1)
    uv = rng.rand(30, 2).astype(np.float32) * [64, 48]
    tracked = np.arange(30) % 2 == 0
    p = FrameDrawer().draw(str(tmp_path / "f.png"), img, uv,
                           tracked_mask=tracked, state="OK", n_tracked=15)
    pix, text = read_png(p)
    assert pix.shape == (48, 64, 3)
    assert text["Title"] == "OK  matches: 15"
    assert (pix == (0, 255, 0)).all(axis=-1).any()          # lime: tracked
    assert (pix == (0, 191, 255)).all(axis=-1).any()        # new keypoints
    # untouched pixels keep the image
    gray = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if gray.ndim == 2:
        gray = np.repeat(gray[..., None], 3, axis=2)
    same = (pix == gray).all(axis=-1)
    assert same.mean() > 0.5
    # the JAX drawer takes the same call
    jviewer.FrameDrawer().draw(str(tmp_path / "j.png"), img, uv,
                               tracked_mask=tracked, state="OK",
                               n_tracked=15)


@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 3)])
def test_png_round_trip(tmp_path, shape):
    a = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    p = write_png(str(tmp_path / "a.png"), a, {"Title": "x y", "k": "v"})
    pix, text = read_png(p)
    np.testing.assert_array_equal(pix, a)
    assert text == {"Title": "x y", "k": "v"}
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), a.astype(np.float32))


def test_viz_imports_no_matplotlib():
    code = ("import sys; import vieo_slam_tpu_torch.viz; "
            "import vieo_slam_tpu_torch.examples.run_synthetic; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
