"""The port's I/O against the JAX package's: the OpenCV-YAML settings
(the port's own reader against cv2.FileStorage) and build_system; maps,
trajectories and DBoW2 vocabularies written by one package and read by
the other; EuRoC folders and PNG images; the dense-map export; the native
odometry ring; and a feature-level map-reuse run (save, load into a fresh
System, relocalize, localization mode) through both packages.

Tolerances:
- settings, maps, vocabularies, EuRoC arrays and PNG pixels: equal;
- trajectory files: equal byte for byte, but for quaternion fields,
  which may differ by one unit in the 7th decimal (XLA's f32 square root
  on the CPU is not correctly rounded);
- the dense export: back-projected clouds within 1e-5 m (f32 on both
  sides), the voxel and outlier filters equal on the same points;
- the native ring: windows equal to the numpy ring's;
- map reuse: identical track states and keyframe counts; per-frame poses
  within 2e-3 m and 2e-3 rad before the save (test_torch_system.py's
  bound), and within 5e-3 m / 5e-3 rad after the relocalization (each
  package draws its own RANSAC samples, then both refine to the same
  inliers).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from vieo_slam_tpu.backend.loop_closing import LoopCloser as JLoopCloser
from vieo_slam_tpu.backend.loop_closing import (
    LoopClosingConfig as JLoopClosingConfig)
from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.io import config as jconfig
from vieo_slam_tpu.io import dense_map as jdense
from vieo_slam_tpu.io import euroc as jeuroc
from vieo_slam_tpu.io import serialization as jser
from vieo_slam_tpu.loop import vocabulary as jvoc
from vieo_slam_tpu.map.map_state import MapConfig as JMapConfig
from vieo_slam_tpu.map.map_state import MapState as JMapState
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu.native import OdomRing as JOdomRing
from vieo_slam_tpu.sim import world as jworld
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.backend.loop_closing import (LoopCloser,
                                                      LoopClosingConfig)
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.io import config as tconfig
from vieo_slam_tpu_torch.io import dense_map as tdense
from vieo_slam_tpu_torch.io import euroc as teuroc
from vieo_slam_tpu_torch.io import serialization as tser
from vieo_slam_tpu_torch.io.odom_ring import NativeOdomRing, OdomRing
from vieo_slam_tpu_torch.loop import vocabulary as tvoc
from vieo_slam_tpu_torch.math import lie as tlie
from vieo_slam_tpu_torch.system import System, SystemConfig, TrackState

from test_torch_system import rot_angle

torch.set_num_threads(1)

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)
BF = 400.0 * 0.2

# test_io.py's settings file.
EUROC_YAML = (
    "%YAML:1.0\n"
    "Camera.fx: 435.2\nCamera.fy: 435.2\n"
    "Camera.cx: 367.4\nCamera.cy: 252.2\n"
    "Camera.k1: -0.28\nCamera.k2: 0.07\n"
    "Camera.p1: 0.0002\nCamera.p2: 0.00002\n"
    "Camera.width: 752\nCamera.height: 480\n"
    "Camera.bf: 47.9\nCamera.fps: 20.0\n"
    "ORBextractor.nFeatures: 375\n"
    "ORBextractor.scaleFactor: 1.2\n"
    "ORBextractor.nLevels: 8\n"
    "ORBextractor.iniThFAST: 20\n"
    "ORBextractor.minThFAST: 7\n"
    "LocalMapping.LocalWindowSize: 10\n"
    "GBA.NoLoopClosing: 1\n"
    "IMU.sigma_g: 0.00017\nIMU.sigma_a: 0.002\n")

# A TUM-VI-style KB8 stereo file (TUM_VI_512_VIO_dist_fast.yaml's keys):
# comments, quoted strings, a 3x4 Camera2.Trc, 4x4 Tbc / Tce matrices, a
# plain list spread over two lines.
TUMVI_YAML = """%YAML:1.0

#--------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------
Camera.type: "KannalaBrandt8"   # fisheye

Camera.fx: 190.978477
Camera.fy: 190.973307
Camera.cx: 254.931706
Camera.cy: 256.897442

Camera.k1: 0.003482389402
Camera.k2: 0.000715034845
Camera.k3: -0.002053236141
Camera.k4: 0.000202936736

Camera2.fx: 190.442369
Camera2.fy: 190.434438
Camera2.cx: 252.597939
Camera2.cy: 254.917068
Camera2.k1: 0.003400800216
Camera2.k2: 0.001766757061
Camera2.k3: -0.002692827684
Camera2.k4: 0.000256027454

Camera2.Trc: !!opencv-matrix
  rows: 3
  cols: 4
  dt: f
  data: [0.999997256477881, 0.002312067192424, 0.000376008102917, -0.101077981,
         -0.002317135723281, 0.999898048506644, 0.014089835846648, 0.001997187,
         -0.000343393120525, -0.014090668452714, 0.999900662637729, 0.001002183]

Camera.width: 512
Camera.height: 512
Camera.fps: 20.0
Camera.bf: 19.3079
Camera.RGB: 1
ThDepth: 40.0

Camera.Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [-0.9995250, 0.0304113, -0.0057389, 0.0475655,
          0.0075192, 0.0589212, -0.9982355, -0.0474012,
          -0.0295259, -0.9978049, -0.0591215, -0.0475377,
          0.0, 0.0, 0.0, 1.0]

Camera.Tce: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0, 0.0, 1.0, 0.1, -1.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0, -0.2,
          0.0, 0.0, 0.0, 1.0]

IMU.sigma: [0.00016, 0.0028,
            0.000022, 0.00086]
IMU.freq_hz: 200
Encoder.rc: 0.31
Encoder.scale: 1.0

ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

LocalMapping.LocalWindowSize: 12
GBA.finalIterations: 10
IMU.FinalTime: 12.5
"""


def _settings_equal(a, b):
    import dataclasses
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]),
                                              err_msg=f"{f.name}.{k}")
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y and type(x) is type(y), (f.name, x, y)


@pytest.mark.parametrize("text", [EUROC_YAML, TUMVI_YAML],
                         ids=["euroc_radtan", "tumvi_kb8"])
def test_settings_match_cv2_reader(tmp_path, text):
    path = str(tmp_path / "s.yaml")
    with open(path, "w") as f:
        f.write(text)
    got, want = tconfig.load_settings(path), jconfig.load_settings(path)
    _settings_equal(got, want)
    _settings_equal(convert.slam_settings_from_jax(want), got)
    if text is TUMVI_YAML:
        assert got.model == "kb8" and got.cam2 is not None
        assert got.Tbc.dtype == np.float32 and got.Tbe[0, 3] == np.float32(0.1)
        assert got.imu_sigma_ba == 0.00086 and got.local_window_size == 12
        rig = tconfig.rig_cameras(got)
        assert [c.kind for c in rig] == [tcm.KB8, tcm.KB8]
        np.testing.assert_array_equal(rig[1].tcr, got.cam2["Trc"][:3, 3])


def test_yaml_reader_rejects_malformed(tmp_path):
    path = str(tmp_path / "bad.yaml")
    with open(path, "w") as f:
        f.write("%YAML:1.0\nM: !!opencv-matrix\n  rows: 2\n  cols: 2\n"
                "  dt: f\n  data: [1, 2, 3]\n")
    with pytest.raises(ValueError, match="2x2"):
        tconfig.read_opencv_yaml(path)


def test_build_system_and_frame_builders(tmp_path):
    s = tconfig.SlamSettings(n_features=128)
    sys_ = tconfig.build_system(s, "stereo", device="cpu")
    assert sys_.map.cfg.max_kp == 128 and sys_.loop_closer is not None
    assert sys_.device.type == "cpu"
    s2 = tconfig.SlamSettings(gba_no_loop_closing=True)
    assert tconfig.build_system(s2, "stereo", device="cpu").loop_closer \
        is None
    # the distorted two-camera rig of the TUM-VI file: a multicam builder
    path = str(tmp_path / "s.yaml")
    with open(path, "w") as f:
        f.write(TUMVI_YAML)
    st = tconfig.load_settings(path)
    st.n_features, st.n_levels = 150, 2
    sys3 = tconfig.build_system(st, "stereo", device="cpu")
    jsys = jconfig.build_system(jconfig.load_settings(path), "stereo")
    assert sys3.cfg.tracker.th_depth == pytest.approx(
        jsys.cfg.tracker.th_depth)
    assert sys3.cfg.mapper.window_size == jsys.cfg.mapper.window_size == 12
    img = np.random.RandomState(0).rand(512, 512).astype(np.float32) * 255
    fr = sys3.frame_builder(img, img, 0.25)
    assert fr.uv.shape[0] == 150 and fr.timestamp == 0.25
    mono = tconfig.make_frame_builder(
        tconfig.SlamSettings(model="kb8", dist=(0.01, 0, 0, 0),
                             n_features=100, n_levels=2), device="cpu")
    assert mono(img[:480], 0.5).depth.max() < 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tconfig.build_system(s)


def small_map(jax_side: bool):
    """test_io.py's map, built by either package's MapState."""
    from vieo_slam_tpu_torch.map.map_state import MapConfig, MapState
    cls, cfg = (JMapState, JMapConfig) if jax_side else (MapState, MapConfig)
    m = cls(cfg(max_keyframes=8, max_landmarks=64, max_kp=16))
    rng = np.random.RandomState(0)
    for k in range(3):
        m.add_keyframe(
            Rcw=np.eye(3, dtype=np.float32),
            tcw=rng.randn(3).astype(np.float32),
            timestamp=0.1 * k, frame_id=k,
            uv=rng.rand(16, 2).astype(np.float32) * 100,
            level=np.zeros(16, np.int32),
            desc=rng.randint(0, 2 ** 32, (16, 8), np.uint64).astype(
                np.uint32),
            ur=np.full(16, -1.0, np.float32),
            depth=np.full(16, 2.0, np.float32),
            kp_valid=np.ones(16, bool),
            lm_idx=np.full(16, -1, np.int32))
    m.add_landmarks(rng.randn(10, 3).astype(np.float32),
                    rng.randint(0, 2 ** 32, (10, 8), np.uint64).astype(
                        np.uint32), first_kf=0)
    m.kf_Rwb[1] = tlie.rotmat_from_quat(torch.tensor(
        [0.9, 0.1, -0.3, 0.2]) / np.sqrt(0.95)).numpy()
    m.kf_vwb[2] = [0.5, -0.25, 0.125]
    return m


def _maps_equal(a, b):
    for f in tser._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("version", "big_change_idx", "_next_kf", "_next_lm"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.cfg.max_kp == b.cfg.max_kp == 16


def test_maps_load_across_packages(tmp_path):
    jm, tm = small_map(True), small_map(False)
    assert list(tser._ARRAY_FIELDS) == list(jser._ARRAY_FIELDS)
    jser.save_map(jm, str(tmp_path / "j.npz"))
    tser.save_map(tm, str(tmp_path / "t.npz"))
    _maps_equal(tser.load_map(str(tmp_path / "j.npz")), tm)
    _maps_equal(jser.load_map(str(tmp_path / "t.npz")), jm)
    _maps_equal(tser.load_map(str(tmp_path / "t.npz")), tm)
    assert not os.path.exists(str(tmp_path / "t.npz.tmp"))


def test_trajectory_files_equal(tmp_path):
    """KITTI files equal byte for byte.  TUM and NavState files equal byte
    for byte but for the quaternion fields, which may differ by one unit
    in their 7th decimal: XLA's f32 square root on the CPU is not
    correctly rounded, so about one quaternion in eight differs from
    torch's in its last bit."""
    rng = np.random.RandomState(1)
    traj = []
    for i in range(40):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = tlie.rotmat_from_quat(torch.from_numpy(q)).numpy().astype(
            np.float32)
        traj.append((0.1 * i + 1e9 * (i == 5), R,
                     rng.randn(3).astype(np.float32), "OK"))
    m = small_map(False)
    n_quat_diff = 0
    for name, tw, jw, arg, quat in (
            ("tum", tser.write_trajectory_tum, jser.write_trajectory_tum,
             traj, slice(4, 8)),
            ("kitti", tser.write_trajectory_kitti,
             jser.write_trajectory_kitti, traj, slice(0, 0)),
            ("navstate", tser.write_trajectory_navstate,
             jser.write_trajectory_navstate, m, slice(4, 8))):
        tw(str(tmp_path / f"t_{name}.txt"), arg)
        jw(str(tmp_path / f"j_{name}.txt"), arg)
        a = (tmp_path / f"t_{name}.txt").read_bytes()
        b = (tmp_path / f"j_{name}.txt").read_bytes()
        assert a.count(b"\n") == b.count(b"\n") == (
            40 if name != "navstate" else 3)
        if name == "kitti":
            assert a == b
        for la, lb in zip(a.decode().splitlines(), b.decode().splitlines()):
            fa, fb = la.split(" "), lb.split(" ")
            assert len(fa) == len(fb)
            rest = [i for i in range(len(fa)) if not quat.start <= i
                    < quat.stop]
            assert [fa[i] for i in rest] == [fb[i] for i in rest], name
            qa = np.asarray(fa[quat], np.float64)
            qb = np.asarray(fb[quat], np.float64)
            np.testing.assert_allclose(qa, qb, rtol=0, atol=1.01e-7)
            n_quat_diff += fa[quat] != fb[quat]
    assert n_quat_diff <= 12


def test_rotmat_from_quat_matches_jax():
    q = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tlie.rotmat_from_quat(torch.from_numpy(q)).numpy(),
        np.asarray(jlie.rotmat_from_quat(jnp.asarray(q))), atol=1e-6)


def _png(path, img, depth=8, filters=(0, 1, 2, 3, 4)):
    """A grayscale PNG with the given row filters in turn."""
    h, w = img.shape
    bpp = depth // 8
    raw = img.astype(">u2").view(np.uint8).reshape(h, w * 2) if depth == 16 \
        else img.astype(np.uint8)
    stride = w * bpp
    rows, prev = [], np.zeros(stride, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = raw[y].astype(np.int32)
        a = np.r_[np.zeros(bpp, np.int32), cur[:-bpp]]
        c = np.r_[np.zeros(bpp, np.int32), prev[:-bpp]]
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - a
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            out = cur - np.where((pa <= pb) & (pa <= pc), a,
                                 np.where(pb <= pc, prev, c))
        rows.append(bytes([f]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0,
                                           0)))
        data = zlib.compress(b"".join(rows))
        f.write(chunk(b"IDAT", data[:len(data) // 2]))
        f.write(chunk(b"IDAT", data[len(data) // 2:]))
        f.write(chunk(b"IEND", b""))


def _euroc(root):
    """test_io.py's EuRoC folder, with images and ground truth."""
    mav = root / "mav0"
    rng = np.random.RandomState(4)
    for c in ["cam0", "cam1"]:
        (mav / c / "data").mkdir(parents=True)
        with open(mav / c / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(4):
                f.write(f"{int(1e9 * (100 + 0.05 * i))},{i}.png\n")
                _png(str(mav / c / "data" / f"{i}.png"),
                     rng.randint(0, 256, (12, 17)))
    (mav / "imu0").mkdir(parents=True)
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(40):
            t = int(1e9 * (100 + 0.005 * i))
            f.write(f"{t},0.1,0.2,{0.3 + 0.01 * i},0.0,0.0,9.81\n")
    gt = mav / "state_groundtruth_estimate0"
    gt.mkdir()
    with open(gt / "data.csv", "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz,vx,vy,vz\n")
        for i in range(8):
            f.write(f"{int(1e9 * (100 + 0.025 * i))},{i},{-i},0.5,1,0,0,0,"
                    "0,0,0\n")


def test_euroc_matches_jax(tmp_path):
    _euroc(tmp_path)
    got, want = teuroc.load_euroc(str(tmp_path)), jeuroc.load_euroc(
        str(tmp_path))
    import dataclasses
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, list):
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    for t0, t1 in ((got.t_cam[0], got.t_cam[1]), (100.012, 100.13),
                   (99.0, 100.02)):
        for a, b in zip(teuroc.imu_window(got, t0, t1, 32),
                        jeuroc.imu_window(want, t0, t1, 32)):
            np.testing.assert_array_equal(a, b)
    for p in got.cam0_paths + got.cam1_paths:
        img = teuroc.load_image_gray(p)
        assert img.dtype == np.float32 and img.shape == (12, 17)
        np.testing.assert_array_equal(img, jeuroc.load_image_gray(p))


def test_png_reader_matches_cv2(tmp_path):
    rng = np.random.RandomState(5)
    img8 = rng.randint(0, 256, (33, 41))
    img16 = rng.randint(0, 65536, (9, 14))
    p8, p16 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    _png(p8, img8, filters=(4, 3, 2, 1, 0, 4, 4))
    _png(p16, img16, depth=16)
    for p in (p8, p16):
        want = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        np.testing.assert_array_equal(teuroc.load_image_gray(p), want)
    np.testing.assert_array_equal(teuroc.load_image_gray(p8), img8)
    with open(str(tmp_path / "c.png"), "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="PNG"):
        teuroc.load_image_gray(str(tmp_path / "c.png"))


def test_dense_export_matches_jax(tmp_path):
    """test_dense_map.py's planes and a tilted, noisy one through both
    exports; then the PCD files each package wrote."""
    m = small_map(False)
    m.kf_Rcw[2] = tlie.rotmat_from_quat(torch.tensor(
        [0.98, 0.1, -0.1, 0.1]) / np.sqrt(0.9904)).numpy()
    cam_t = tcm.make_pinhole(100.0, 100.0, 32.0, 24.0, 64, 48)
    cam_j = jcm.make_pinhole(100.0, 100.0, 32.0, 24.0, 64, 48)
    rng = np.random.RandomState(2)
    tdm = tdense.DenseMapper(max_depth=7.0, stride=1, leaf=0.05,
                             device="cpu")
    jdm = jdense.DenseMapper(max_depth=7.0, stride=1, leaf=0.05)
    for k in range(3):
        depth = np.full((48, 64), 2.0 + k, np.float32)
        depth += rng.randn(48, 64).astype(np.float32) * 0.05
        depth[::7, ::5] = 9.0                          # beyond max_depth
        color = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        tdm.add_keyframe(k, color, depth)
        jdm.add_keyframe(k, color, depth)
    # the back-projection alone (before the filters)
    Rwc = m.kf_Rcw[2].T
    twc = -Rwc @ m.kf_tcw[2]
    d = tdm.frames[2][1]
    pw_t, ok_t = tdense._backproject(torch.from_numpy(d), 100.0, 100.0,
                                     32.0, 24.0, torch.from_numpy(Rwc),
                                     torch.from_numpy(twc))
    pw_j, ok_j = jdense._backproject(jnp.asarray(d), 100.0, 100.0, 32.0,
                                     24.0, jnp.asarray(Rwc),
                                     jnp.asarray(twc))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), atol=1e-5)
    # the filters on the same points
    pts = pw_t.numpy()[ok_t.numpy()]
    cols = rng.randint(0, 256, (len(pts), 3)).astype(np.uint8)
    for a, b in zip(tdense.voxel_downsample(pts, cols, 0.05),
                    jdense.voxel_downsample(pts, cols, 0.05)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tdense.statistical_outlier_removal(pts, k=20),
        jdense.statistical_outlier_removal(pts, k=20))
    # the whole export, and each package reading the other's file
    n_t = tdm.save(m, cam_t, str(tmp_path / "t.pcd"))
    n_j = jdm.save(m, cam_j, str(tmp_path / "j.pcd"))
    assert n_t > 100 and abs(n_t - n_j) <= 2
    pt, ct = tdense.load_pcd(str(tmp_path / "j.pcd"))
    pj, cj = jdense.load_pcd(str(tmp_path / "t.pcd"))
    assert len(pt) == n_j and len(pj) == n_t
    pt2, ct2 = tdense.load_pcd(str(tmp_path / "t.pcd"))
    np.testing.assert_array_equal(pt2, pj)
    np.testing.assert_array_equal(ct2, cj)


def _random_tree(rng, k, L):
    """test_gauge_and_vocab.py's incomplete DBoW2 tree rows."""
    rows, next_id, frontier = [], 1, []
    for _ in range(3):
        rows.append((0, 0, rng.randint(0, 256, 32), 0.0))
        frontier.append((next_id, 1))
        next_id += 1
    while frontier:
        pid, lv = frontier.pop(0)
        if lv == L:
            continue
        for _ in range(rng.randint(2, k + 1)):
            is_leaf = int(lv + 1 == L)
            w = round(float(rng.rand() + 0.1), 4) if is_leaf else 0.0
            rows.append((pid, is_leaf, rng.randint(0, 256, 32), w))
            if not is_leaf:
                frontier.append((next_id, lv + 1))
            next_id += 1
    return rows


def _vocs_equal(a, b):
    assert (a.k, a.L) == (b.k, b.L)
    np.testing.assert_array_equal(np.asarray(a.node_desc),
                                  np.asarray(b.node_desc))
    np.testing.assert_array_equal(np.asarray(a.idf), np.asarray(b.idf))


def test_dbow_files_across_packages(tmp_path):
    desc = np.random.RandomState(3).randint(0, 2 ** 32, (400, 8),
                                            np.uint64).astype(np.uint32)
    jv = jvoc.train_vocabulary(desc, k=3, L=3, seed=0, iters=3)
    tv = tvoc.train_vocabulary(desc, k=3, L=3, seed=0, iters=3)
    _vocs_equal(tv, jv)
    for ext, jsave, tsave in ((".txt", jvoc.save_dbow_text,
                               tvoc.save_dbow_text),
                              (".bin", jvoc.save_dbow_binary,
                               tvoc.save_dbow_binary)):
        jp, tp = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
        jsave(jv, jp)
        tsave(tv, tp)
        assert open(jp, "rb").read() == open(tp, "rb").read(), ext
        _vocs_equal(tvoc.load_vocabulary(jp), jvoc.load_vocabulary(tp))
        _vocs_equal(tvoc.load_vocabulary(tp), tv)
    # an incomplete tree (ORBvoc's padded branches), text and binary
    rows = _random_tree(np.random.RandomState(11), 4, 3)
    tpath, bpath = str(tmp_path / "voc.txt"), str(tmp_path / "voc.bin")
    with open(tpath, "w") as f:
        f.write("4 3 0 0\n")
        for pid, leaf, d, w in rows:
            f.write(f"{pid} {leaf} " + " ".join(map(str, d)) + f" {w}\n")
    with open(bpath, "wb") as f:
        f.write(struct.pack("<IIiiii", len(rows) + 1, 41, 4, 3, 0, 0))
        for pid, leaf, d, w in rows:
            f.write(struct.pack("<i", pid) + bytes(d.tolist())
                    + struct.pack("<f", w) + struct.pack("<?", bool(leaf)))
    for p in (tpath, bpath):
        _vocs_equal(tvoc.load_vocabulary(p), jvoc.load_vocabulary(p))
    with open(str(tmp_path / "bad.bin"), "wb") as f:
        f.write(struct.pack("<IIiiii", 5, 40, 4, 3, 0, 0))
    with pytest.raises(ValueError, match="DBoW2"):
        tvoc.load_dbow_binary(str(tmp_path / "bad.bin"))


def _fill(ring, n=100, dt=0.005, t0=10.0):
    ts = t0 + np.arange(n) * dt
    vs = np.stack([np.full(n, i * 0.1, np.float32) for i in range(6)], -1)
    vs[:, 0] = np.arange(n)
    ring.push_bulk(ts, vs)
    return ts, vs


def _windows_equal(a, b, t0, t1, cap):
    x, y = a.window(t0, t1, cap), b.window(t0, t1, cap)
    assert x[3] == y[3]
    for u, v in zip(x[:3], y[:3]):
        assert u.dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(u, v)
    x = a.window_filled(t0, t1, cap, tail_tol=0.01)
    y = b.window_filled(t0, t1, cap, tail_tol=0.01)
    assert x[3:] == y[3:]
    for u, v in zip(x[:3], y[:3]):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("cap,n", [(512, 80), (64, 200)],
                         ids=["fits", "wraps"])
def test_native_ring_matches_numpy_ring(cap, n):
    """test_native.py's cases: the port's C++ ring (built from its own
    copy of the source) against its numpy ring and the JAX package's
    native ring."""
    rn, rp, rj = NativeOdomRing(cap), OdomRing(cap), JOdomRing(cap)
    assert rn.native and not rp.native
    for r in (rn, rp, rj):
        assert r.latest_time() == -1.0 and r.size() == 0
        ts, _ = _fill(r, n)
    assert rn.size() == rp.size() == min(n, cap)
    assert rn.latest_time() == rp.latest_time() == ts[-1]
    for t0, t1 in ((10.01, 10.12), (10.0, 10.4), (10.37, 10.5),
                   (ts[5] + 0.001, ts[6] - 0.001), (ts[0], ts[-1]),
                   (ts[-1] - 0.02, ts[-1] + 0.05)):
        _windows_equal(rn, rp, t0, t1, 32)
        _windows_equal(rn, rj, t0, t1, 32)
    rn.push(ts[-1] + 0.005, np.arange(6))
    rp.push(ts[-1] + 0.005, np.arange(6))
    _windows_equal(rn, rp, ts[-3], ts[-1] + 0.01, 16)
    assert rn.wait_until(ts[-1], 0.0) and not rn.wait_until(ts[-1] + 1, 0.0)


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_native_ring_build_failure_raises(monkeypatch, tmp_path, fault):
    """A ring that cannot be built raises; nothing falls back to numpy."""
    from vieo_slam_tpu_torch.io import odom_ring
    monkeypatch.setattr(odom_ring, "_native", None)
    monkeypatch.setattr(odom_ring, "BUILD_DIR", tmp_path)
    if fault == "no_compiler":
        monkeypatch.setattr(odom_ring.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    else:
        bad = tmp_path / "bad.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(odom_ring, "_NATIVE_SRC", bad)
        match = "g\\+\\+ failed"
    with pytest.raises(RuntimeError, match=match):
        NativeOdomRing(16)


# ---------------------------------------------------------------------------
# Map reuse (test_map_reuse.py's scenario, cut to fit)
# ---------------------------------------------------------------------------

REUSE_N = 24
REUSE_AT = (12, 13, 14)


@pytest.fixture(scope="module")
def reuse(tmp_path_factory):
    world = jworld.SyntheticWorld(jworld.WorldConfig(
        n_landmarks=4000, seed=3, extent=(6.0, 4.5, 3.0)))
    ts = np.arange(REUSE_N) * 0.1
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.25,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    rng = np.random.RandomState(11)
    cam = jcm.make_pinhole(*CAM)

    def observe(i):
        return world.observe(Rcw[i], tcw[i], cam, bf=BF, n_kp=500,
                             pixel_noise=0.25, bit_flips=4, clutter=50,
                             rng=rng, max_depth=10.0)

    first = [observe(i) for i in range(REUSE_N)]
    again = [observe(i) for i in REUSE_AT]            # fresh noise
    d = tmp_path_factory.mktemp("reuse")
    out = dict(ts=ts, again=again, dir=d)
    for side in ("jax", "port"):
        s, maker, kw = _reuse_system(side)
        states = [s.track_frame(_frame(maker, o, ts[i], kw)).name
                  for i, o in enumerate(first)]
        s.save_map(str(d / f"{side}.npz"))
        out[side] = dict(system=s, states=states)
    return out


def _reuse_system(side):
    if side == "jax":
        cam = jcm.make_pinhole(*CAM)
        s = JSystem(cam, BF, JSystemConfig())
        s.loop_closer = JLoopCloser(cam, BF, s.map, JLoopClosingConfig())
        return s, jframe.make_frame_from_features, {}
    cam = tcm.make_pinhole(*CAM)
    s = System(cam, BF, SystemConfig(), device="cpu")
    s.loop_closer = LoopCloser(cam, BF, s.map, LoopClosingConfig(),
                               device="cpu")
    return s, tframe.make_frame_from_features, {"device": "cpu"}


def _frame(maker, o, t, kw):
    return maker(o["uv"], o["level"], o["angle"], o["desc"], o["valid"],
                 ur=o["ur"], depth=o["depth"], timestamp=float(t), **kw)


def test_map_reuse_first_run_matches_jax(reuse):
    js, ps = reuse["jax"]["system"], reuse["port"]["system"]
    assert reuse["jax"]["states"] == reuse["port"]["states"]
    assert "LOST" not in reuse["port"]["states"]
    assert js.map.n_keyframes() == ps.map.n_keyframes() >= 5
    for i, (a, b) in enumerate(zip(js.tracker.trajectory,
                                   ps.tracker.trajectory)):
        assert np.abs(np.asarray(a[2]) - b[2]).max() < 2e-3, i
        assert rot_angle(np.asarray(a[1]), b[1]) < 2e-3, i


def test_map_reuse_relocalizes_in_localization_mode(reuse):
    """Both packages load the map the JAX run saved into a fresh System
    in localization mode: LOST until a relocalization against it, then
    tracking without a new keyframe; the port also from its own map."""
    d, ts = reuse["dir"], reuse["ts"]
    poses = {}
    for side, path in (("jax", "jax"), ("port", "jax"), ("port2", "port")):
        s, maker, kw = _reuse_system("jax" if side == "jax" else "port")
        s.load_map(str(d / f"{path}.npz"))
        s.set_localization_mode(True)
        assert s.cfg.localization_only
        assert s.tracker.state.name == "LOST"
        assert s.tracker.last_kf_id == int(s.map.keyframe_ids()[-1])
        n_kf = s.map.n_keyframes()
        lm_pw = np.array(s.map.lm_pw)
        states, poses[side] = [], []
        for i, o in zip(REUSE_AT, reuse["again"]):
            states.append(s.track_frame(_frame(maker, o, ts[i], kw)).name)
            # the tracker's pose after the frame (its trajectory holds the
            # LOST entry it made before the System relocalized the frame)
            poses[side].append((np.asarray(s.tracker.Rcw),
                                np.asarray(s.tracker.tcw)))
        assert states[0] == "OK" and "LOST" not in states, (side, states)
        assert s.map.n_keyframes() == n_kf          # the map stays frozen
        np.testing.assert_array_equal(s.map.lm_pw, lm_pw)
        if side == "port":
            assert s.loop_closer.db is not None
            assert isinstance(s.tracker.state, TrackState)
    first = reuse["jax"]["system"].tracker.trajectory
    for (Rj, tj), (Rt, tt), (Rt2, tt2), i in zip(
            poses["jax"], poses["port"], poses["port2"], REUSE_AT):
        assert np.abs(tj - tt).max() < 5e-3, i
        assert rot_angle(Rj, Rt) < 5e-3, i
        # where the first run put the camera at this frame, in the map
        p0 = -np.asarray(first[i][1]).T @ np.asarray(first[i][2])
        assert np.linalg.norm(-Rt2.T @ tt2 - p0) < 0.05, i
