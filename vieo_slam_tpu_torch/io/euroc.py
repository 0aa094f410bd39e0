"""EuRoC MAV / TUM-VI dataset loaders (ASL folder layout).

Port of vieo_slam_tpu/io/euroc.py (numpy, copied): timestamped stereo
image paths, IMU samples and ground truth from the mav0/{cam0, cam1,
imu0, state_groundtruth_estimate0} layout, and the IMU window between two
frames.  Images are read by `load_image_gray` through `io/png.read_png` (numpy
and zlib, no OpenCV) for the grayscale PNGs of these datasets: 8- and
16-bit gray, non-interlaced; 16-bit samples keep their high byte, as
cv2.imread(IMREAD_GRAYSCALE) does.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .png import read_png


@dataclasses.dataclass
class EurocSequence:
    t_cam: np.ndarray          # [T] seconds (float64)
    cam0_paths: list
    cam1_paths: list
    t_imu: np.ndarray          # [M] seconds
    gyro: np.ndarray           # [M, 3]
    acc: np.ndarray            # [M, 3]
    t_gt: np.ndarray           # [G] seconds
    p_gt: np.ndarray           # [G, 3]
    q_gt: np.ndarray           # [G, 4] (w, x, y, z)


def _read_csv(path, cols, skip_header=True):
    data = []
    with open(path) as f:
        for line in f:
            if skip_header and (line.startswith("#") or not line.strip()):
                continue
            parts = line.strip().split(",")
            data.append([float(x) for x in parts[:cols]])
    return np.asarray(data, np.float64)


def load_euroc(root: str) -> EurocSequence:
    """Load a EuRoC sequence directory (the folder containing mav0/)."""
    mav = os.path.join(root, "mav0") if os.path.isdir(
        os.path.join(root, "mav0")) else root

    cam0 = _read_csv(os.path.join(mav, "cam0", "data.csv"), 1)
    t_cam = cam0[:, 0] * 1e-9
    names = []
    with open(os.path.join(mav, "cam0", "data.csv")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            names.append(line.strip().split(",")[1])
    cam0_paths = [os.path.join(mav, "cam0", "data", n) for n in names]
    cam1_paths = [os.path.join(mav, "cam1", "data", n) for n in names]

    imu = _read_csv(os.path.join(mav, "imu0", "data.csv"), 7)
    t_imu = imu[:, 0] * 1e-9
    gyro = imu[:, 1:4]
    acc = imu[:, 4:7]

    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    if os.path.isdir(gt_dir):
        gt = _read_csv(os.path.join(gt_dir, "data.csv"), 8)
        t_gt = gt[:, 0] * 1e-9
        p_gt = gt[:, 1:4]
        q_gt = gt[:, 4:8]
    else:
        t_gt = np.zeros(0)
        p_gt = np.zeros((0, 3))
        q_gt = np.zeros((0, 4))

    return EurocSequence(
        t_cam=t_cam, cam0_paths=cam0_paths, cam1_paths=cam1_paths,
        t_imu=t_imu, gyro=gyro.astype(np.float32),
        acc=acc.astype(np.float32), t_gt=t_gt, p_gt=p_gt, q_gt=q_gt,
    )


def load_image_gray(path: str) -> np.ndarray:
    """One grayscale PNG as float32 [H, W] (decoded by `io/png.read_png`
    with numpy and zlib); raises ValueError for any other PNG (color,
    palette, interlaced)."""
    pix, _ = read_png(path)
    if pix.ndim != 2:
        raise ValueError(f"{path}: a color PNG, expected grayscale")
    if pix.dtype == np.uint16:
        pix = pix >> 8                                # the high byte
    return pix.astype(np.float32)


def imu_window(seq: EurocSequence, t0: float, t1: float, capacity: int):
    """Padded IMU window covering (t0, t1] with boundary sample inclusion
    (the reference interpolates boundary samples, OdomPreIntegrator
    midpoint handling)."""
    i0 = np.searchsorted(seq.t_imu, t0, side="right")
    i1 = np.searchsorted(seq.t_imu, t1, side="right")
    i0 = max(i0 - 1, 0)
    sel = slice(i0, min(i1 + 1, len(seq.t_imu)))
    t = seq.t_imu[sel]
    g = seq.gyro[sel]
    a = seq.acc[sel]
    n = len(t)
    dts = np.zeros(capacity, np.float32)
    gyro = np.zeros((capacity, 3), np.float32)
    acc = np.zeros((capacity, 3), np.float32)
    mask = np.zeros(capacity, bool)
    if n >= 2:
        # integration intervals clipped to (t0, t1)
        tt = np.clip(t, t0, t1)
        d = np.diff(tt)
        m = min(n - 1, capacity)
        dts[:m] = d[:m]
        gyro[:m] = g[:m]
        acc[:m] = a[:m]
        mask[:m] = dts[:m] > 0
    return gyro, acc, dts, mask
