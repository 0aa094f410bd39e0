"""EuRoC MAV / TUM-VI dataset loaders (ASL folder layout).

Port of vieo_slam_tpu/io/euroc.py (numpy, copied): timestamped stereo
image paths, IMU samples and ground truth from the mav0/{cam0, cam1,
imu0, state_groundtruth_estimate0} layout, and the IMU window between two
frames.  Images are read by `load_image_gray`, a PNG decoder on numpy and
zlib (no OpenCV) for the grayscale PNGs of these datasets: 8- and 16-bit
gray, non-interlaced; 16-bit samples keep their high byte, as
cv2.imread(IMREAD_GRAYSCALE) does.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np


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


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:
            cur = (line + prev) % 256
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) % 256
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = cur
        prev = cur
    return out


def load_image_gray(path: str) -> np.ndarray:
    """One grayscale PNG as float32 [H, W] (decoded with numpy and zlib);
    raises ValueError for any other PNG (color, palette, interlaced)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype != 0 or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG color type {ctype}, bit depth "
                         f"{depth}, interlace {interlace} not supported")
    bpp = depth // 8
    pix = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8),
                    h, w * bpp, bpp)
    if depth == 16:
        pix = pix.reshape(h, w, 2)[..., 0]           # the high byte
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
