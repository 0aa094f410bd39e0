"""Dense RGB-D map export (the reference's PCL map saver).

Port of vieo_slam_tpu/io/dense_map.py: every 2nd keyframe's color and
depth images are back-projected into a world XYZRGB cloud with the
keyframes' current (post-BA, post-loop) poses, voxel-downsampled at 5 cm,
cleaned of statistical outliers (k = 50 mean neighbour distance, 1
sigma) and written as a binary .pcd.  The back-projection is tensor
operations on the device; the voxel group-by (numpy) and the outlier
filter (scipy's cKDTree) stay on the host.  Images are registered per
keyframe (`add_keyframe`), so the map itself holds no image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _backproject(depth: torch.Tensor, fx, fy, cx, cy, Rwc: torch.Tensor,
                 twc: torch.Tensor, max_depth: float = 7.0):
    """[H, W] depth -> [H * W, 3] world points and their validity."""
    H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, device=depth.device),
                          torch.arange(W, device=depth.device),
                          indexing="ij")
    z = depth.reshape(-1)
    u = u.reshape(-1).to(z.dtype)
    v = v.reshape(-1).to(z.dtype)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pw = torch.stack([x, y, z], -1) @ Rwc.T + twc
    return pw, (z > 0) & (z <= max_depth)


def voxel_downsample(points: np.ndarray, colors: np.ndarray,
                     leaf: float = 0.05):
    """Voxel-grid filter: mean point/color per occupied leaf
    (map_sl.cpp:106-111 VoxelGrid, 5 cm leaves)."""
    key = np.floor(points / leaf).astype(np.int64)
    # lexicographic voxel id
    kmin = key.min(axis=0)
    key = key - kmin
    span = key.max(axis=0) + 1
    vid = (key[:, 0] * span[1] + key[:, 1]) * span[2] + key[:, 2]
    order = np.argsort(vid, kind="stable")
    vid_s = vid[order]
    starts = np.r_[0, np.nonzero(np.diff(vid_s))[0] + 1]
    counts = np.diff(np.r_[starts, len(vid_s)])
    sums_p = np.add.reduceat(points[order], starts, axis=0)
    sums_c = np.add.reduceat(colors[order].astype(np.float64), starts,
                             axis=0)
    return (sums_p / counts[:, None]).astype(np.float32), \
        (sums_c / counts[:, None]).astype(np.uint8)


def statistical_outlier_removal(points: np.ndarray, k: int = 50,
                                std_mul: float = 1.0) -> np.ndarray:
    """Boolean keep-mask: mean k-NN distance within mu + std_mul*sigma
    (map_sl.cpp:114-120 StatisticalOutlierRemoval)."""
    if len(points) <= k + 1:
        return np.ones(len(points), bool)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1)   # first neighbor is self
    mean_d = d[:, 1:].mean(axis=1)
    mu, sigma = mean_d.mean(), mean_d.std()
    return mean_d <= mu + std_mul * sigma


def save_pcd(path: str, points: np.ndarray, colors: np.ndarray):
    """Binary .pcd with packed-float RGB (savePCDFileBinary layout)."""
    n = len(points)
    rgb = (colors[:, 0].astype(np.uint32) << 16) | \
        (colors[:, 1].astype(np.uint32) << 8) | colors[:, 2].astype(
            np.uint32)
    rgb_f = rgb.view(np.float32) if rgb.dtype.itemsize == 4 else \
        rgb.astype(np.uint32).view(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n"
    )
    buf = np.empty((n, 4), np.float32)
    buf[:, :3] = points
    buf[:, 3] = rgb_f
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(buf.tobytes())


def load_pcd(path: str):
    """Read back a binary .pcd written by save_pcd (round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"DATA binary\n")
    n = int([ln for ln in head.decode().splitlines()
             if ln.startswith("POINTS")][0].split()[1])
    buf = np.frombuffer(body, np.float32, count=4 * n).reshape(n, 4)
    rgb = buf[:, 3].view(np.uint32)
    colors = np.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF,
                       rgb & 0xFF], -1).astype(np.uint8)
    return buf[:, :3].copy(), colors


class DenseMapper:
    """Accumulates per-keyframe RGB-D images and exports the dense cloud.

    Call `add_keyframe(kf_id, color, depth)` whenever the System creates
    a keyframe from an RGB-D frame, and `save(map, cam, path)` at
    shutdown: poses are read from the current map, so loop and GBA
    corrections apply.  The back-projection runs on `device` (default:
    the GPU; raises when CUDA is missing)."""

    def __init__(self, max_depth: float = 7.0, stride: int = 2,
                 leaf: float = 0.05, depth_scale: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.frames: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.max_depth = float(max_depth)
        self.stride = int(stride)          # every 2nd KF (map_sl.cpp:44)
        self.leaf = float(leaf)
        self.depth_scale = float(depth_scale)   # DepthMapFactor

    def add_keyframe(self, kf_id: int, color: np.ndarray,
                     depth: np.ndarray):
        self.frames[int(kf_id)] = (
            np.asarray(color), np.asarray(depth, np.float32))

    def build_cloud(self, map_state, cam):
        pts, cols = [], []
        kf_ids = sorted(self.frames)[:: self.stride]
        for k in kf_ids:
            if not map_state.kf_valid[k]:
                continue
            color, depth = self.frames[k]
            Rcw = map_state.kf_Rcw[k]
            tcw = map_state.kf_tcw[k]
            Rwc = Rcw.T
            twc = -Rwc @ tcw
            dev = self.device
            pw, ok = _backproject(
                torch.from_numpy(np.ascontiguousarray(
                    depth / self.depth_scale, np.float32)).to(dev),
                cam.fx, cam.fy, cam.cx, cam.cy,
                torch.from_numpy(np.ascontiguousarray(Rwc)).to(dev),
                torch.from_numpy(np.ascontiguousarray(twc)).to(dev),
                max_depth=self.max_depth)
            ok = ok.cpu().numpy()
            pts.append(pw.cpu().numpy()[ok])
            c = color.reshape(-1, color.shape[-1]) if color.ndim == 3 \
                else np.repeat(color.reshape(-1, 1), 3, axis=1)
            cols.append(c[ok].astype(np.uint8))
        if not pts or sum(len(p) for p in pts) == 0:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.uint8))
        points = np.concatenate(pts)
        colors = np.concatenate(cols)
        points, colors = voxel_downsample(points, colors, self.leaf)
        keep = statistical_outlier_removal(points)
        return points[keep], colors[keep]

    def save(self, map_state, cam, path: str):
        points, colors = self.build_cloud(map_state, cam)
        save_pcd(path, points, colors)
        return len(points)
