"""Frame construction: the per-image measurement container.

Port of the pinhole part of vieo_slam_tpu/frontend/frame.py (rectified
stereo, RGB-D and monocular): a Frame is a NamedTuple of fixed-capacity
tensors on one device.  Distorted multi-camera frames come with their
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import matching, orb
from ..utils.device import resolve_device


class Frame(NamedTuple):
    """Measurement set of one frame.

    uv [N, 2] f32 level-0 pixels; level [N] int32; angle [N] f32;
    desc [N, 8] int32 (descriptor bits); ur [N] right-image u (<0 none);
    depth [N] metric depth (<0 unknown); valid [N] bool;
    timestamp: Python float (f64).
    """

    uv: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    ur: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor
    timestamp: float


def desc_to_tensor(desc, device) -> torch.Tensor:
    """uint32 [N, 8] descriptor words (numpy) -> int32 tensor, same bits."""
    if isinstance(desc, torch.Tensor):
        return desc.to(device=device, dtype=torch.int32)
    a = np.array(desc)              # a writable, contiguous copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def make_frame_from_features(uv, level, angle, desc, valid, ur=None,
                             depth=None, timestamp=0.0, device=None) -> Frame:
    """Assemble a Frame from pre-extracted features (numpy or tensors)."""
    dev = resolve_device(device)

    def tensor(x, np_dtype, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        return torch.from_numpy(np.array(x, np_dtype)).to(dev)

    n = len(uv)
    none = np.full(n, -1.0, np.float32)
    return Frame(
        uv=tensor(uv, np.float32, torch.float32),
        level=tensor(level, np.int32, torch.int32),
        angle=tensor(angle, np.float32, torch.float32),
        desc=desc_to_tensor(desc, dev),
        ur=tensor(none if ur is None else ur, np.float32, torch.float32),
        depth=tensor(none if depth is None else depth, np.float32,
                     torch.float32),
        valid=tensor(valid, bool, torch.bool),
        timestamp=float(timestamp),
    )


def build_stereo_frame(img_left, img_right, cfg: orb.OrbConfig, *, bf: float,
                       min_depth: float = 0.1, max_depth: float = 40.0,
                       timestamp=0.0, device=None) -> Frame:
    """Rectified-stereo frame: ORB on both images + row-search depth.

    Runs on `device` (default: the GPU; raises when CUDA is missing)."""
    dev = resolve_device(device)
    pair = torch.stack([
        torch.as_tensor(im, dtype=torch.float32).to(dev)
        for im in (img_left, img_right)])
    f = orb.extract_orb_batch(pair, cfg, device=dev)
    fl, fr = (orb.OrbFeatures(*(x[b] for x in f)) for b in (0, 1))
    u_r, _ = matching.search_stereo_rectified(
        fl.uv, fl.level, fl.desc, fl.valid,
        fr.uv, fr.level, fr.desc, fr.valid,
        min_disp=bf / max_depth, max_disp=bf / min_depth,
        level_scales=cfg.level_scales.astype(np.float32))
    disp = fl.uv[:, 0] - u_r
    depth = torch.where(u_r >= 0, bf / torch.clamp_min(disp, 1e-6),
                        torch.full_like(u_r, -1.0))
    return Frame(uv=fl.uv, level=fl.level, angle=fl.angle, desc=fl.desc,
                 ur=u_r, depth=depth, valid=fl.valid,
                 timestamp=float(timestamp))


def build_mono_frame(img, cfg: orb.OrbConfig, *, timestamp=0.0,
                     device=None) -> Frame:
    """Monocular frame: ORB only -- no depth, no right-u (depth arrives
    later through two-view initialization and triangulation)."""
    dev = resolve_device(device)
    f = orb.extract_orb(img, cfg, device=dev)
    none = torch.full((f.uv.shape[0],), -1.0, dtype=torch.float32, device=dev)
    return Frame(uv=f.uv, level=f.level, angle=f.angle, desc=f.desc,
                 ur=none, depth=none.clone(), valid=f.valid,
                 timestamp=float(timestamp))


def make_mono_frame(img, cfg: orb.OrbConfig, timestamp=0.0,
                    device=None) -> Frame:
    """build_mono_frame with the timestamp as a positional argument."""
    return build_mono_frame(img, cfg, timestamp=timestamp, device=device)


def build_rgbd_frame(img, depth_img, cfg: orb.OrbConfig, *, bf: float,
                     depth_scale: float = 1.0, timestamp=0.0,
                     device=None) -> Frame:
    """RGB-D frame: depth sampled at the keypoint's pixel (truncated
    coordinates), virtual right-u = u - bf / z; z <= 0 means no depth."""
    dev = resolve_device(device)
    f = orb.extract_orb(img, cfg, device=dev)
    depth_img = torch.as_tensor(depth_img, dtype=torch.float32).to(dev)
    xi = f.uv[:, 0].long().clamp(0, depth_img.shape[1] - 1)
    yi = f.uv[:, 1].long().clamp(0, depth_img.shape[0] - 1)
    z = depth_img[yi, xi] * depth_scale
    has_d = z > 0
    none = torch.full_like(z, -1.0)
    ur = torch.where(has_d, f.uv[:, 0] - bf / torch.clamp_min(z, 1e-6), none)
    return Frame(uv=f.uv, level=f.level, angle=f.angle, desc=f.desc,
                 ur=ur, depth=torch.where(has_d, z, none), valid=f.valid,
                 timestamp=float(timestamp))
