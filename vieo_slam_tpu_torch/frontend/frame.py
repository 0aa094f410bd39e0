"""Frame construction: the per-image measurement container.

Port of the rectified-stereo part of vieo_slam_tpu/frontend/frame.py: a
Frame is a NamedTuple of fixed-capacity tensors on one device.  Mono,
RGB-D and multi-camera frames come with their slices.
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
    fl = orb.extract_orb(img_left, cfg, device=dev)
    fr = orb.extract_orb(img_right, cfg, device=dev)
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
