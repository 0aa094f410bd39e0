"""The single-device frontend step, timed and checked as one unit.

Port of the JAX package's `__graft_entry__.entry`: the stereo-SLAM
per-frame frontend (ORB extraction of both images, the rectified stereo
search, the local-map projection association and motion-only BA of
tracking) at EuRoC's 752 x 480, 1200 features on 8 levels, against a
4096-landmark slab.  One call launches kernels B1 and B2 (the extraction
of the stereo pair), B3 (the stereo search) and B4 (the two projection
searches of `_track_kernel`).
"""

from __future__ import annotations

import numpy as np
import torch

from .cameras import models as cm
from .frontend.frame import build_stereo_frame
from .frontend.tracking import _track_kernel
from .ops import orb
from .utils.device import resolve_device


def entry(device=None):
    """(frontend_step, example_args): the step and its inputs on `device`
    (default: the GPU; raises when CUDA is missing), made from
    np.random.RandomState(0) as the JAX package makes them."""
    dev = resolve_device(device)
    H, W = 480, 752
    cfg = orb.OrbConfig(n_features=1200, n_levels=8)
    cam = cm.make_pinhole(458.0, 458.0, 376.0, 240.0, W, H)
    bf = 458.0 * 0.11
    slab = 4096
    inv_sigma2 = torch.from_numpy(
        (1.0 / cfg.level_scales ** 2).astype(np.float32)).to(dev)
    scales = cfg.level_scales.astype(np.float32)
    lm_level = torch.zeros(slab, dtype=torch.int32, device=dev)

    def frontend_step(img_l, img_r, Rcw0, tcw0, lm_pw, lm_desc, lm_valid):
        frame = build_stereo_frame(img_l, img_r, cfg, bf=bf, device=dev)
        res = _track_kernel(Rcw0, tcw0, lm_pw, lm_desc, lm_level, lm_valid,
                            frame, inv_sigma2, scales, 15.0, 6.0, bf, cam)
        return res.Rcw, res.tcw, res.n_inliers, frame.uv, frame.desc

    rng = np.random.RandomState(0)
    img_l = rng.rand(H, W).astype(np.float32) * 255.0
    img_r = np.roll(img_l, -5, axis=1)
    lm_pw = rng.randn(slab, 3).astype(np.float32) * [2, 1.5, 1] + [0, 0, 6]
    lm_desc = rng.randint(0, 2 ** 32, (slab, 8), np.uint64).astype(np.uint32)
    example_args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                         for x in (img_l, img_r,
                                   np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32),
                                   lm_pw.astype(np.float32),
                                   lm_desc.view(np.int32),
                                   np.ones(slab, bool)))
    return frontend_step, example_args
