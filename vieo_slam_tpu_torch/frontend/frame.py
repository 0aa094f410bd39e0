"""Frame construction: the per-image measurement container.

Port of vieo_slam_tpu/frontend/frame.py (rectified stereo, RGB-D,
monocular, distorted monocular and distorted 2-4-camera rigs): a Frame is
a NamedTuple of fixed-capacity tensors on one device.  The images of a
frame are extracted together (`orb.extract_orb_batch`: one FAST launch
and one patch-gather launch for all levels of all images).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import models as cm
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


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev)


def epipolar_mask(cam0: cm.Camera, cam_i: cm.Camera, rays0: torch.Tensor,
                  rays_i: torch.Tensor, tol: float) -> torch.Tensor:
    """[N0, Ni] candidate mask of cam0 <-> cam_i matching: the rig's
    epipolar constraint |ray_i^T E ray_0| < tol on unit-depth rays, with
    E = [t]x R of cam_i <- cam0."""
    Ri0 = cam_i.Rcr @ cam0.Rcr.T
    ti0 = cam_i.tcr - Ri0 @ cam0.tcr
    tx = np.array([[0, -ti0[2], ti0[1]], [ti0[2], 0, -ti0[0]],
                   [-ti0[1], ti0[0], 0]], np.float32)
    E = _on(tx @ Ri0, rays0.device)
    return torch.abs((rays0 @ E.T) @ rays_i.T) < tol


def build_multicam_frame(imgs, cams, cfg: orb.OrbConfig, *,
                         geom_cam: cm.Camera, virt_bf: float,
                         min_depth: float = 0.1, max_depth: float = 40.0,
                         max_hamming: int = 50, epipolar_tol: float = 0.01,
                         min_parallax_cos: float = 0.9998, timestamp=0.0,
                         return_stats: bool = False, device=None):
    """Distorted / fisheye multi-camera frame for rigs of 2..4 cameras.

    - ORB on every camera's image (cam0 is primary: its keypoints define
      the Frame);
    - descriptor matching cam0 <-> cam_i under the rig's epipolar
      constraint (|ray_i^T E_i0 ray_0| < epipolar_tol on unit planes, the
      candidate mask of kernel B3) and the rotation-histogram check;
    - DLT triangulation through the extrinsics with positive-depth,
      parallax and two-view reprojection (chi-square) checks; the first
      camera that triangulates a keypoint gives its depth;
    - keypoints mapped through the camera model onto the undistorted
      virtual pinhole `geom_cam` that tracking and mapping use, the depth
      carried as a virtual-stereo right-u (ur = u - virt_bf / z).

    cams[i].Rcr/tcr are camera-from-rig extrinsics (only relative poses
    matter).  With return_stats, also returns one dict per partner camera
    of 0-d tensors on the device: matches, accepted (new depths) and the
    mean two-view squared reprojection error of the accepted pairs.
    Runs on `device` (default: the GPU; raises when CUDA is missing)."""
    dev = resolve_device(device)
    batch = torch.stack([torch.as_tensor(im, dtype=torch.float32).to(dev)
                         for im in imgs])
    f = orb.extract_orb_batch(batch, cfg, device=dev)
    feats = [orb.OrbFeatures(*(x[b] for x in f)) for b in range(len(imgs))]
    f0 = feats[0]
    rays0 = cm.unproject(cams[0], f0.uv)             # cam0 frame, z = 1
    uv_g = cm.project(geom_cam, rays0)               # virtual pinhole
    N = f0.uv.shape[0]
    depth = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
    sig2 = _on((cfg.level_scales ** 2).astype(np.float32), dev)
    R0, t0 = _on(cams[0].Rcr, dev), _on(cams[0].tcr, dev)
    per_view_stats = []
    for ci, fi in zip(cams[1:], feats[1:]):
        raysi = cm.unproject(ci, fi.uv)
        Ri, ti = _on(ci.Rcr, dev), _on(ci.tcr, dev)
        idx, _ = matching.match_descriptors(
            f0.desc, fi.desc, f0.valid, fi.valid, max_dist=max_hamming,
            angle_a=f0.angle, angle_b=fi.angle,
            extra_mask=epipolar_mask(cams[0], ci, rays0, raysi,
                                     epipolar_tol))
        sel = idx.clamp_min(0).long()
        rays_pair = torch.stack([rays0, raysi[sel]], dim=1)     # [N, 2, 3]
        R_cw = torch.stack([R0, Ri]).expand(N, 2, 3, 3)
        t_cw = torch.stack([t0, ti]).expand(N, 2, 3)
        pw = cm.triangulate_dlt(rays_pair, R_cw, t_cw)
        depths, cos_par = cm.triangulation_checks(pw, R_cw, t_cw, rays_pair)
        z0 = depths[:, 0]
        # The two-view reprojection gate: the epipolar constraint alone
        # admits wrong matches along the epipolar curve, consistent
        # triangulations at the wrong depth.
        e0 = torch.sum((cm.project(cams[0], pw @ R0.T + t0) - f0.uv) ** 2,
                       -1)
        ei = torch.sum((cm.project(ci, pw @ Ri.T + ti) - fi.uv[sel]) ** 2,
                       -1)
        chi2_ok = ((e0 < 5.991 * sig2[f0.level.long()])
                   & (ei < 5.991 * sig2[fi.level[sel].long()]))
        ok = ((idx >= 0) & (z0 > min_depth) & (z0 < max_depth)
              & (depths[:, 1] > min_depth) & (cos_par < min_parallax_cos)
              & chi2_ok)
        newly = ok & (depth < 0)
        if return_stats:
            n_new = newly.sum()
            per_view_stats.append({
                "matches": (idx >= 0).sum(), "accepted": n_new,
                "mean_err2": torch.where(newly, e0 + ei,
                                         torch.zeros_like(e0)).sum()
                / n_new.clamp_min(1)})
        depth = torch.where(newly, z0, depth)
    has_d = depth > 0
    none = torch.full_like(depth, -1.0)
    ur = torch.where(has_d, uv_g[:, 0] - virt_bf / depth.clamp_min(1e-6),
                     none)
    frame = Frame(uv=uv_g, level=f0.level, angle=f0.angle, desc=f0.desc,
                  ur=ur, depth=torch.where(has_d, depth, none),
                  valid=f0.valid & cm.in_image(geom_cam, uv_g, 0.0),
                  timestamp=float(timestamp))
    if return_stats:
        return frame, per_view_stats
    return frame


def build_undistorted_mono_frame(img, cam: cm.Camera, cfg: orb.OrbConfig, *,
                                 geom_cam: cm.Camera, timestamp=0.0,
                                 device=None) -> Frame:
    """Monocular distorted frame: ORB on the distorted image, keypoints
    mapped through the camera model onto the virtual pinhole `geom_cam`.
    Runs on `device` (default: the GPU; raises when CUDA is missing)."""
    dev = resolve_device(device)
    f = orb.extract_orb(img, cfg, device=dev)
    uv_g = cm.project(geom_cam, cm.unproject(cam, f.uv))
    none = torch.full((f.uv.shape[0],), -1.0, dtype=torch.float32, device=dev)
    return Frame(uv=uv_g, level=f.level, angle=f.angle, desc=f.desc,
                 ur=none, depth=none.clone(),
                 valid=f.valid & cm.in_image(geom_cam, uv_g, 0.0),
                 timestamp=float(timestamp))
