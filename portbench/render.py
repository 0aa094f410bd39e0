"""Render a whole stereo sequence on the device, in a few large calls.

The same views as `generator.SyntheticWorld.render_view` (each visible
landmark stamps its bilinearly shifted texture, far to near, over a flat
background; brightness drift, then Gaussian noise, clipped), computed for
many frames at once: the nearest stamp that covers a pixel wins, as the
painter's order of the numpy renderer leaves it, and equal depths go to the
stamp painted last.  The noise comes from a `torch.Generator` on the
device, so the images of one seed repeat on one kind of device.  Images are
quantized to uint8, as a camera delivers them.
"""

from __future__ import annotations

import numpy as np
import torch

STAMP = 12          # texture stamp size (generator.SyntheticWorld)
BG_LEVEL = 96.0
MIN_DEPTH = 0.2


def _views(world, cam, Rcw, tcw, ts, dev):
    """(stamps [S, 12, 12] f32, pixel index [S, 12, 12] int64 into the
    [F, H, W] stack, paint rank [S]) of the F views."""
    F = Rcw.shape[0]
    H, W = cam["height"], cam["width"]
    pw = torch.from_numpy(world.pw).to(dev)
    pw = pw.expand(F, -1, -1).clone()
    if len(world.dynamic_ids):
        ids = torch.from_numpy(np.asarray(world.dynamic_ids)).to(dev)
        phase = torch.from_numpy(world._dyn_phase).to(dev)
        dirs = torch.from_numpy(world._dyn_dir).to(dev)
        t = torch.from_numpy(np.asarray(ts, np.float64)).to(dev)
        off = torch.sin((world.cfg.dynamic_omega * t)[:, None].float()
                        + phase[None])
        pw[:, ids] += world.cfg.dynamic_amp * off[..., None] * dirs[None]
    R = torch.from_numpy(np.ascontiguousarray(Rcw, np.float32)).to(dev)
    tt = torch.from_numpy(np.ascontiguousarray(tcw, np.float32)).to(dev)
    pc = torch.einsum("fnj,fij->fni", pw, R) + tt[:, None]
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                              z)
    u = cam["fx"] * (pc[..., 0] * inv_z) + cam["cx"]
    v = cam["fy"] * (pc[..., 1] * inv_z) + cam["cy"]
    P, h = STAMP, STAMP // 2
    vis = ((z > MIN_DEPTH) & (u >= h + 1) & (u < W - h - 2)
           & (v >= h + 1) & (v < H - h - 2))
    f_idx, l_idx = torch.nonzero(vis, as_tuple=True)
    u, v, z = u[f_idx, l_idx], v[f_idx, l_idx], z[f_idx, l_idx]
    # Paint order: by frame, then far to near, stable in landmark order.
    order = torch.argsort(-z, stable=True)
    order = order[torch.argsort(f_idx[order], stable=True)]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev)
    fl_u, fl_v = torch.floor(u), torch.floor(v)
    fu = (u - fl_u)[:, None, None]
    fv = (v - fl_v)[:, None, None]
    patches = torch.from_numpy(world._landmark_patches()).to(dev)
    pp = torch.nn.functional.pad(patches[l_idx][:, None], (1, 1, 1, 1),
                                 mode="replicate")[:, 0]
    stamps = ((1 - fv) * (1 - fu) * pp[:, 1:P + 1, 1:P + 1]
              + (1 - fv) * fu * pp[:, 1:P + 1, 0:P]
              + fv * (1 - fu) * pp[:, 0:P, 1:P + 1]
              + fv * fu * pp[:, 0:P, 0:P])
    off = torch.arange(P, device=dev) - h + 1
    rows = fl_v.long()[:, None] + off
    cols = fl_u.long()[:, None] + off
    pix = (f_idx[:, None, None] * H + rows[:, :, None]) * W + cols[:, None, :]
    return stamps, pix, rank


def render_views(world, cam, Rcw, tcw, ts, gains, biases, noise_sigma,
                 gen, dev, quantize=True):
    """[F, H, W] views at the poses (Rcw [F, 3, 3], tcw [F, 3]) and times ts
    [F], with brightness gains and biases [F] and noise of std
    `noise_sigma` drawn from `gen`: uint8, or f32 before quantization."""
    F = Rcw.shape[0]
    H, W = cam["height"], cam["width"]
    stamps, pix, rank = _views(world, cam, Rcw, tcw, ts, dev)
    n = F * H * W
    winner = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rank_px = rank[:, None, None].expand_as(pix).reshape(-1)
    pix = pix.reshape(-1)
    winner.scatter_reduce_(0, pix, rank_px, "amax")
    won = winner[pix] == rank_px
    img = torch.full((n,), BG_LEVEL, dtype=torch.float32, device=dev)
    img[pix[won]] = stamps.reshape(-1)[won]
    img = img.reshape(F, H, W)
    g = torch.as_tensor(np.asarray(gains, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(biases, np.float32), device=dev)
    img = g[:, None, None] * img + b[:, None, None]
    if noise_sigma > 0:
        img = img + torch.randn((F, H, W), generator=gen, device=dev,
                                dtype=torch.float32) * noise_sigma
    img = torch.clamp(img, 0.0, 255.0)
    return torch.round(img).to(torch.uint8) if quantize else img


def render_stereo_sequence(world, cam, baseline, Rcw, tcw, ts, gains, biases,
                           noise_sigma, seed, dev, chunk=32):
    """uint8 [F, 2, H, W]: the left and right views of every frame, the
    right camera displaced +baseline along the left camera's x axis."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    F = Rcw.shape[0]
    out = torch.empty((F, 2, cam["height"], cam["width"]), dtype=torch.uint8,
                      device=dev)
    t_right = np.asarray(tcw, np.float32) - np.asarray([baseline, 0, 0],
                                                       np.float32)
    for a in range(0, F, chunk):
        s = slice(a, min(F, a + chunk))
        for side, t_side in enumerate((tcw, t_right)):
            out[s, side] = render_views(world, cam, Rcw[s], t_side[s], ts[s],
                                        gains[s], biases[s], noise_sigma,
                                        gen, dev)
    return out
