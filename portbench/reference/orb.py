"""Plain ORB extraction and rectified stereo matching: the frame reference.

What `vieo_slam_tpu_torch.frontend.frame.build_stereo_frame` computes,
written again in plain PyTorch f32 from the algorithm's definition:

- pyramid: each level resizes the previous one by 1/1.2 with the
  antialiased triangle weights of jax.image.resize("bilinear"), as two
  matrix products (rows, then columns);
- FAST-9/16 scores at the two thresholds, 3x3 non-maximum suppression, the
  strict map boosted over the permissive one;
- selection: the best `cell_topk` of each 32x32 cell, then the level's
  best `features_per_level`, ties to the lowest index, border-gated;
- tail: the intensity-centroid angle over the radius-15 disc (moments as
  matrix products), the valid 7x7 Gaussian (sigma 2) of the 53x53 raw
  patch, 256 rotated BRIEF taps from pattern seed 7, bounded to the level
  image;
- stereo: same row within 2 px times the left level's scale, disparity in
  [bf / max_depth, bf / min_depth], levels within 1, Hamming best <= 100,
  mutual best.

The program rounds its pyramid, moments and transcendentals in another
order (XLA's); here the library's f32 order stands.  Where the control
asks for it, the matrix products run in TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH_RADIUS = 15
BRIEF_R = int(math.ceil(PATCH_RADIUS * math.sqrt(2.0))) + 1   # 23
TAIL_R = BRIEF_R + 3                                           # 26
TH_HIGH = 100
INF = 1 << 30

CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
          (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
          (-2, -2), (-1, -3)]


def brief_pattern(seed: int = 7) -> np.ndarray:
    """256 (p, q) pairs, i.i.d. N(0, (31/5)^2) rounded and clipped to the
    31x31 patch: int32 [256, 2, 2] as ((x1, y1), (x2, y2))."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(256, 2, 2) * ((2 * PATCH_RADIUS + 1) / 5.0)
    return np.clip(np.round(pts), -PATCH_RADIUS + 1,
                   PATCH_RADIUS - 1).astype(np.int32)


def level_scales(cfg: dict) -> np.ndarray:
    return cfg["scale_factor"] ** np.arange(cfg["n_levels"])


def features_per_level(cfg: dict) -> np.ndarray:
    inv = 1.0 / cfg["scale_factor"]
    w = inv ** np.arange(cfg["n_levels"])
    n = np.floor(cfg["n_features"] * w / w.sum()).astype(np.int32)
    n[-1] = max(cfg["n_features"] - int(n[:-1].sum()), 0)
    return n


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] antialiased triangle weights (jax.image.resize's
    compute_weight_mat for "bilinear"), in f64, stored f32."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    s = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(s[None, :] - np.arange(n_in)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(0)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def pyramid(img: torch.Tensor, cfg: dict) -> list:
    h, w = img.shape
    out = [img]
    for lv in range(1, cfg["n_levels"]):
        s = float(level_scales(cfg)[lv])
        nh, nw = round(h / s), round(w / s)
        prev = out[-1]
        wr = torch.from_numpy(resize_weights(prev.shape[0], nh)).to(img.device)
        wc = torch.from_numpy(resize_weights(prev.shape[1], nw)).to(img.device)
        out.append((wr.T @ prev) @ wc)
    return out


def _arc9(m):
    r = m & torch.roll(m, -1, 0)
    r = r & torch.roll(r, -2, 0)
    r = r & torch.roll(r, -4, 0)
    r = r & torch.roll(m, -8, 0)
    return r.any(dim=0)


def fast_scores(img, th):
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    diffs = [p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for dx, dy in CIRCLE]
    corner = _arc9(torch.stack([d > th for d in diffs])) | \
        _arc9(torch.stack([d < -th for d in diffs]))
    sb = torch.zeros_like(img)
    sd = torch.zeros_like(img)
    for d in diffs:
        sb = sb + torch.clamp_min(d - th, 0.0)
        sd = sd + torch.clamp_min(-d - th, 0.0)
    return torch.where(corner, torch.maximum(sb, sd), torch.zeros_like(img))


def nms3(score):
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def blended_scores(img, th_hi, th_lo, boost=1e4):
    hi = nms3(fast_scores(img, th_hi))
    lo = nms3(fast_scores(img, th_lo))
    return torch.where(hi > 0, hi + boost, lo)


def _topk(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select(score, n_keep: int, cell: int = 32, cell_topk: int = 4,
           border: int = 19):
    """(uv [n_keep, 2] int64 in-level, score, valid)."""
    h, w = score.shape
    gy, gx = -(-h // cell), -(-w // cell)
    padded = F.pad(score, (0, gx * cell - w, 0, gy * cell - h))
    cells = padded.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(
        gy * gx, cell * cell)
    k = min(cell_topk, cells.shape[1])
    cs, ci = _topk(cells, k)
    n = min(n_keep, cs.numel())
    top, ti = _topk(cs.reshape(-1), n)
    c_of = ti // k
    in_c = ci.reshape(-1)[ti]
    uv = torch.stack([(c_of % gx) * cell + in_c % cell,
                      (c_of // gx) * cell + in_c // cell], -1)
    valid = ((top > 0) & (c_of < gy * gx) & (uv[:, 0] >= border)
             & (uv[:, 0] < w - border) & (uv[:, 1] >= border)
             & (uv[:, 1] < h - border))
    if n < n_keep:
        pad = n_keep - n
        uv = F.pad(uv, (0, 0, 0, pad))
        top = F.pad(top, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, top, valid


def _patches(img, uv, r):
    H, W = img.shape
    off = torch.arange(2 * r + 1, device=img.device) - r
    cx = uv[:, 0].long().clamp(0, W - 1)
    cy = uv[:, 1].long().clamp(0, H - 1)
    rows = (cy[:, None] + off[None, :]).clamp(0, H - 1)
    cols = (cx[:, None] + off[None, :]).clamp(0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def gauss7(sigma: float = 2.0):
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32).tolist()


def tail(img, uv, pattern):
    """(angle [N], desc [N, 8] int32) of the keypoints uv (in-level ints)."""
    dev = img.device
    H, W = img.shape
    big = _patches(img, uv, TAIL_R)                          # [N, 53, 53]
    c0 = TAIL_R - PATCH_RADIUS
    disc = big[:, c0:c0 + 31, c0:c0 + 31]
    yy, xx = np.mgrid[-15:16, -15:16]
    mask = torch.from_numpy((xx * xx + yy * yy <= 225).astype(np.float32)).to(dev)
    coord = torch.arange(-15, 16, dtype=torch.float32, device=dev)
    m = disc * mask
    m01 = m.sum(-1) @ coord          # rows weighted by y
    m10 = m.sum(-2) @ coord          # columns weighted by x
    ang = torch.atan2(m01, m10)
    k = gauss7()
    d = big.shape[-1]
    rows = sum(big[:, :, i:i + d - 6] * k[i] for i in range(7))
    blur = sum(rows[:, i:i + d - 6, :] * k[i] for i in range(7))   # 47x47
    r = BRIEF_R
    cx = uv[:, 0].long().clamp(0, W - 1)
    cy = uv[:, 1].long().clamp(0, H - 1)
    lo_x = (r - cx).clamp(min=0)[:, None]
    hi_x = (r + W - 1 - cx).clamp(max=2 * r)[:, None]
    lo_y = (r - cy).clamp(min=0)[:, None]
    hi_y = (r + H - 1 - cy).clamp(max=2 * r)[:, None]
    pat = torch.from_numpy(pattern.astype(np.float32)).to(dev).reshape(512, 2)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    rx = torch.round(c * pat[:, 0] - s * pat[:, 1]).long() + r
    ry = torch.round(s * pat[:, 0] + c * pat[:, 1]).long() + r
    ix = torch.minimum(torch.maximum(rx, lo_x), hi_x)
    iy = torch.minimum(torch.maximum(ry, lo_y), hi_y)
    n = big.shape[0]
    vals = torch.gather(blur.reshape(n, -1), 1, iy * (2 * r + 1) + ix)
    vals = vals.reshape(n, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).long().reshape(n, 8, 32)
    words = (bits << torch.arange(32, device=dev)).sum(-1)
    return ang, torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def extract(img, cfg: dict, pattern):
    """dict(uv [N, 2] f32 level-0, level [N] int32, grid [N, 2] in-level
    ints, angle, desc [N, 8] int32, valid [N]) of one image [H, W] f32."""
    levels = pyramid(img, cfg)
    n_l = features_per_level(cfg)
    scales = level_scales(cfg)
    out = {k: [] for k in ("uv", "level", "grid", "angle", "desc", "valid")}
    for lv, im in enumerate(levels):
        if n_l[lv] <= 0:
            continue
        sc = blended_scores(im, cfg["fast_threshold"],
                            cfg["fast_min_threshold"])
        uv, _, valid = select(sc, int(n_l[lv]))
        ang, desc = tail(im, uv, pattern)
        out["uv"].append(uv.float() * float(scales[lv]))
        out["level"].append(torch.full((uv.shape[0],), lv, dtype=torch.int32,
                                       device=img.device))
        out["grid"].append(uv)
        out["angle"].append(ang)
        out["desc"].append(desc)
        out["valid"].append(valid)
    return {k: torch.cat(v) for k, v in out.items()}


def popcount32(x):
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming(da, db):
    d = torch.zeros((da.shape[0], db.shape[0]), dtype=torch.int64,
                    device=da.device)
    for w in range(da.shape[1]):
        d += popcount32(da[:, w, None] ^ db[None, :, w])
    return d


def best2(dist, mask):
    """(best col, best, second, best row of each column), ties to the
    lowest index, INF where no candidate."""
    M, N = dist.shape
    d = torch.where(mask, dist, torch.full_like(dist, INF))
    cols = torch.arange(N, device=d.device)
    rows = torch.arange(M, device=d.device)
    best = d.min(1).values
    ib = torch.where(d == best[:, None], cols[None], N).min(1).values
    second = torch.where(cols[None] == ib[:, None], INF, d).min(1).values
    cmin = d.min(0).values
    crow = torch.where(d == cmin[None], rows[:, None], M).min(0).values
    return ib, best, second, crow


def stereo(fl, fr, cfg: dict, bf: float, min_depth: float,
           max_depth: float):
    """u_right [N] (-1 unmatched) of the left keypoints."""
    scales = torch.from_numpy(level_scales(cfg).astype(np.float32)).to(
        fl["uv"].device)
    ul, ur = fl["uv"], fr["uv"]
    dv = torch.abs(ul[:, None, 1] - ur[None, :, 1])
    row_ok = dv <= 2.0 * scales[fl["level"].long()][:, None]
    disp = ul[:, None, 0] - ur[None, :, 0]
    disp_ok = (disp >= bf / max_depth) & (disp <= bf / min_depth)
    lvl_ok = torch.abs(fl["level"][:, None] - fr["level"][None, :]) <= 1
    mask = row_ok & disp_ok & lvl_ok & fl["valid"][:, None] & \
        fr["valid"][None, :]
    ib, best, _, crow = best2(hamming(fl["desc"], fr["desc"]), mask)
    rows = torch.arange(ib.shape[0], device=ib.device)
    ok = (best <= TH_HIGH) & (crow[ib.clamp_min(0)] == rows)
    u = ur[ib.clamp_min(0), 0]
    return torch.where(ok, u, torch.full_like(u, -1.0))


def frame(left, right, cfg: dict, bf: float, min_depth: float,
          max_depth: float):
    """The reference frame of a stereo pair (uint8 or f32 [H, W] tensors):
    the left image's extraction and its u_right."""
    pattern = brief_pattern()
    fl = extract(left.float(), cfg, pattern)
    fr = extract(right.float(), cfg, pattern)
    fl["ur"] = stereo(fl, fr, cfg, bf, min_depth, max_depth)
    return fl
