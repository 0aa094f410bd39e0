"""ORB feature extraction in PyTorch: pyramid, FAST, orientation, rBRIEF.

Port of vieo_slam_tpu/ops/orb.py (the extraction path the TPU runs):
whole-image tensor math with fixed shapes, a deterministic per-cell
top-k + global top-N keypoint selection, and the keypoint tail.  The
default tail is the fused one (one 53x53 raw patch per keypoint, IC angle
from its centre, in-patch 7-tap blur, rotated-BRIEF taps); the unfused
tail (whole-image blur, two gathers per keypoint) sits behind
`FUSED_TAIL_MODE`.  On the GPU the image-wide FAST/NMS/blend step runs in
kernel B1 (ops/cuda_fast.py), the patch gathers of a frame in one launch
of kernel B2 (ops/cuda_gather.py), and with `TAIL_KERNEL_MODE = "on"` the
whole tail of a frame in one launch of kernel B5 (ops/cuda_tail.py).

Descriptors are [N, 8] int32 tensors carrying the bits of the JAX
package's uint32 words.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .cuda_fast import (FAST_CIRCLE, fast_nms_blend,  # noqa: F401
                        fast_nms_blend_multi, fast_score_maps, nms3)
from .cuda_gather import gather_patches, gather_patches_flat

PATCH_RADIUS = 15          # IC_Angle circular patch
DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32


def _make_brief_pattern(seed: int = 7) -> np.ndarray:
    """256 (p, q) point pairs for rBRIEF, i.i.d. N(0, (patch/5)^2) clipped
    to the 31x31 patch. Returns int32 [256, 2, 2] as ((x1, y1), (x2, y2))."""
    rng = np.random.RandomState(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.randn(DESC_BITS, 2, 2) * sigma
    pts = np.clip(np.round(pts), -PATCH_RADIUS + 1, PATCH_RADIUS - 1)
    return pts.astype(np.int32)


BRIEF_PATTERN = _make_brief_pattern()


def _disc_mask(radius: int) -> np.ndarray:
    """Circular patch mask (the reference's umax per-row extents)."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (xx * xx + yy * yy <= radius * radius).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell_size: int = 32          # spatial-binning cell for distribution
    cell_topk: int = 4           # candidates kept per cell before global topk
    border: int = 19             # valid-keypoint border

    @functools.cached_property
    def level_scales(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)

    @functools.cached_property
    def features_per_level(self) -> np.ndarray:
        """Geometric allocation over levels (ORBextractor ctor logic)."""
        inv = 1.0 / self.scale_factor
        w = inv ** np.arange(self.n_levels)
        n = np.floor(self.n_features * w / w.sum()).astype(np.int32)
        n[-1] = max(self.n_features - int(n[:-1].sum()), 0)
        return n


class OrbFeatures(NamedTuple):
    """Fixed-capacity extraction result (capacity N = cfg.n_features).

    uv [N, 2] f32 level-0 pixels (x, y); level [N] int32; angle [N] f32;
    score [N] f32; desc [N, 8] int32 (bits of 256-bit rBRIEF); valid [N].
    """

    uv: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] antialiased triangle-kernel resampling weights -- the
    weight matrix of jax.image.resize(..., "bilinear") when it downsamples
    (scale_and_translate with kernel width scaled by 1/scale), computed in
    f64 and rounded to f32."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Antialiased bilinear downsample [H, W] -> [nh, nw] as two f32
    matrix products, rows first, as jax.image.resize contracts them."""
    h, w = img.shape
    out = img
    if nh != h:
        wh = torch.from_numpy(_resize_weights(h, nh)).to(img.device)
        out = wh.T @ out
    if nw != w:
        ww = torch.from_numpy(_resize_weights(w, nw)).to(img.device)
        out = out @ ww
    return out


def build_pyramid(img: torch.Tensor, cfg: OrbConfig) -> list[torch.Tensor]:
    """[H, W] f32 -> per-level images; each level resizes the previous one."""
    h, w = img.shape
    levels = [img]
    for lv in range(1, cfg.n_levels):
        s = float(cfg.level_scales[lv])
        levels.append(_resize(levels[-1], round(h / s), round(w / s)))
    return levels


# ---------------------------------------------------------------------------
# FAST score + selection
# ---------------------------------------------------------------------------


def _stable_topk(x: torch.Tensor, k: int):
    """top-k along the last dim, ties to the lowest index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cell_table(score: torch.Tensor, c: int):
    """The [G, c*c] candidate table of a score map cut into c x c cells
    (zero-padded at the right and bottom), and (h, w, gx, G)."""
    h, w = score.shape
    gy, gx = -(-h // c), -(-w // c)
    padded = torch.nn.functional.pad(score, (0, gx * c - w, 0, gy * c - h))
    cells = padded.reshape(gy, c, gx, c).permute(0, 2, 1, 3).reshape(
        gy * gx, c * c)
    return cells, (h, w, gx, gy * gx)


def _picks(cell, in_cell, score, dims, cfg: OrbConfig):
    """(uv [n, 2] int32, valid [n]) of picks given by their cell and
    their index inside it."""
    h, w, gx, n_cells = dims
    c, b = cfg.cell_size, cfg.border
    uv = torch.stack([(cell % gx) * c + in_cell % c,
                      (cell // gx) * c + in_cell // c], dim=-1).int()
    valid = ((score > 0) & (cell < n_cells)
             & (uv[:, 0] >= b) & (uv[:, 0] < w - b)
             & (uv[:, 1] >= b) & (uv[:, 1] < h - b))
    return uv, valid


def select_keypoints(score: torch.Tensor, n_keep: int, cfg: OrbConfig):
    """Deterministic spatially-distributed top-N: per-cell top-k, then a
    global top-N by response.  Returns (uv [n, 2] int32 in-level coords,
    score [n], valid [n])."""
    cells, dims = _cell_table(score, cfg.cell_size)
    k = min(cfg.cell_topk, cells.shape[1])
    cell_scores, cell_idx = _stable_topk(cells, k)            # [G, k]
    flat_scores = cell_scores.reshape(-1)
    n_keep = min(n_keep, flat_scores.shape[0])
    top_scores, top_i = _stable_topk(flat_scores, n_keep)
    uv, valid = _picks(top_i // k, cell_idx.reshape(-1)[top_i], top_scores,
                       dims, cfg)
    return uv, top_scores, valid


def select_keypoints_batched(scores: list, n_keeps: list, cfg: OrbConfig):
    """select_keypoints of several score maps with one per-cell sort and
    one global sort: every map's cell table is zero-padded to the largest
    cell count and stacked ([L, Gmax, c*c], then [L, Gmax*k]).  Pad rows
    sit after every real cell, so the stable sort keeps the per-map
    order; a pick past a map's real candidates is a pad row, zeroed as
    the per-map path pads its shortfall.  Returns [(uv, score, valid),
    ...], each equal to select_keypoints(scores[i], n_keeps[i]) in every
    bit (up to the shortfall padding that `_pad_selection` adds to both).

    The JAX package's variant also zeroes the uv of picks that fail the
    border test; select_keypoints keeps them, and so does this one."""
    c = cfg.cell_size
    tables = [_cell_table(s, c) for s in scores]
    k = min(cfg.cell_topk, c * c)
    g_max = max(dims[3] for _, dims in tables)
    stacked = torch.stack([torch.nn.functional.pad(
        cells, (0, 0, 0, g_max - cells.shape[0])) for cells, _ in tables])
    cell_scores, cell_idx = _stable_topk(stacked, k)         # [L, Gmax, k]
    n_max = min(max(n_keeps), g_max * k)
    top_scores, top_i = _stable_topk(cell_scores.reshape(len(scores), -1),
                                     n_max)                  # [L, n_max]
    in_cell = torch.gather(cell_idx.reshape(len(scores), -1), 1, top_i)
    out = []
    for lv, (_, dims) in enumerate(tables):
        n_l = min(n_keeps[lv], g_max * k)
        s, cell = top_scores[lv, :n_l], top_i[lv, :n_l] // k
        uv, valid = _picks(cell, in_cell[lv, :n_l], s, dims, cfg)
        uv = torch.where((cell < dims[3])[:, None], uv, 0)
        out.append((uv, s, valid))
    return out


def select_keypoints_concat(scores: list, n_keeps: list, cfg: OrbConfig):
    """select_keypoints of several score maps with ONE per-cell sort over
    the concatenated real cells of all maps ([G_tot, c*c], no padding),
    then each map's global top-N on its slice.  Returns [(uv, score,
    valid), ...], each equal to select_keypoints(scores[i], n_keeps[i])
    in every bit (the JAX package's variant also zeroes the uv of picks
    that fail the border test; this one keeps them, as select_keypoints
    does)."""
    c = cfg.cell_size
    tables = [_cell_table(s, c) for s in scores]
    k = min(cfg.cell_topk, c * c)
    cell_scores, cell_idx = _stable_topk(
        torch.cat([cells for cells, _ in tables]), k)        # ONE sort
    out, o = [], 0
    for lv, (_, dims) in enumerate(tables):
        n_cells = dims[3]
        s_flat = cell_scores[o:o + n_cells].reshape(-1)
        i_flat = cell_idx[o:o + n_cells].reshape(-1)
        top_scores, top_i = _stable_topk(s_flat,
                                         min(n_keeps[lv], n_cells * k))
        uv, valid = _picks(top_i // k, i_flat[top_i], top_scores, dims, cfg)
        out.append((uv, top_scores, valid))
        o += n_cells
    return out


# ---------------------------------------------------------------------------
# Orientation + descriptors (fused tail)
# ---------------------------------------------------------------------------

# Rotation can push BRIEF taps to PATCH_RADIUS*sqrt(2): the descriptor
# patch must cover that.
BRIEF_R = int(math.ceil(PATCH_RADIUS * math.sqrt(2.0))) + 1   # 23
_BLUR_HALO = 3
_TAIL_R = BRIEF_R + _BLUR_HALO           # 26 -> 53x53 raw patch


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation over the circular patch
    [N, 31, 31] -> radians [N]."""
    radius = (patches.shape[-1] - 1) // 2
    mask = torch.from_numpy(_disc_mask(radius)).to(patches.device)
    coords = torch.arange(-radius, radius + 1, dtype=patches.dtype,
                          device=patches.device)
    weighted = patches * mask
    # Column sums then the x moment, row sums then the y moment: the
    # order in which the JAX package's einsums reduce.
    m10 = weighted.sum(dim=1) @ coords
    m01 = weighted.sum(dim=2) @ coords
    return torch.atan2(m01, m10)


def _gauss7(sigma: float = 2.0) -> list[float]:
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return [float(v) for v in k.astype(np.float32)]


def _blur7_patch(patches: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Valid-region separable 7x7 Gaussian over [N, D, D] -> [N, D-6, D-6]."""
    k = _gauss7(sigma)
    dd = patches.shape[-1]
    h = sum(patches[:, :, i:i + dd - 6] * k[i] for i in range(7))
    return sum(h[:, i:i + dd - 6, :] * k[i] for i in range(7))


def brief_from_patches(patches: torch.Tensor,
                       angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits from blurred patches [N, 47, 47] -> [N, 8] int32."""
    return brief_from_rotation(patches, torch.cos(angles), torch.sin(angles))


def brief_from_rotation(patches: torch.Tensor, ca: torch.Tensor,
                        sa: torch.Tensor) -> torch.Tensor:
    """brief_from_patches with the rotation given as cos [N] and sin [N]."""
    r = BRIEF_R
    d = 2 * r + 1
    assert patches.shape[-1] == d
    dev = patches.device
    pat = torch.from_numpy(BRIEF_PATTERN.astype(np.float32)).to(dev)
    px, py = pat[..., 0], pat[..., 1]                        # [256, 2]
    rx = torch.round(ca[:, None, None] * px - sa[:, None, None] * py).long()
    ry = torch.round(sa[:, None, None] * px + ca[:, None, None] * py).long()
    iy = (ry + r).clamp(0, d - 1)
    ix = (rx + r).clamp(0, d - 1)
    n = patches.shape[0]
    flat = patches.reshape(n, -1)
    idx = (iy * d + ix).reshape(n, -1)
    vals = torch.gather(flat, 1, idx).reshape(n, DESC_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).long()              # [N, 256]
    bits = bits.reshape(-1, DESC_WORDS, 32)
    shifts = torch.arange(32, device=dev)
    words = (bits << shifts).sum(dim=-1)                     # [N, 8] < 2^32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian over [..., H, W] with edge padding, rows
    then columns (the blur the unfused tail samples descriptors from)."""
    k = _gauss7(sigma)
    h_, w_ = img.shape[-2:]
    x = img.reshape(-1, 1, h_, w_)
    pad = torch.nn.functional.pad(x, (3, 3, 3, 3), mode="replicate")
    h = sum(pad[..., 3:-3, i:i + w_] * k[i] for i in range(7))
    hpad = torch.nn.functional.pad(h, (0, 0, 3, 3), mode="replicate")
    v = sum(hpad[..., i:i + h_, :] * k[i] for i in range(7))
    return v.reshape(img.shape)


def brief_descriptors(img_blur: torch.Tensor, centers: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF descriptors [N, 8] int32 sampled from a blurred level
    image around integer centers."""
    return brief_from_patches(gather_patches(img_blur, centers, BRIEF_R),
                              angles)


def _env_mode(name: str, extra: tuple = ()) -> str:
    """Validated auto/on/off environment switch, plus the modes `extra`
    (a typo must fail loudly instead of silently picking a path)."""
    v = os.environ.get(name, "auto").strip().lower()
    if v not in ("auto", "on", "off") + extra:
        raise ValueError(
            f"{name}={os.environ.get(name)!r}: expected "
            f"auto|on|off{''.join('|' + e for e in extra)}")
    return v


# Tail backends, named as in the JAX package.  FUSED_TAIL_MODE: "auto"
# and "on" take the fused tail (what the JAX package runs on its
# accelerator), "off" the unfused one.  TAIL_KERNEL_MODE: "on" routes the
# fused tail through kernel B5 (one launch for all levels); "auto" and
# "off" keep the B2 gather plus the PyTorch tail, the JAX default.
FUSED_TAIL_MODE = _env_mode("ORB_FUSED_TAIL")
TAIL_KERNEL_MODE = _env_mode("ORB_TAIL_KERNEL")
# Cross-level selection, named as in the JAX package: "on" takes
# select_keypoints_batched, "concat" select_keypoints_concat, over all
# (level, image) entries of extract_orb_batch at once; "auto" and "off"
# select per entry, the default (as in JAX, where both variants measured
# slower on its accelerator).  All three give the same features.
BATCHED_SELECT_MODE = _env_mode("ORB_BATCHED_SELECT", ("concat",))


def _use_fused_tail() -> bool:
    return FUSED_TAIL_MODE != "off"


def _use_tail_kernel() -> bool:
    return TAIL_KERNEL_MODE == "on"


def _tail_from_big(big: torch.Tensor):
    """(angle, desc) from pre-gathered [N, 53, 53] raw patches."""
    c0 = _TAIL_R - PATCH_RADIUS
    ang = ic_angle(big[:, c0:c0 + 2 * PATCH_RADIUS + 1,
                       c0:c0 + 2 * PATCH_RADIUS + 1])
    blurp = _blur7_patch(big)                                # [N, 47, 47]
    return ang, brief_from_patches(blurp, ang)


def extract_tail_fused(im: torch.Tensor, uv: torch.Tensor):
    """Fused orientation + descriptor tail of one level: (angle [N],
    desc [N, 8]) from the raw (unblurred) level image."""
    (ang, desc), = extract_tail_fused_multi([im], [uv])
    return ang, desc


def extract_tail_fused_multi(level_imgs: list, level_uvs: list,
                             per_image: list | None = None):
    """Fused tail of all levels of one image, or of several images whose
    levels come image after image (`per_image`: the number of levels of
    each; default one image).  With the tail kernel on: one launch of
    kernel B5.  Otherwise one launch of kernel B2 gathers the 53x53 patches
    of every level, image after image into one buffer, and one blur +
    IC-angle + BRIEF pass runs per image on its slice of it (the PyTorch
    tail's vectorized reductions are not row-independent to the last ulp,
    so an image's result must not depend on the other image).  Returns
    [(angle, desc), ...] per level."""
    if _use_tail_kernel():
        from . import cuda_tail
        return cuda_tail.tail_fused_multi(level_imgs, level_uvs)
    counts = [int(uv.shape[0]) for uv in level_uvs]
    big = gather_patches_flat(level_imgs, level_uvs, _TAIL_R)
    out, o, lv = [], 0, 0
    for n_lv in per_image or [len(level_imgs)]:
        sizes = counts[lv:lv + n_lv]
        n = sum(sizes)
        ang, desc = _tail_from_big(big[o:o + n])
        out += zip(ang.split(sizes), desc.split(sizes))
        o, lv = o + n, lv + n_lv
    return out


def _tails(level_imgs: list, level_uvs: list, per_image: list):
    """[(angle, desc), ...] per level through the configured tail; the
    levels come image after image, `per_image` of each."""
    if _use_fused_tail():
        return extract_tail_fused_multi(level_imgs, level_uvs, per_image)
    tails = []
    for im, uv in zip(level_imgs, level_uvs):
        ang = ic_angle(gather_patches(im, uv, PATCH_RADIUS))
        tails.append((ang, brief_descriptors(gaussian_blur7(im), uv, ang)))
    return tails


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------


def _select(scores: list, n_keeps: list, cfg: OrbConfig) -> list:
    """(uv, score, valid) of each blended score map through the
    configured selection, each padded to its n_keep rows."""
    if BATCHED_SELECT_MODE == "on":
        sels = select_keypoints_batched(scores, n_keeps, cfg)
    elif BATCHED_SELECT_MODE == "concat":
        sels = select_keypoints_concat(scores, n_keeps, cfg)
    else:
        sels = [select_keypoints(s, n, cfg) for s, n in zip(scores, n_keeps)]
    return [_pad_selection(*sel, n) for sel, n in zip(sels, n_keeps)]


def _pad_selection(uv, s, valid, n_l: int):
    """A selection padded to n_l rows (tiny levels)."""
    if uv.shape[0] < n_l:  # tiny levels: pad capacity
        padn = n_l - uv.shape[0]
        uv = torch.nn.functional.pad(uv, (0, 0, 0, padn))
        s = torch.nn.functional.pad(s, (0, padn))
        valid = torch.nn.functional.pad(valid, (0, padn))
    return uv.contiguous(), s, valid


def _assemble(lvs: list, sels: list, tails: list, cfg: OrbConfig,
              dev) -> OrbFeatures:
    """OrbFeatures of one image from its per-level selections and tails."""
    uts, lvls, angs, scs, descs, vals = [], [], [], [], [], []
    for lv, (uv, s, valid), (ang, desc) in zip(lvs, sels, tails):
        uts.append(uv.float() * float(cfg.level_scales[lv]))
        lvls.append(torch.full((uv.shape[0],), lv, dtype=torch.int32,
                               device=dev))
        angs.append(ang)
        scs.append(torch.where(valid, s, torch.zeros_like(s)))
        descs.append(desc)
        vals.append(valid)
    return OrbFeatures(
        uv=torch.cat(uts), level=torch.cat(lvls), angle=torch.cat(angs),
        score=torch.cat(scs), desc=torch.cat(descs), valid=torch.cat(vals))


def extract_orb_batch(imgs, cfg: OrbConfig, device=None) -> OrbFeatures:
    """ORB on a batch of same-sized images [B, H, W] (the stereo pair).

    Every field of the result has a leading [B] axis and equals the stacked
    per-image `extract_orb` results bit for bit: pyramid and selection run
    per (level, image), as in the JAX package; FAST + NMS + blend of every
    level of every image is one launch of kernel B1; the patch gather of
    the fused tail is one launch of kernel B2 or, with the tail kernel on,
    the whole keypoint tail one launch of kernel B5."""
    dev = resolve_device(device)
    imgs = torch.as_tensor(imgs, dtype=torch.float32).to(dev)
    if imgs.ndim != 3:
        raise ValueError(f"expected [B, H, W] images, got {tuple(imgs.shape)}")
    B = imgs.shape[0]
    pyramids = [build_pyramid(imgs[b].contiguous(), cfg) for b in range(B)]
    per_level = cfg.features_per_level
    levels = [lv for lv in range(cfg.n_levels) if per_level[lv] > 0]
    L = len(levels)
    level_imgs = [pyramids[b][lv] for b in range(B) for lv in levels]
    # Strict/permissive blended, NMS'd FAST score maps (selection input):
    # iniThFAST winners boosted above every minThFAST score.
    scores = fast_nms_blend_multi(level_imgs, cfg.fast_threshold,
                                  cfg.fast_min_threshold)
    sels = _select(scores, [int(per_level[lv]) for lv in levels * B], cfg)
    tails = _tails(level_imgs, [uv for uv, _, _ in sels], [L] * B)
    per_image = [_assemble(levels, sels[b * L:(b + 1) * L],
                           tails[b * L:(b + 1) * L], cfg, dev)
                 for b in range(B)]
    return OrbFeatures(*(torch.stack(f) for f in zip(*per_image)))


def extract_orb(img, cfg: OrbConfig, device=None) -> OrbFeatures:
    """Full ORB pipeline on one grayscale image [H, W] (f32 tensor or numpy).

    Runs on `device` (default: the GPU; raises when CUDA is missing).  A
    tensor already on `device` is used as it is."""
    dev = resolve_device(device)
    img = torch.as_tensor(img, dtype=torch.float32).to(dev)
    if img.ndim != 2:
        raise ValueError(f"expected an [H, W] image, got {tuple(img.shape)}")
    f = extract_orb_batch(img[None], cfg, device=dev)
    return OrbFeatures(*(x[0] for x in f))
