"""ORB extraction stages with the JAX package's f32 bits, on the CPU and the card.

The JAX package's System extracts ORB inside a jitted program on XLA's CPU
backend with x64 off (the rows' mode and JAX's default).  The stages below
compute what that program computes, bit for bit:

- `resize_weights`: the antialiased triangle weights of `jax.image.resize`
  as its jitted fusions compute them in f32 (an fma for the sample position,
  a separately rounded or a fused ``1 - |d| / scale`` depending on the
  fusion's loop, XLA's split of the column sum into windows of 32);
- `resize`: the two contractions of a pyramid level in the order of XLA's
  runtime dot (`DOT_ORDERS`), as sums over each output's 2-4 taps;
- `ic_angle`: the IC moments in the order of the reference's fused reduce
  and dot, then glibc's atan2f as XLA's runtime runs it;
- `brief`: glibc's sincosf and the rotated taps as XLA fuses them;
- `blur7_valid` / `gaussian_blur7`: the 7-tap sums with XLA's fma.

The arithmetic lives once, in `csrc/xla_f32.cuh` and `csrc/libm_f32.cuh`:
`csrc/xla_f32_host.cc` is its CPU build (g++ at first use, into `_build/`),
`csrc/xla_f32.cu` its card build (`cuda_build`).  A CPU tensor runs the
CPU build, a CUDA tensor launches the kernels; no library reduction,
product or transcendental takes part.  `scripts/xla_order.py` checks every
order against the JAX package.

`DOT_ORDERS` holds the orders XLA's runtime dot took at the pyramid shapes
of 752x480, 640x480 and 320x240 (8 levels at 1.2; `scripts/xla_order.py
--dot-orders` measures them).  Eigen picks its blocking and kernel path
from the shapes and the machine (cache sizes, threads), so another shape
takes the plain chain order, which is exact only where no tap group
crosses one of Eigen's blocks.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from . import cuda_build

_HOST_SRC = cuda_build.CSRC / "xla_f32_host.cc"
_HEADERS = ("xla_f32.cuh", "libm_f32.cuh")
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
              "-fno-fast-math")
_host_lock = threading.Lock()
_host = None

# XLA's runtime dot order of each pyramid contraction, by (pass, contracted
# size, output size, other size): "rows" contracts the image rows of an
# [H, W] level into [nh, W], "cols" the columns of [nh, W] into [nh, nw].
# Values: (order, k block); order 0 chain, 1 even/odd, 2 pairs
# (csrc/xla_f32.cuh XlaDotOrder); a block of None is the whole k.
CHAIN, EVEN_ODD, PAIRS = 0, 1, 2
DOT_ORDERS = {
    # 752x480
    ("rows", 480, 400, 752): (CHAIN, 240), ("cols", 752, 627, 400): (CHAIN, 512),
    ("rows", 400, 333, 627): (CHAIN, 200), ("cols", 627, 522, 333): (PAIRS, None),
    ("rows", 333, 278, 522): (CHAIN, 168), ("cols", 522, 435, 278): (CHAIN, 512),
    ("rows", 278, 231, 435): (CHAIN, None), ("cols", 435, 363, 231): (PAIRS, None),
    ("rows", 231, 193, 363): (CHAIN, None), ("cols", 363, 302, 193): (PAIRS, None),
    ("rows", 193, 161, 302): (CHAIN, None), ("cols", 302, 252, 161): (CHAIN, None),
    ("rows", 161, 134, 252): (CHAIN, None), ("cols", 252, 210, 134): (EVEN_ODD, None),
    # 640x480
    ("rows", 480, 400, 640): (CHAIN, 240), ("cols", 640, 533, 400): (EVEN_ODD, 320),
    ("rows", 400, 333, 533): (CHAIN, 200), ("cols", 533, 444, 333): (CHAIN, 512),
    ("rows", 333, 278, 444): (CHAIN, 168), ("cols", 444, 370, 278): (CHAIN, None),
    ("rows", 278, 231, 370): (CHAIN, None), ("cols", 370, 309, 231): (CHAIN, None),
    ("rows", 231, 193, 309): (CHAIN, None), ("cols", 309, 257, 193): (PAIRS, None),
    ("rows", 193, 161, 257): (CHAIN, None), ("cols", 257, 214, 161): (EVEN_ODD, 128),
    ("rows", 161, 134, 214): (CHAIN, None), ("cols", 214, 179, 134): (CHAIN, None),
    # 320x240
    ("rows", 240, 200, 320): (CHAIN, None), ("cols", 320, 267, 200): (PAIRS, None),
    ("rows", 200, 167, 267): (CHAIN, None), ("cols", 267, 222, 167): (EVEN_ODD, None),
    ("rows", 167, 139, 222): (CHAIN, None), ("cols", 222, 185, 139): (CHAIN, None),
    ("rows", 139, 116, 185): (CHAIN, 96), ("cols", 185, 154, 116): (EVEN_ODD, None),
    ("rows", 116, 96, 154): (CHAIN, None), ("cols", 154, 129, 96): (PAIRS, None),
    ("rows", 96, 80, 129): (CHAIN, None), ("cols", 129, 107, 80): (PAIRS, None),
    ("rows", 80, 67, 107): (CHAIN, 40), ("cols", 107, 89, 67): (EVEN_ODD, None),
}

LAUNCHES: dict[str, int] = {"resize": 0, "ic_angle": 0, "brief": 0,
                            "blur7": 0, "unary": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------


def _host_lib() -> ctypes.CDLL:
    """The CPU build of the stages, compiled with g++ at first use (named by
    a hash of sources and flags).  Raises RuntimeError when g++ is missing
    or the build fails."""
    global _host
    with _host_lock:
        if _host is not None:
            return _host
        src = _HOST_SRC.read_bytes() + b"".join(
            (cuda_build.CSRC / h).read_bytes() for h in _HEADERS)
        h = hashlib.sha1(src + " ".join(_GXX_FLAGS).encode()).hexdigest()[:12]
        target = cuda_build.BUILD_DIR / f"xla_f32_host_{h}.so"
        if not target.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the CPU build of the "
                                   "extraction stages is csrc/xla_f32_host.cc")
            cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            out = subprocess.run([gxx, *_GXX_FLAGS, "-o", str(tmp),
                                  str(_HOST_SRC), "-lm"], capture_output=True,
                                 text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for xla_f32_host.cc (rc "
                                   f"{out.returncode}):\n{out.stderr}")
            tmp.replace(target)
        lib = ctypes.CDLL(str(target))
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        for name, args in (
                ("xf_resize_pass", [P, L, L, L, I, P, P, P, P, I, I, P, L,
                                    L]),
                ("xf_ic_angle", [P, L, L, L, P, P, P]),
                ("xf_brief", [P, L, P, P, P, P]),
                ("xf_blur7", [P, L, I, I, P, P, P]),
                ("xf_atan2", [P, P, P, L]),
                ("xf_atan2_glibc", [P, P, P, L]),
                ("xf_sin", [P, P, L]),
                ("xf_cos", [P, P, L])):
            f = getattr(lib, name)
            f.argtypes, f.restype = args, None
        _host = lib
        return lib


def _cuda_lib():
    return cuda_build.library("xla_f32.cu")


def _launch(name: str, t: torch.Tensor, fn: str, *args):
    """Launch kernel `fn` of the card build on t's stream; counted."""
    lib = _cuda_lib()
    with cuda_build.on_device(t):
        rc = getattr(lib, fn)(*args, cuda_build.stream_of(t))
    cuda_build.check(rc, name)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------


def _fma32(a, b, c) -> np.ndarray:
    """Correctly rounded f32 fma(a, b, c) of f32 arrays: the exact product
    (f64), the sum rounded to odd in f64, then to f32."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _column_sum(w: np.ndarray) -> np.ndarray:
    """Sum over axis 0 as XLA's CPU backend reduces it: above 32 rows in
    windows of 32 (the padding split evenly), window sums then summed;
    every sum in index order."""
    f32 = np.float32
    while w.shape[0] > 32:
        pad = (-w.shape[0]) % 32
        lo = pad // 2
        z = np.zeros((lo,) + w.shape[1:], f32)
        wp = np.concatenate([z, w, np.zeros((pad - lo,) + w.shape[1:], f32)])
        wins = wp.reshape(-1, 32, *w.shape[1:])
        acc = np.zeros((wins.shape[0],) + w.shape[1:], f32)
        for i in range(32):
            acc = (acc + wins[:, i]).astype(f32)
        w = acc
    acc = np.zeros(w.shape[1:], f32)
    for i in range(w.shape[0]):
        acc = (acc + w[i]).astype(f32)
    return acc


def _triangle(in_size: int, out_size: int, fused_pos: bool, fused_w: bool):
    """(w [in, out], sample positions [out]) of one of the fusions' two
    ways of computing each: the sample position with an fma or with a
    rounded product, 1 - |d| / scale fused or rounded."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    c1 = f32(inv_scale)
    c2 = f32(1.0) / f32(max(inv_scale, 1.0))
    o = np.arange(out_size, dtype=f32) + f32(0.5)
    s = (_fma32(o, c1, f32(-0.5)) if fused_pos
         else ((o * c1).astype(f32) + f32(-0.5)).astype(f32))
    d = np.abs((s[None, :] - np.arange(in_size, dtype=f32)[:, None]).astype(f32))
    if fused_w:
        w = _fma32(-d, c2, f32(1.0))
    else:
        w = (f32(1.0) - np.abs((d * c2).astype(f32))).astype(f32)
    return np.maximum(w, f32(0.0)), s


@functools.lru_cache(maxsize=128)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of jax.image.resize(..., "bilinear") as the
    jitted program computes them (JAX 0.9.0 jax/_src/image/scale.py
    compute_weight_mat, x64 off, XLA's CPU backend).

    The column sum and the normalisation are two fusions over [in, out],
    each a loop over the output columns.  What LLVM made of each loop:
    - the normalising fusion: main and vector-remainder columns compute
      the sample position with an fma and w = max(1 - |d| * c, 0) rounded
      step by step; the scalar tail (past the last 8-column vector) is
      unrolled, so its positions fold at compile time (a rounded product)
      and 1 - |d| * c is one fma; for 87 columns or fewer the whole loop is
      unrolled that way;
    - the summed fusion: up to 10 blocks of 32 columns the loop is
      unrolled (folded positions, fused w); beyond, the 32-column main
      loop rounds w step by step, its 8-column remainder fuses it, and the
      scalar tail folds the positions and fuses w.
    Checked bit for bit against the jitted resize of an identity matrix for
    every input size from 33 to 1920 that the pyramids of 320x240 to
    1920x1080 reach (scripts/xla_order.py); sizes up to 32 reduce in one
    loop and are not checked."""
    f32 = np.float32
    n32 = out_size // 32
    vec_end = 32 * n32 + 8 * ((out_size % 32) // 8)
    col = np.arange(out_size)[None, :]
    w_fold_fused, _ = _triangle(in_size, out_size, False, True)
    w_step, s = _triangle(in_size, out_size, True, False)
    if out_size <= 87 or in_size <= 32:
        num = w_fold_fused
    else:
        num = np.where(col < vec_end, w_step, w_fold_fused)
    if in_size <= 32:
        den = _triangle(in_size, out_size, False, False)[0]
    elif n32 <= 10:
        den = w_fold_fused
    else:
        w_fma_fused, _ = _triangle(in_size, out_size, True, True)
        den = np.where(col < 32 * n32, w_step,
                       np.where(col < vec_end, w_fma_fused, w_fold_fused))
    tot = _column_sum(den)
    ok = np.abs(tot) > f32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(ok[None, :],
                 (num / np.where(tot != 0, tot, f32(1.0))[None, :]).astype(f32),
                 f32(0.0))
    inside = (s >= f32(-0.5)) & (s <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=128)
def _taps(in_size: int, out_size: int):
    """(first tap [out] int32, tap count [out] int32, offset of the first
    weight [out] int32, weights [taps] f32) of each output's run of nonzero
    weights (2-4 inputs at the pyramid's 1.2)."""
    w = resize_weights(in_size, out_size)
    k0 = np.zeros(out_size, np.int32)
    nt = np.zeros(out_size, np.int32)
    ww = []
    for o in range(out_size):
        nz = np.nonzero(w[:, o])[0]
        if len(nz):
            if nz[-1] - nz[0] + 1 != len(nz):
                raise ValueError(f"resize {in_size}->{out_size}: output {o} "
                                 f"has taps {nz.tolist()}")
            k0[o], nt[o] = nz[0], len(nz)
            ww.append(w[nz, o])
    off = np.concatenate([[0], np.cumsum(nt)[:-1]]).astype(np.int32)
    return k0, nt, off, np.concatenate(ww or [np.zeros(0, np.float32)])


_device_taps: dict = {}


def _taps_on(in_size: int, out_size: int, dev: torch.device):
    key = (in_size, out_size, str(dev))
    t = _device_taps.get(key)
    if t is None:
        t = tuple(torch.from_numpy(a).to(dev) for a in _taps(in_size, out_size))
        _device_taps[key] = t
    return t


def dot_order(kind: str, k: int, n_out: int, other: int) -> tuple[int, int]:
    """(order, k block) of one contraction; the chain over the whole k for
    shapes not in DOT_ORDERS."""
    order, kc = DOT_ORDERS.get((kind, k, n_out, other), (CHAIN, None))
    return order, (1 << 30) if kc is None else kc


def _resize_pass(src: torch.Tensor, kind: str, n_out: int) -> torch.Tensor:
    """One contraction: "rows" [K, R] -> [n_out, R], "cols" [R, K] ->
    [R, n_out]."""
    if kind == "rows":
        k, n_rows = src.shape
        sk, sr = n_rows, 1
        out = torch.empty((n_out, n_rows), dtype=torch.float32, device=src.device)
        so, sro = n_rows, 1
    else:
        n_rows, k = src.shape
        sk, sr = 1, k
        out = torch.empty((n_rows, n_out), dtype=torch.float32, device=src.device)
        so, sro = 1, n_out
    order, kc = dot_order(kind, k, n_out, n_rows)
    k0, nt, off, w = _taps_on(k, n_out, src.device)
    args = (src.data_ptr(), sk, sr, n_rows, n_out, k0.data_ptr(),
            nt.data_ptr(), off.data_ptr(), w.data_ptr(), order, kc,
            out.data_ptr(), so, sro)
    if src.is_cuda:
        _launch("resize", out, "vs_xf_resize_pass", *args)
    else:
        _host_lib().xf_resize_pass(*args)
    return out


def resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """jax.image.resize(img, (nh, nw), "bilinear") of an [H, W] f32 image
    as the reference's program computes it: rows first, then columns."""
    cuda_build.require(img, "img", torch.float32, (None, None))
    if min(img.shape) < 1 or nh < 1 or nw < 1:
        raise ValueError(f"resize {tuple(img.shape)} -> ({nh}, {nw})")
    out = img
    if nh != img.shape[0]:
        out = _resize_pass(out, "rows", nh)
    if nw != img.shape[1]:
        out = _resize_pass(out, "cols", nw)
    return out


# ---------------------------------------------------------------------------
# Keypoint tail
# ---------------------------------------------------------------------------


def disc_mask(radius: int) -> np.ndarray:
    """Circular patch mask (the reference's umax per-row extents)."""
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (xx * xx + yy * yy <= radius * radius).astype(np.float32)


_consts: dict = {}


def _const(name: str, dev: torch.device, make) -> torch.Tensor:
    key = (name, str(dev))
    t = _consts.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make())).to(dev)
        _consts[key] = t
    return t


def ic_angle(patches: torch.Tensor, moments: bool = False):
    """Intensity-centroid angle [N] of [N, 31, 31] f32 patches (any view
    whose rows are contiguous, e.g. the centre of [N, 53, 53] patches);
    with `moments`, (angle, [N, 2] (m01, m10))."""
    n = patches.shape[0]
    if patches.dtype != torch.float32 or patches.shape[1:] != (31, 31) \
            or (n and patches.stride(2) != 1):
        raise ValueError(f"expected [N, 31, 31] f32 patches with contiguous "
                         f"rows, got {patches.dtype} {tuple(patches.shape)} "
                         f"{patches.stride()}")
    dev = patches.device
    mask = _const("mask", dev, lambda: disc_mask(15))
    out = torch.empty(n, dtype=torch.float32, device=dev)
    mom = torch.empty((n, 2), dtype=torch.float32, device=dev) if moments \
        else None
    if n:
        args = (patches.data_ptr(), n, patches.stride(0), patches.stride(1),
                mask.data_ptr(), out.data_ptr(),
                None if mom is None else mom.data_ptr())
        if patches.is_cuda:
            _launch("ic_angle", out, "vs_xf_ic_angle", *args)
        else:
            _host_lib().xf_ic_angle(*args)
    return (out, mom) if moments else out


def brief(patches: torch.Tensor, angles: torch.Tensor, pattern: np.ndarray,
          box: torch.Tensor | None = None) -> torch.Tensor:
    """Rotated-BRIEF words [N, 8] int32 of blurred [N, 47, 47] patches at
    `angles` [N]; pattern [256, 2, 2] int32.  `box` [N, 4] int32 bounds the
    taps to (lo_x, hi_x, lo_y, hi_y) in patch coordinates (default: the
    patch)."""
    n = patches.shape[0]
    dev = patches.device
    patches = patches.contiguous()
    angles = angles.contiguous()
    cuda_build.require(patches, "patches", torch.float32, (n, 47, 47))
    cuda_build.require(angles, "angles", torch.float32, (n,), dev)
    if box is None:
        box = torch.tensor([0, 46, 0, 46], dtype=torch.int32,
                           device=dev).expand(n, 4)
    box = box.to(torch.int32).contiguous()
    cuda_build.require(box, "box", torch.int32, (n, 4), dev)
    pat = _const("pattern", dev,
                 lambda: pattern.astype(np.float32).reshape(512, 2))
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if not n:
        return out
    args = (patches.data_ptr(), n, angles.data_ptr(), box.data_ptr(),
            pat.data_ptr(), out.data_ptr())
    if patches.is_cuda:
        _launch("brief", out, "vs_xf_brief", *args)
    else:
        _host_lib().xf_brief(*args)
    return out


def gauss7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def blur7_valid(x: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Valid 7x7 Gaussian of [N, hs, ws] f32 -> [N, hs - 6, ws - 6]: along
    rows, then along columns, each 7-tap sum as XLA fuses it."""
    n, hs, ws = x.shape
    x = x.contiguous()
    cuda_build.require(x, "x", torch.float32, (n, hs, ws))
    if hs < 7 or ws < 7:
        raise ValueError(f"blur7_valid needs 7x7 windows, got {hs}x{ws}")
    dev = x.device
    out = torch.empty((n, hs - 6, ws - 6), dtype=torch.float32, device=dev)
    if not n:
        return out
    k = (ctypes.c_float * 7)(*gauss7(sigma).tolist())
    if x.is_cuda:
        tmp = torch.empty((n, hs, ws - 6), dtype=torch.float32, device=dev)
        _launch("blur7", out, "vs_xf_blur7", x.data_ptr(), n, hs, ws,
                ctypes.addressof(k), tmp.data_ptr(), out.data_ptr())
    else:
        tmp = torch.empty((hs, ws - 6), dtype=torch.float32)
        _host_lib().xf_blur7(x.data_ptr(), n, hs, ws, ctypes.addressof(k),
                             tmp.data_ptr(), out.data_ptr())
    return out


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian over [..., H, W] with edge padding (the JAX
    package's gaussian_blur7)."""
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    pad = torch.nn.functional.pad(x, (3, 3, 3, 3), mode="replicate")
    return blur7_valid(pad[:, 0], sigma).reshape(img.shape)


# ---------------------------------------------------------------------------
# Element-wise functions
# ---------------------------------------------------------------------------


def _elementwise(op: int, a: torch.Tensor, b: torch.Tensor | None = None):
    a = a.to(torch.float32).contiguous()
    b = a if b is None else b.to(torch.float32).contiguous()
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands differ: {tuple(a.shape)} on {a.device}, "
                         f"{tuple(b.shape)} on {b.device}")
    out = torch.empty_like(a)
    n = a.numel()
    if not n:
        return out
    if a.is_cuda:
        _launch("unary", out, "vs_xf_unary", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, op)
    else:
        lib = _host_lib()
        if op == 0:
            lib.xf_atan2(a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
        else:
            (lib.xf_sin if op == 1 else lib.xf_cos)(a.data_ptr(),
                                                    out.data_ptr(), n)
    return out


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f as XLA's CPU runtime runs it (subnormals as zero)."""
    return _elementwise(0, y, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    """glibc's sinf (its FMA build)."""
    return _elementwise(1, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """glibc's cosf (its FMA build)."""
    return _elementwise(2, x)


def atan2_glibc_host(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """glibc's own atan2f of f32 arrays (no flushing), CPU build."""
    y = np.ascontiguousarray(y, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(y)
    _host_lib().xf_atan2_glibc(y.ctypes.data, x.ctypes.data, out.ctypes.data,
                               y.size)
    return out
