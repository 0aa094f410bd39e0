#!/usr/bin/env python3
"""Check the f32 operation orders of ops/xla_f32.py against the JAX package.

The port's extraction stages (vieo_slam_tpu_torch/ops/xla_f32.py,
csrc/xla_f32.cuh, csrc/libm_f32.cuh) compute what the JAX package's jitted
extraction computes on XLA's CPU backend with x64 off.  This script holds
each order to XLA on random inputs, bit for bit, on the CPU:

    python3 scripts/xla_order.py --weights      # resize weights, sizes 33-1920
    python3 scripts/xla_order.py --dot-orders   # each pyramid contraction
    python3 scripts/xla_order.py --stages       # blur, rotation, moments, libm
    python3 scripts/xla_order.py --dump DIR     # XLA's HLO, LLVM IR, objects
    python3 scripts/xla_order.py --save-libm tests/data/xla_f32_libm.npz

--dot-orders tries, for every contraction of the 8-level pyramids of
752x480, 640x480 and 320x240, the three orders of csrc/xla_f32.cuh (chain,
even/odd, pairs) with every k block that is a multiple of 8, prints the
ones that reproduce XLA's runtime dot and whether DOT_ORDERS holds one of
them.  --dump writes, for the stereo frame's two extractions in one jit,
XLA's optimized HLO (*.cpu_after_optimizations.txt), the LLVM IR of each
fusion (*.ir-with-opt.ll) and its object file (*.o): `nm` on an object
names the C library routines it calls (atan2f, sincosf), `objdump -d`
shows the fma it formed.  --save-libm writes fixed inputs and the CPU
build's atan2 / sin / cos of them (chip_smoke.py holds the card's build to
them).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((480, 752), (480, 640), (240, 320))


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    return jax


def xla_weights(jax, in_size, out_size):
    eye = np.eye(in_size, dtype=np.float32)
    r = jax.jit(lambda m: jax.image.resize(m, (out_size, in_size),
                                           "bilinear"))(eye)
    return np.asarray(r).T


def level_sizes(h, w, n=8):
    a, b = h, w
    for lv in range(1, n):
        na, nb = round(h / 1.2 ** lv), round(w / 1.2 ** lv)
        yield (a, na, b), (b, nb, na)      # (k, out, other) rows, cols
        a, b = na, nb


def check_weights():
    from vieo_slam_tpu_torch.ops import xla_f32
    jax = _jax()
    pairs = set()
    for h, w in SHAPES + ((120, 160), (600, 800), (720, 1280), (1080, 1920),
                          (512, 512), (376, 1241)):
        for (a, na, _), (b, nb, _) in level_sizes(h, w):
            pairs |= {(a, na), (b, nb)}
    pairs |= {(int(1.2 * b + 0.5), b) for b in range(33, 700, 7)}
    bad = 0
    for a, b in sorted(p for p in pairs if p[0] > 32):
        d = int((xla_f32.resize_weights(a, b).view(np.int32)
                 != xla_weights(jax, a, b).view(np.int32)).sum())
        bad += d
        if d:
            print(f"weights {a}->{b}: {d} entries differ")
    print(f"weights: {len(pairs)} size pairs, {bad} entries differ")
    return bad == 0


def _tapsum(w, src, order, kc):
    """Numpy twin of xla_f32.cuh xla_tapsum: out [n_out, R] from src [k, R]."""
    from vieo_slam_tpu_torch.ops.xla_f32 import PAIRS, _fma32
    f32 = np.float32
    out = np.zeros((w.shape[1], src.shape[1]), f32)
    for o in range(w.shape[1]):
        ks = np.nonzero(w[:, o])[0]
        prod = {k: (w[k, o] * src[k]).astype(f32) for k in ks}
        if order == PAIRS:
            acc, i = None, 0
            while i < len(ks):
                k = ks[i]
                s = prod[k]
                if k % 2 == 0 and i + 1 < len(ks):
                    s = (s + prod[ks[i + 1]]).astype(f32)
                    i += 1
                i += 1
                acc = s if acc is None else (acc + s).astype(f32)
            out[o] = acc
            continue
        r = None
        for blk in sorted({k // kc for k in ks}):
            c = d = None
            for k in (k for k in ks if k // kc == blk):
                fw = np.full(src.shape[1], w[k, o], f32)
                if order == 0 or k % 2 == 0:
                    c = prod[k] if c is None else _fma32(fw, src[k], c)
                else:
                    d = prod[k] if d is None else _fma32(fw, src[k], d)
            b = d if c is None else (c if d is None else (c + d).astype(f32))
            r = b if r is None else (r + b).astype(f32)
        out[o] = r
    return out


def check_dot_orders():
    from vieo_slam_tpu_torch.ops import xla_f32
    jax = _jax()
    ok = True
    for h, w in SHAPES:
        for kind_sizes in level_sizes(h, w):
            for kind, (k, n_out, other) in zip(("rows", "cols"), kind_sizes):
                rng = np.random.RandomState(k * 7 + n_out)
                wm = xla_f32.resize_weights(k, n_out)
                if kind == "rows":
                    img = (rng.rand(k, other) * 255).astype(np.float32)
                    want = np.asarray(jax.jit(lambda m: jax.image.resize(
                        m, (n_out, other), "bilinear"))(img))
                    src = img
                else:
                    img = (rng.rand(other, k) * 255).astype(np.float32)
                    want = np.asarray(jax.jit(lambda m: jax.image.resize(
                        m, (other, n_out), "bilinear"))(img)).T
                    src = img.T.copy()
                found = []
                for order in (0, 1, 2):
                    for kc in (range(8, k + 8, 8) if order < 2 else (0,)):
                        got = _tapsum(wm, src, order, max(kc, 1))
                        if np.array_equal(got.view(np.int32),
                                          want.view(np.int32)):
                            found.append((order, None if kc >= k or
                                          order == 2 else kc))
                        if kc >= k:
                            break
                have = xla_f32.dot_order(kind, k, n_out, other)
                have = (have[0], None if have[1] >= k else have[1])
                hit = have in found or (have[1] is None and any(
                    f[0] == have[0] and f[1] is None for f in found))
                ok &= hit
                print(f"{h}x{w} {kind} k={k} out={n_out} other={other}: "
                      f"orders {found[:4]}{' ...' if len(found) > 4 else ''}; "
                      f"DOT_ORDERS {'holds one' if hit else 'MISSES'}",
                      flush=True)
    return ok


def check_stages():
    import ctypes

    import jax.numpy as jnp
    import torch
    from vieo_slam_tpu.ops import orb as jorb
    from vieo_slam_tpu_torch.ops import xla_f32
    jax = _jax()
    rng = np.random.RandomState(0)
    img = (rng.rand(200, 300) * 255).astype(np.float32)
    blur = np.asarray(jax.jit(jorb.gaussian_blur7)(img))
    d_blur = int((xla_f32.gaussian_blur7(torch.from_numpy(img)).numpy()
                  .view(np.int32) != blur.view(np.int32)).sum())
    ang = (rng.rand(20000) * 2 * np.pi - np.pi).astype(np.float32)
    pat = jorb.BRIEF_PATTERN.astype(np.float32)
    px, py = pat[..., 0], pat[..., 1]
    rx, ry = map(np.asarray, jax.jit(lambda a: (
        jnp.cos(a)[:, None, None] * px - jnp.sin(a)[:, None, None] * py,
        jnp.sin(a)[:, None, None] * px + jnp.cos(a)[:, None, None] * py))(ang))
    c = xla_f32.cos(torch.from_numpy(ang)).numpy()[:, None, None]
    s = xla_f32.sin(torch.from_numpy(ang)).numpy()[:, None, None]
    f = xla_f32._fma32
    d_rx = int((f(c, px, -(s * py)).view(np.int32) != rx.view(np.int32)).sum())
    d_ry = int((f(s, px, (c * py).astype(np.float32)).view(np.int32)
                != ry.view(np.int32)).sum())
    patches = (rng.rand(4000, 31, 31) * 255).astype(np.float32)
    a_ref = np.asarray(jax.jit(jorb.ic_angle)(patches))
    d_ang = int((xla_f32.ic_angle(torch.from_numpy(patches)).numpy()
                 .view(np.int32) != a_ref.view(np.int32)).sum())
    libm = ctypes.CDLL("libm.so.6")
    libm.atan2f.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float] * 2
    y, x = rng.randn(2, 20000).astype(np.float32) * 100
    g = np.array([libm.atan2f(float(a), float(b)) for a, b in zip(y, x)],
                 np.float32)
    d_glibc = int((xla_f32.atan2_glibc_host(y, x).view(np.int32)
                   != g.view(np.int32)).sum())
    print(f"blur: {d_blur} of {blur.size} differ; rotated taps x / y: "
          f"{d_rx} / {d_ry} of {rx.size}; IC angles: {d_ang} of "
          f"{len(patches)}; atan2f against glibc: {d_glibc} of {len(y)}")
    return not (d_blur or d_rx or d_ry or d_ang or d_glibc)


def dump(out_dir: str):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
from vieo_slam_tpu.ops import orb
cfg = orb.OrbConfig(1200, 8)
f = jax.jit(lambda l, r: (orb.extract_orb(l, cfg), orb.extract_orb(r, cfg)))
x = (np.random.RandomState(0).rand(2, 480, 752) * 255).astype(np.float32)
jax.block_until_ready(f(x[0], x[1]))
"""
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={out_dir}")
    subprocess.run([sys.executable, "-c", code], env=env, check=True)
    print(f"XLA dump in {out_dir}")
    return True


def libm_inputs():
    rng = np.random.RandomState(2024)
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-45, -1e-45,
                        1e-40, 1.2e-38, 3e38, -3e38, 0.5, 1e-30, 1e30, 120.0,
                        119.99, 0.7853982, 1e-12, np.pi, -np.pi / 2],
                       np.float32)
    n = 20000
    y = np.concatenate([(rng.randn(n) * 300).astype(np.float32),
                        np.repeat(special, len(special))])
    x = np.concatenate([(rng.randn(n) * 300).astype(np.float32),
                        np.tile(special, len(special))])
    v = np.concatenate([(rng.rand(n) * 8 - 4).astype(np.float32),
                        (rng.randn(n // 4) * 1e4).astype(np.float32),
                        (rng.randn(500) * 1e30).astype(np.float32), special])
    return y, x, v


def save_libm(path: str):
    import torch
    from vieo_slam_tpu_torch.ops import xla_f32
    y, x, v = libm_inputs()
    t = torch.from_numpy
    np.savez_compressed(path, y=y, x=x, v=v,
                        atan2=xla_f32.atan2(t(y), t(x)).numpy(),
                        sin=xla_f32.sin(t(v)).numpy(),
                        cos=xla_f32.cos(t(v)).numpy())
    print(f"wrote {path}")
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", action="store_true")
    ap.add_argument("--dot-orders", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--save-libm", default=None)
    a = ap.parse_args()
    ok = True
    if a.weights:
        ok &= check_weights()
    if a.dot_orders:
        ok &= check_dot_orders()
    if a.stages:
        ok &= check_stages()
    if a.dump:
        ok &= dump(a.dump)
    if a.save_libm:
        ok &= save_libm(a.save_libm)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
