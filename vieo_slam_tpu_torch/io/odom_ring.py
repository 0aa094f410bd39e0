"""Timestamped odometry ring buffers with windowed extraction.

Two rings with one interface, 6-channel samples keyed by time: `window`
cuts the padded sample window covering (t0, t1] that the preintegrations
consume, and `window_filled` holds the last sample over a late tail.

- `NativeOdomRing` is the ring the VIO and encoder front ends use: the
  C++ ring of csrc/odom_buffer.cc (the JAX package's native ring, copied),
  compiled with g++ at first use into vieo_slam_tpu_torch/_build/ and
  bound with ctypes.  A failed build raises; nothing falls back.
- `OdomRing` is its plain numpy version (the JAX package's fallback path,
  copied), which a caller or a test selects explicitly; it equals the
  native ring window for window.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

_NATIVE_SRC = CSRC / "odom_buffer.cc"
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_native_lock = threading.Lock()
_native = None


class _RingWindows:
    """What both rings share on top of `latest_time` and `window`."""

    def wait_until(self, t_target: float, timeout: float,
                   poll_s: float = 0.001) -> bool:
        """Block up to `timeout` wall-clock seconds until a sample with
        timestamp >= t_target has arrived.  True if it did; returns at once
        when the samples are already there or timeout <= 0."""
        if self.latest_time() >= t_target:
            return True
        if timeout <= 0:
            return False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            time.sleep(poll_s)
            if self.latest_time() >= t_target:
                return True
        return self.latest_time() >= t_target

    def window_filled(self, t0: float, t1: float, cap: int, *,
                      tail_tol: float = 0.0):
        """window() plus a zero-order-hold tail for late odometry: if the
        newest sample ends more than `tail_tol` before t1, the last sample
        is held over the rest of the span.  Returns (vals, dts, mask, n,
        tail_lag)."""
        vals, dts, mask, n = self.window(t0, t1, cap)
        latest = self.latest_time()
        tail_lag = t1 - latest
        if tail_lag > tail_tol and 0 < n < cap and latest > t0:
            rows = int(mask.sum())
            held = t1 - max(t0, latest)
            vals[rows] = vals[rows - 1]
            dts[rows] = held
            mask[rows] = True
            return vals, dts, mask, n + 1, float(held)
        return vals, dts, mask, n, 0.0


def _native_lib() -> ctypes.CDLL:
    """The native ring's library, compiled at first use (named by a hash
    of source and flags).  Raises RuntimeError when g++ is missing or the
    build fails."""
    global _native
    with _native_lock:
        if _native is not None:
            return _native
        h = hashlib.sha1(_NATIVE_SRC.read_bytes()
                         + " ".join(_GXX_FLAGS).encode()).hexdigest()[:12]
        target = BUILD_DIR / f"odom_buffer_{h}.so"
        if not target.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the native odometry ring "
                                   "is built from csrc/odom_buffer.cc")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            out = subprocess.run([gxx, *_GXX_FLAGS, "-o", str(tmp),
                                  str(_NATIVE_SRC)], capture_output=True,
                                 text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for odom_buffer.cc (rc "
                                   f"{out.returncode}):\n{out.stderr}")
            tmp.replace(target)
        lib = ctypes.CDLL(str(target))
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
        P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        for name, args, res in (
                ("odom_ring_create", [I64], P),
                ("odom_ring_destroy", [P], None),
                ("odom_ring_push", [P, D, f32], None),
                ("odom_ring_push_bulk", [P, f64, f32, I64], None),
                ("odom_ring_size", [P], I64),
                ("odom_ring_latest_time", [P], D),
                ("odom_ring_window", [P, D, D, I64, f32, f32, u8], I64)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _native = lib
        return lib


class NativeOdomRing(_RingWindows):
    """The C++ ring (csrc/odom_buffer.cc): one producer (a live feeder or
    the caller) and readers on other threads."""

    native = True

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self._lib = _native_lib()
        self._h = self._lib.odom_ring_create(self.capacity)
        if not self._h:
            raise MemoryError("odom_ring_create failed")
        self._free = weakref.finalize(self, self._lib.odom_ring_destroy,
                                      self._h)

    def push(self, t: float, v6):
        v6 = np.ascontiguousarray(v6, np.float32).reshape(6)
        self._lib.odom_ring_push(self._h, float(t), v6)

    def push_bulk(self, ts, v6s):
        ts = np.ascontiguousarray(ts, np.float64).reshape(-1)
        v6s = np.ascontiguousarray(v6s, np.float32).reshape(len(ts), 6)
        self._lib.odom_ring_push_bulk(self._h, ts, v6s, len(ts))

    def size(self) -> int:
        return int(self._lib.odom_ring_size(self._h))

    def latest_time(self) -> float:
        return float(self._lib.odom_ring_latest_time(self._h))

    def window(self, t0: float, t1: float, cap: int):
        """Padded window covering (t0, t1]: (vals [cap, 6], dts [cap],
        mask [cap] bool, n_total); n_total > cap means it did not fit."""
        vals = np.zeros((cap, 6), np.float32)
        dts = np.zeros(cap, np.float32)
        mask = np.zeros(cap, np.uint8)
        n = int(self._lib.odom_ring_window(self._h, float(t0), float(t1),
                                           int(cap), vals, dts, mask))
        return vals, dts, mask.astype(bool), n


class OdomRing(_RingWindows):
    """The plain numpy ring.  Pushes and reads may come from different
    threads (a live feeder and the tracker): both hold a lock."""

    native = False

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._t = np.zeros(capacity, np.float64)
        self._v = np.zeros((capacity, 6), np.float32)
        self._n = 0
        self._lock = threading.Lock()

    def push(self, t: float, v6):
        v6 = np.asarray(v6, np.float32)
        with self._lock:
            self._t[self._n % self.capacity] = t
            self._v[self._n % self.capacity] = v6
            self._n += 1

    def push_bulk(self, ts, v6s):
        for t, v in zip(np.asarray(ts, np.float64),
                        np.asarray(v6s, np.float32)):
            self.push(t, v)

    def size(self) -> int:
        return min(self._n, self.capacity)

    def latest_time(self) -> float:
        with self._lock:
            if self._n == 0:
                return -1.0
            return float(self._t[(self._n - 1) % self.capacity])

    def window(self, t0: float, t1: float, cap: int):
        """Padded window covering (t0, t1]: (vals [cap, 6], dts [cap],
        mask [cap] bool, n_total); n_total > cap means it did not fit."""
        vals = np.zeros((cap, 6), np.float32)
        dts = np.zeros(cap, np.float32)
        mask = np.zeros(cap, bool)
        with self._lock:
            n_avail = min(self._n, self.capacity)
            idx = np.arange(self._n - n_avail, self._n) % self.capacity
            t = self._t[idx]
            v = self._v[idx]
        i0 = max(int(np.searchsorted(t, t0, side="right")) - 1, 0)
        out = 0
        for i in range(i0, n_avail - 1):
            if t[i] >= t1:
                break
            ta, tb = max(t[i], t0), min(t[i + 1], t1)
            if tb - ta <= 0:
                continue
            if out < cap:
                vals[out] = v[i]
                dts[out] = tb - ta
                mask[out] = True
            out += 1
        return vals, dts, mask, out


def trim_padding(*arrays):
    """Cut the trailing sample columns that no window uses.  The last
    array is the [..., T] validity mask of windows from OdomRing.window
    (each window's valid samples come first); the others are [..., T] or
    [..., T, C].  Padded samples are exact no-ops of the preintegration,
    so its loop over the samples need not run over them."""
    mask = arrays[-1]
    n = max(int(mask.sum(axis=-1).max()) if mask.size else 0, 1)
    return tuple(a[..., :n, :] if a.ndim > mask.ndim else a[..., :n]
                 for a in arrays)
