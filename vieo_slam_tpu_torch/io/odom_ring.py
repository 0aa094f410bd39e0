"""Timestamped odometry ring buffer with windowed extraction.

Numpy copy of the fallback path of vieo_slam_tpu/native/__init__.py
OdomRing (the port keeps its own copy so that it never imports the JAX
package): 6-channel samples keyed by time; `window` cuts the padded
sample window covering (t0, t1] that the preintegrations consume, and
`window_filled` holds the last sample over a late tail.  The native C++
ring of that package is not built here.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class OdomRing:
    """Timestamped 6-channel sample ring.  Pushes and reads may come from
    different threads (a live feeder and the tracker): both hold a lock."""

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
