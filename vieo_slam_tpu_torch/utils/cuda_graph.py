"""Replay a tensor function on the GPU from a captured CUDA graph.

The port's small dense solvers are thousands of tiny operators (the VIO
motion BA of one frame runs ~77000), and on the GPU each costs a host
launch that dwarfs its device time.  `GraphedCall` captures one call of
such a function into a CUDA graph and replays the graph on later calls:
the same kernels on the same device, one host launch.

While a stream captures, CUDA refuses a device-wide sync from any thread
(`torch.cuda.synchronize`, as a caller timing its frames makes; seen on
the H100), so captures run only on the thread that calls the entry
points, never beside the caller's own code.  The port's background
threads (the async mapping worker, the background global BA) run their
graphed calls under `no_capture()`: a layout they meet first runs plain
and is queued, and `capture_pending()`, which System.track_frame calls
on the caller's thread, captures it; later calls replay.  Each capture
is made in CUDA's thread-local mode, so the background threads' own
stream syncs, host copies and allocations do not break it (the
allocator gives the capture a private pool).  `capture_lock` lets one
capture run at a time, and the mapping worker holds it for its whole
keyframe stage, so no capture overlaps the worker's work.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

capture_lock = threading.RLock()
_local = threading.local()
_pending: list = []     # (GraphedCall, layout, inputs, spec) to capture
_pending_lock = threading.Lock()


@contextlib.contextmanager
def no_capture():
    """Graphed calls made on this thread inside the block capture nothing:
    a new layout runs plain and is queued for capture_pending()."""
    _local.defer = True
    try:
        yield
    finally:
        _local.defer = False


def capture_pending() -> int:
    """Capture the layouts that no_capture() threads queued, after the
    mapping worker's stage in flight, if any, has ended (it holds
    capture_lock).  Returns the number captured."""
    if not _pending:
        return 0
    with capture_lock:
        with _pending_lock:
            todo, _pending[:] = list(_pending), []
        for call, key, flat, spec in todo:
            call._capture(key, flat, spec)
        return len(todo)


class GraphedCall:
    """fn(*args, **kwargs), replayed from a CUDA graph on CUDA tensors.

    On CPU tensors it is the plain call.  On CUDA tensors each input
    layout (the tensors' shapes, dtypes and devices, the structure, and
    the values of the arguments that are not tensors) gets its own graph:
    its first call runs fn once eagerly on a side stream (the warm-up a
    capture needs), captures one call over private copies of the inputs
    and replays it; each later call copies its inputs into those copies,
    replays the graph and returns copies of the outputs.  fn must neither
    read the device from the host nor copy host memory to it."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: dict = {}      # layout -> CapturedCall
        self._queued: set = set()   # layouts waiting for capture_pending
        self._lock = threading.Lock()   # one replay of this fn at a time

    def __call__(self, *args, **kwargs):
        flat, spec = tree_flatten((args, kwargs))
        if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in flat):
            return self.fn(*args, **kwargs)
        key = layout(flat, spec)
        if key in self.graphs:
            with self._lock:
                g = self.graphs[key]
                g.load(flat)
                return g.replay()
        if getattr(_local, "defer", False):
            with _pending_lock:
                if key not in self._queued:
                    self._queued.add(key)
                    _pending.append((self, key, [
                        x.clone() if isinstance(x, torch.Tensor) else x
                        for x in flat], spec))
            return self.fn(*args, **kwargs)
        # A new layout: capture_lock first, as the worker's stage takes it.
        with capture_lock:
            self._capture(key, flat, spec)
            return self(*args, **kwargs)

    def _capture(self, key, flat, spec):
        with self._lock:
            if key not in self.graphs:
                g = CapturedCall(self.fn, flat, spec)
                g.replay()      # outputs for these inputs
                self.graphs[key] = g


class CapturedCall:
    """One captured call of fn: its input and output tensors, the graph
    that maps one onto the other, the thread that captured it and the
    replays of each thread."""

    def __init__(self, fn, flat, spec):
        self.fn, self.spec = fn, spec
        self.thread = threading.current_thread().name
        self.replays = collections.Counter()
        self.inputs = [x.clone() if isinstance(x, torch.Tensor) else x
                       for x in flat]
        args, kwargs = tree_unflatten(self.inputs, spec)
        with capture_lock:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(*args, **kwargs)

    def load(self, flat):
        for dst, src in zip(self.inputs, flat):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def replay(self):
        self.graph.replay()
        self.replays[threading.current_thread().name] += 1
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else x, self.outputs)

    def plain(self):
        """fn on the captured inputs, eagerly: the replay's reference."""
        args, kwargs = tree_unflatten(self.inputs, self.spec)
        return self.fn(*args, **kwargs)


def layout(flat, spec):
    """The key of one call's graph: the structure, the non-tensor leaves,
    and the shape, dtype and device of the tensor ones."""
    return repr(spec), tuple(
        (x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor) else x
        for x in flat)
