"""Build and load the hand-written CUDA kernels of the port.

Each source in `vieo_slam_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library with a plain C interface
and loaded with `ctypes`.  The libraries go into `vieo_slam_tpu_torch/_build/`
(git-ignored), named by a hash of source and flags, so a rebuild happens
only when a source changes.  Builds run at first use, all sources in
parallel (one `nvcc` each); nothing is compiled when a module is imported.

Every wrapper counts its launches in `LAUNCHES` (kernel name -> count),
bumped only where it launches its kernel, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fast_nms.cu", "gather.cu", "matching.cu", "tail.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "fast_nms_blend": 0,
    "gather_patches": 0,
    "fused_best2": 0,
    "fused_projection_best2": 0,
    "tail_fused": 0,
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fast_nms.cu": {"vs_fast_nms_blend_multi": (_P, _I, _P, _F, _F, _F, _P)},
    "gather.cu": {"vs_gather_patches_multi": (_P, _I, _P, _I, _P)},
    "matching.cu": {
        "vs_fused_best2": (_P, _P, _P, _I, _I, _P, _P),
        "vs_fused_projection_best2": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                                      _I, _I, _P, _P),
    },
    "tail.cu": {"vs_tail_fused": (_P, _I, _P, _P, _P, _P, _P, _P)},
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of vieo_slam_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def _target(src: str) -> Path:
    """The library of `src`, named by a hash of it, the shared headers and
    the flags."""
    h = hashlib.sha1((CSRC / src).read_bytes()
                     + b"".join(p.read_bytes()
                                for p in sorted(CSRC.glob("*.cuh")))
                     + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}_{h}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every missing kernel library, all sources in parallel.

    Returns the wall seconds spent (0 when everything was up to date).
    Raises RuntimeError with nvcc's output when a build fails."""
    todo = [s for s in SOURCES if not _target(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {src} (rc {p.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {src}]\n{log}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, building all kernels if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is not None:
            return lib
        build_all()
        lib = ctypes.CDLL(str(_target(src)))
        for fn, argtypes in _SIGNATURES[src].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[src] = lib
        return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """Make t's device current around a launch: the libraries link the
    static CUDA runtime, which launches on the calling thread's current
    device, whatever device the stream or the pointers belong to."""
    return torch.cuda.device(t.device)


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device | None = None):
    """Validate a kernel argument: dtype, shape (None = any), contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def require_all(ts: list, name: str, dtype: torch.dtype, shape: tuple,
                device: torch.device):
    """`require` for every tensor of a list; an error names the offending
    element."""
    for i, t in enumerate(ts):
        require(t, f"{name}[{i}]", dtype, shape, device)
