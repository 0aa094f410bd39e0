"""vieo_slam_tpu_torch -- the PyTorch/CUDA port of vieo_slam_tpu.

Stereo visual SLAM on an NVIDIA GPU: plain PyTorch tensor code around
hand-written CUDA kernels (csrc/, built with nvcc for sm_90a at first
use).  The JAX package vieo_slam_tpu stays the reference; this package
imports nothing of it and nothing of JAX.

Public entry point: `vieo_slam_tpu_torch.system.System`.  Entry points
run on the GPU unless the caller passes a device (tests pass "cpu").
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry/BA math must run in true f32 (the JAX package forces
# jax_default_matmul_precision=highest for the same reason): no TF32 in
# matrix products or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# Lazy top-level API (importing the submodules eagerly would pull the
# whole frontend and backend at `import vieo_slam_tpu_torch`).
_API = {
    "System": "system", "SystemConfig": "system", "SensorMode": "system",
    "VioFrontend": "vio.frontend", "VioConfig": "vio.frontend",
    "LoopCloser": "backend.loop_closing",
    "LoopClosingConfig": "backend.loop_closing",
}


def __getattr__(name):
    if name in _API:
        import importlib
        mod = importlib.import_module(f".{_API[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
