"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the GPU: the port runs on the card unless the caller asks
    for another device, and it never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vieo_slam_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def nvidia_smi() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (every
    time measured on the card is kept beside them); raises RuntimeError
    when nvidia-smi fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
