#!/usr/bin/env python3
"""Time one RANSAC draw on a GPU at the solvers' full-width shapes.

    python3 scripts/draw_cost.py [--reps 20]

Compares the keyed draw the solvers make (utils/prng.categorical_valid,
the JAX package's threefry stream) with torch.multinomial from a
torch.Generator, the draw the port's solvers made before they drew the
reference's stream, on the same valid masks.  Prints the card's name and
power limit, then for each shape the median ms of one call (CUDA events
around each call, after two warm-up calls) and the kernels one call
launches (cudaLaunchKernel calls under torch.profiler), and last one JSON
line with every number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vieo_slam_tpu_torch.utils import prng  # noqa: E402
from vieo_slam_tpu_torch.utils.device import nvidia_smi  # noqa: E402


def cases():
    """chip_smoke.py phase 23's shapes and valid masks."""
    rng = np.random.RandomState(23)
    return [("two-view init", (256, 8), rng.rand(1000) < 0.4),
            ("3D-3D PnP", (1024, 3), rng.rand(512) < 0.7),
            ("DLT PnP", (2048, 6), rng.rand(512) < 0.7),
            ("Sim3", (128, 3), np.arange(512) < 300),
            ("DLT PnP, no valid row", (2048, 6), np.zeros(512, bool))]


def multinomial_draw(valid, shape, generator):
    w = valid.float()
    w = torch.where(valid.any(), w, torch.ones_like(w))
    return torch.multinomial(w, int(np.prod(shape)), replacement=True,
                             generator=generator).reshape(shape)


def median_ms(fn, reps):
    fn(), fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launches(fn):
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaLaunchKernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("draw_cost: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, shape, valid in cases():
        v = torch.from_numpy(valid).to(dev)
        key = prng.prng_key(1)
        keyed = lambda: prng.categorical_valid(key, v, shape)  # noqa: E731
        multi = lambda: multinomial_draw(v, shape, gen)        # noqa: E731
        r = {"draw": name, "shape": [*shape, valid.size],
             "valid_rows": int(valid.sum()),
             "keyed_ms": median_ms(keyed, args.reps),
             "multinomial_ms": median_ms(multi, args.reps),
             "keyed_launches": launches(keyed),
             "multinomial_launches": launches(multi)}
        out.append(r)
        print(f"{name} {tuple(r['shape'])}, {r['valid_rows']} valid rows: "
              f"keyed {r['keyed_ms']:.4f} ms ({r['keyed_launches']} "
              f"kernels), multinomial {r['multinomial_ms']:.4f} ms "
              f"({r['multinomial_launches']} kernels)", flush=True)
    print(json.dumps({"draws": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
