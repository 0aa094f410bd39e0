"""Run one cell of the benchmark once, on the GPU it is started on.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (all of it counts as `setup_s`): load the port's CUDA libraries
(built into vieo_slam_tpu_torch/_build/ on a checkout's first run), render
the cell's sequence on the device from the seed, build the System, drive
the warm-up frames the traffic names.  Then a closed loop with one client
for --seconds: frame i+1 is handed over when frame i's pose has returned.
With --trace 1 every frame is bracketed by synchronized spans, and after
the --seconds the traffic's `profile_frames` more frames run under
torch.profiler: the traced window is both.  After the
window the program's state is freed and the plain references judge what
the window produced (portbench/check.py).  The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(and breakdown with --trace 1), then the numbers compared with their
limits.  Without a CUDA device, or with JAX loaded, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vieo_slam_tpu")
THREADS = 4                  # torch's CPU threads: one process, few threads


class RunError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _guard(when: str):
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: modules {found} are loaded in the process "
                       f"that measures the port")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cuda(torch, chips: int):
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the port on "
                       "an NVIDIA GPU and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} GPUs, "
                       f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def _snapshot(metrics) -> dict:
    return {"stages": {k: (s.count, s.total)
                       for k, s in metrics.stages.items()},
            "counters": dict(metrics.counters)}


def _delta(a: dict, b: dict) -> dict:
    """Stage (count, seconds) and counter changes from snapshot a to b."""
    st = {}
    for k, (n, tot) in b["stages"].items():
        n0, t0 = a["stages"].get(k, (0, 0.0))
        st[k] = (n - n0, tot - t0)
    ctr = {k: v - a["counters"].get(k, 0) for k, v in b["counters"].items()
           if isinstance(v, (int, float))}
    return {"stages": st, "counters": ctr}


class Window:
    """What the window measured, for the per-layer readers
    (portbench/layer_metrics): frames, seconds, spans, stage deltas, the
    profiler's summary and the kernels' bounds."""

    def __init__(self):
        self.frames = 0              # completed in the window
        self.seconds = 0.0
        self.frame_s = []            # hand-over to pose, frames not profiled
        self.build_s = []            # build_stereo_frame, frames not profiled
        self.unprofiled = None       # stage deltas, frames not profiled
        self.profiled_frames = 0
        self.profile = None          # profiling.summarize(...)
        self.bounds = {}             # roofline.Recorder.bounds()


def _warmup(sut, traffic, metrics, log):
    """Drive the traffic's warm-up frames; returns the first window frame.
    {"frames": n} drives n frames; with "until": "fused" the VI init must
    have been accepted and a frame fused by then."""
    w = traffic["warmup"]
    n = int(w["frames"])
    if w.get("until") not in (None, "fused"):
        raise RunError(f"warm-up {w!r}: until is 'fused' or absent")
    fused_at = None
    for i in range(n):
        n0 = metrics.stages["vio.fuse"].count
        sut.step(i)
        if fused_at is None and sut.fused_ready() \
                and metrics.stages["vio.fuse"].count > n0:
            fused_at = i
    if w.get("until") == "fused":
        if fused_at is None:
            raise RunError(f"no fused frame after the VI init's acceptance "
                           f"within the {n} warm-up frames")
        log(f"warm-up: VI init accepted, first fused frame {fused_at}")
    return n


def run(argv=None, *, device=None, root: Path | None = None,
        control: str | None = None, log=None) -> dict:
    """One run; returns the result object.  `device` and `root` serve the
    CPU tests (a device other than the GPU, a tree of tiny files);
    `control` ("tf32") runs the program under check.TF32 from its
    construction to the window's close and also judges the references in
    that precision in its place (result["control"]; the benchmark's own
    runs do not run it: python3 -m portbench.control)."""
    args = parse(argv)
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    _guard("at start")
    from . import cells, check, profiling, roofline, spec

    root = root or spec.ROOT
    c = spec.cell(args.workload, root)
    config, traffic = c["config"], c["traffic"]
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        import vieo_slam_tpu_torch  # noqa: F401
        from vieo_slam_tpu_torch.ops import cuda_build, matching, orb
        from vieo_slam_tpu_torch.utils.metrics import metrics
    except ImportError as e:
        raise RunError(f"the program under test does not import: {e}") from e
    dev = torch.device(device) if device is not None else \
        require_cuda(torch, int(c["workload"]["chips"]))
    on_gpu = dev.type == "cuda"
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_gpu:
        cuda_build.build_all()
    stamp = lambda what: log(f"set-up: {what} at "  # noqa: E731
                             f"{time.perf_counter() - T_START:.3f} s")
    stamp("device and kernels ready")
    seq = cells.Sequence(config, traffic, args.seed, dev)
    if on_gpu:
        torch.cuda.synchronize(dev)
    stamp(f"{len(seq)} frames rendered")
    low = None
    if control:
        low = check.TF32()
        low.__enter__()
    sut = cells.Sut(config, seq, dev)
    checker = check.Checker(config, seq, args.seed,
                            traffic.get("sample_span"))
    checker.install(sut)
    recorder = roofline.Recorder()
    recorder.install(orb, matching)
    metrics.reset()
    first = _warmup(sut, traffic, metrics, log)
    stamp(f"{first} warm-up frames tracked")
    if on_gpu:
        torch.cuda.synchronize(dev)
    gc.collect()
    setup_s = time.perf_counter() - T_START

    # The window.
    win = Window()
    attempted = failed = 0
    prof = span = None
    snap0 = _snapshot(metrics)
    snap_prof = None
    window_done = False
    returns = []                 # host clock at each unprofiled frame's pose
    sync = (lambda: torch.cuda.synchronize(dev)) if on_gpu else (lambda: None)
    i = first
    t0 = time.perf_counter()
    while True:
        if i >= len(seq):
            raise RunError(f"the sequence ran out of frames ({len(seq)}) "
                           f"{time.perf_counter() - t0:.1f} s into the "
                           f"window: the traffic needs more frames")
        if args.trace and prof is None and window_done:
            sync()
            snap_prof = _snapshot(metrics)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_gpu else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function(profiling.WINDOW_SPAN)
            span.__enter__()
            recorder.on = True
        k = i - first
        checker.begin(k, i)
        if args.trace:
            sync()
            a = time.perf_counter()
            with record_function(profiling.SPAN_PREFIX + "build"):
                if sut.vio is not None:
                    sut.feed_imu(i)
                frame = sut.build(i)
                sync()
            b = time.perf_counter()
            with record_function(profiling.SPAN_PREFIX + "track"):
                state = sut.track(frame)
                sync()
            e = time.perf_counter()
            if prof is None:
                win.build_s.append(b - a)
                win.frame_s.append(e - a)
            else:
                win.profiled_frames += 1
        else:
            state = sut.step(i)
        checker.end(k, i, sut.frame, sut.pose(), state.name == "LOST")
        if prof is None:
            returns.append(time.perf_counter())
        attempted += 1
        failed += state.name == "LOST"
        i += 1
        if prof is not None:
            if win.profiled_frames >= traffic["profile_frames"]:
                break
        elif time.perf_counter() - t0 >= args.seconds:
            if not args.trace:
                break
            window_done = True
    sync()
    win.seconds = time.perf_counter() - t0
    win.frames = attempted
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        recorder.on = False
    if low is not None:
        low.__exit__(None, None, None)
    checker.close(sut.system)
    snap1 = _snapshot(metrics)
    win.unprofiled = _delta(snap0, snap_prof or snap1)
    d = _delta(snap0, snap1)
    log("window stages: " + ", ".join(
        f"{k} {n} x {1e3 * s / n:.1f} ms" for k, (n, s) in
        sorted(d["stages"].items()) if n) + "; counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(d["counters"].items()) if v))
    _guard("after the window")
    peak = torch.cuda.max_memory_allocated(dev) if on_gpu else 0
    kind = torch.cuda.get_device_name(dev) if on_gpu else str(dev)

    if prof is not None:
        a = time.perf_counter()
        win.profile = profiling.summarize(prof)
        win.bounds = recorder.bounds()
        del prof
        log(f"trace: {win.profiled_frames} frames profiled, read in "
            f"{time.perf_counter() - a:.1f} s")

    metrics_out = {}
    if args.trace:
        for m in c["per_layer"]:
            value = spec.reader(m["name"]).read(win, log)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"frames_per_s": attempted / win.seconds, "setup_s": setup_s}
        for m in c["end_to_end"]:
            metrics_out[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # The program's state is freed before the references run on the card.
    sut.shutdown()
    del sut
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    checks = checker.judge(dev, log=log)
    correct = all(v <= lim for v, lim in checks.values())
    control_checks = checker.judge(dev, control=control, log=log) \
        if control else None

    device_out = {"platform": "gpu" if on_gpu else dev.type, "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics_out, "device": device_out}
    if args.trace and win.profile is not None:
        device_out["busy_s"] = win.profile["busy_s"]
        device_out["window_s"] = win.profile["window_s"]
        result["breakdown"] = {"device_ops": win.profile["device_ops"],
                               "idle_gaps": win.profile["idle_gaps"]}
    if len(returns) >= 4:
        # Is the per-frame cost steady?  Frames a second over each half.
        h = len(returns) // 2
        log(f"window halves: {h / (returns[h - 1] - t0):.4f} and "
            f"{(len(returns) - h) / (returns[-1] - returns[h - 1]):.4f} "
            f"frames/s")
    log(f"window: {attempted} frames in {win.seconds:.3f} s, {failed} LOST; "
        f"setup {setup_s:.3f} s; device {kind}, peak {peak} bytes")
    traj = checker.trajectory()
    log("trajectory (not compared): " + ", ".join(
        f"{k} {v!r}" for k, v in traj.items()))
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
    if control_checks is not None:
        result["control"] = {name: {"value": v, "limit": lim}
                             for name, (v, lim) in control_checks.items()}
        result["trajectory"] = traj
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    from .spec import SpecError

    try:
        result = run(argv)
    except (RunError, SpecError) as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
