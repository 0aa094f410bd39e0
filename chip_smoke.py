#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vieo_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device: CUDA is required; prints the card and its power limit.
  2. build: compiles every CUDA kernel of the port from csrc/ (nvcc,
     sm_90a, one process per source, all in parallel).
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the card, at the shapes the full-width main path gives it (B1 and
     B2 bit-exact, for the 8 levels of one image and the 16 of a stereo
     pair in one launch each, and at the 4-level lists of the known and
     mono cells; B3 and B4 identical integers, B5 identical descriptor
     bits and angles within 1e-6 rad; B3 and B4 also at the shapes the
     place-recognition path gives them and on all-invalid inputs), a call
     timed with CUDA events, the
     kernels alone read from torch.profiler, the PyTorch operators that
     the wrappers of B1 and B4 call around their launch, and B2's library
     yardstick (F.grid_sample, nearest, border padding), checked equal.
  4. known configuration: the 640x480 / 600-feature / 4-level stereo
     sequence of tests/test_image_e2e.py, 40 frames through
     build_stereo_frame + System.track_frame; must hold that test's bars
     (0 LOST, ATE RMSE < 0.02 m, >= 5 keyframes, > 200 landmarks).
  5. full width (the main path): 752x480, 1200 features, 8 levels, a
     4096-landmark tracking slab, 30 stereo frames.  Launch counters are
     zeroed just before and read just after; B1 and B2 must have run
     exactly once per frame (all 16 level images in one launch each), B3
     and B4 at all; 0 LOST.
  6. RGB-D full width: the same world, trajectory and sizes with the depth
     map of render_view(return_depth=True) and the tail kernel B5 on, 30
     frames.  Counters zeroed before and read after: B5 must have run once
     per frame, B1 once per frame, B2 never, B3 and B4 at all; 0 LOST, ATE RMSE
     < 0.02 m, >= 5 keyframes, > 200 landmarks.  Then the extraction time of these images
     with the tail kernel on and off.
  7. mono known configuration: the monocular row of
     examples/evaluate_ntimes.py (640x480, 1000 features, 4 levels, 2200
     landmarks, circle at 0.35 rad/s, 60 frames, photometric noise and
     brightness drift), tail kernel on.  Counters zeroed before and read
     after (B5 and B1 once per frame, B2 never; B3, B4 at all); the two-view
     initialization must come at the JAX package's frame for this
     sequence (JAX_MONO_KNOWN).  The reference initializes there on a weak
     pair and loses the track at frame 40, and so does the port, so the
     bars hold the port to the reference with scripts/vio_rows.py's
     tolerance of a row (MONO_KNOWN_TOL, 30 %): no frame after the init is
     LOST before frame 28 (40 less 30 %; a run that stays OK longer
     passes), and the scale-aligned ATE RMSE of the OK frames lies within
     30 % of the reference's 0.22862 m.  The bars of a tracked mono
     sequence (no LOST frame, ATE under 0.02 m) are phase 23's, on the
     mono_loop row.
  8. profile: the last 4 frames of a 10-frame full-width stereo run under
     torch.profiler -- device busy share, device ops and host waits per
     frame, the device time of each stage and the top device entries.
  9. stereo blackout at full width (place recognition): the
     stereo_blackout row of examples/evaluate_ntimes.py at 752x480, 1200
     features, 8 levels -- 2200 landmarks (2 % of them moving), an outward
     circle at 0.35 rad/s, 60 frames, photometric noise and drift, frames
     36-47 black -- with a LoopCloser attached, once at each noise seed of
     PLACE_SEEDS (0, and 11, the row's first run).  Counters zeroed before
     and read after, and read around every relocalization call: it must
     relocalize at least once, be OK again by frame 53 and never LOST after
     the first recovery, with the keyframe ATE after the recovery under
     0.02 m, and B3 and B4 launched inside the relocalization calls.  Held
     to the JAX package's run of the same row, seed and size
     (ACCURACY_fullwidth.json): LOST frames and relocalizations within 30 %
     or 1, the whole-run keyframe ATE after the final GBA within 30 % or 1
     mm; both packages' numbers are printed (also the ATE without the
     final GBA, which the card's run-to-run spread at seed 11 keeps out of
     the bars).  Then,
     at seed 0, the host waits of one relocalization, from torch.profiler.
 10. stereo loop at full width: the stereo_loop row (4000 landmarks, 2 %
     moving, a 1.5 m outward circle at 180 frames a lap, 360 frames,
     min_kf_gap 30), same sizes, seed 0 alone.  Bars: 0 LOST, a loop
     closed, fused points > 0, keyframe ATE after the final global BA <
     0.02 m, B3 and B4 launched inside loop_closer.process_keyframe.  Held
     to the JAX package's run (ACCURACY_fullwidth.json): the first closure
     the same pair of keyframes (46 to 5), the keyframe ATE right after it
     and after the final GBA within 30 % or 1 mm of its.  Which pair closes
     first follows the vocabulary trained from the first keyframes'
     descriptors, which the extraction now computes bit for bit as the JAX
     package does (phase 24; PERF.md §6).  Prints both
     packages' closure records, and the
     keyframe ATE before and after the first closure and without and with
     the final GBA, the ms of relocalization, loop closing (split between
     candidate verification and the work around it; the closing keyframe
     alone), GBA and final GBA.  (Its profiled replay of the first
     closure, ~79 s, was cut for the script's time; its readings, the host
     waits of one closure, stay in PERF.md.)
 11. stereo async: phase 5's cell with SystemConfig(async_mapping=True),
     free-running and in lockstep (the worker's queue joined after every
     frame).  Bars: 0 LOST, the worker processed every keyframe (map
     version > keyframes), free-running ATE < 0.02 m, lockstep ATE <= 1.1 x
     phase 5's + 5e-4 m; B1 and B2 once a frame, B3 and B4 at all.  Prints
     the track ms (median, p99) with mapping behind it beside phase 5's.
 12. stereo_vio: the row of evaluate_ntimes.py at 752x480, 1200 features,
     8 levels (the blackout world without the blackout, 60 frames) through
     a VioFrontend fed 200 Hz IMU with the row's biases and noise (IMU seed
     100), init_min_kfs 10, init_min_span 3 s, a LoopCloser attached.  Bars:
     VI initialized, |g| within 0.05 of 9.81, bg within 1.2e-2 of the truth,
     0 LOST, keyframe ATE < 0.02 m, B1-B4 launched, and the fused solve
     and a frame's preintegration replayed from their CUDA graphs equal to
     their plain calls on the same inputs.  Prints the init frame, the ms
     of preintegration, fused solve and whole frame, and the device ops of
     a fused frame (frame 53 under torch.profiler; its ~90000 events take
     the profiler ~15 s to sum) against phase 8's.
 13. vio_blackout: the same with frames 36-47 black.  Bars: 0 LOST, the
     black frames ODOMOK, 0 relocalizations, OK from frame 50 on, keyframe
     ATE after the recovery < 0.02 m.
 14. vio_loop: the stereo_loop world with the IMU, its first 270 frames
     (one and a half laps of the row's two: the first closure comes near
     frame 180; cut for the script's time).
     Bars: 0 LOST, the final VI init reached, the PRV window BA run, one
     loop closed, fused points > 0, keyframe ATE after the final GBA < 0.02
     m, the window BA's chain blocks replayed from their CUDA graphs equal
     to their plain calls.  Prints the keyframe ATE around the closure and
     the ms of the VIO local BA, the init GBA and loop closing.
 15. stereo_vio async: phase 12's row over SystemConfig(async_mapping=True),
     free-running, with the VI init final after 4 s of keyframes, so that
     the PRV window BA runs on the mapping worker while this thread tracks
     and times its frames with device-wide syncs; the worker's new graph
     layouts are captured on this thread (utils/cuda_graph.py).  Bars: 0
     LOST, final init, the window BA run on the worker only, at least one
     chain-block graph replayed there, |g| and bg as phase 12,
     keyframe ATE < 0.02 m, B1-B4 launched, and every graph of the run
     (fused solve, each preintegration length, each chain-block layout)
     equal to its plain call on the same inputs.
 16. multicam_kb8: the row's KB8 rig of 2 cameras (fx 400, principal point
     at the centre, dist 0.02, 0.002, -0.001, 0.0005, the partner 0.2 m to
     the side), first parsed from a TUM-VI-style YAML by the port's
     io.config and checked equal to the row's rig, 60 frames at 752x480,
     1200 features, 8 levels through build_multicam_frame (return_stats)
     in the blackout world without the blackout.  Bars: 0 LOST, keyframe ATE
     < 0.02 m, view-1 triangulations on every frame, B1 and B2 exactly once
     a frame, B3 at least once a frame, B4 launched.  Prints the
     triangulations a frame and mean_err2 by view beside the row's.
 17. multicam4_kb8: two such pairs, the second 0.1 m below (32 (level,
     image) entries in one B1 and one B2 launch): the bars of phase 16, B3
     at least 3 times a frame.  Then B1 and B2 over the 32 entries and B3
     under each pair's epipolar mask against their plain versions.
 18. veo_blackout: the stereo row through an EncoderFrontend fed 100 Hz
     wheel speeds (half track 0.28 m, noise 2e-3, seed 200), frames 36-47
     black.  Bars: fused on every OK frame from the second on, the black
     frames ODOMOK, 0 LOST, 0 relocalizations, keyframe ATE after the
     recovery < 0.02 m, the fused solve's graph equal to its plain call.
     Prints the ms of a prediction and of a fused solve.
 19. vieo: phase 12's row with VioConfig(use_encoder=True) and the row's
     encoder.  Bars: those of phase 12.
 20. map_reuse: stereo; at frame 36 the map is saved, a fresh System and
     LoopCloser load it and the run goes on.  Bars: a relocalization
     within the first 3 frames after the load, never LOST after it,
     keyframe ATE after it < 0.02 m, B3 and B4 launched inside the
     relocalization.  Prints the ms of save_map and load_map.
 Phases 16-20 are `rig_encoder_reuse_phases`, and each zeroes the launch
 counters before its run and reads them after.
 21. distributed GBA (`distributed_gba_phase`), the landmark-sharded global
     BA of parallel/dist_ba.py.  (a) Phase 10's map, saved
     with System.save_map and loaded into fresh Systems, each GBA with the
     final GBA's stages (10, 15) and timed: run_global_ba over a mesh of 4
     shards on the card, the single-device branch (twice: the order of
     index_add_'s atomic sums changes from run to run; the spread is
     printed) and the distributed algorithm over one shard.  Bars, 4
     shards against one shard: keyframe poses within 1e-4 rad and 1e-4 m,
     landmarks within 0.1 px in their observations, keyframe ATEs within
     1e-4 m; against the single-device branch (which alone carries its
     chi2 classification into the second stage, as in the JAX package):
     keyframe ATEs within 1e-4 m; ATE under 0.02 m.  Then both branches in
     one stage of 25 iterations, where they run the same algorithm: poses
     within 1e-4 rad and 1e-4 m, landmarks within 0.1 px.  Then one damped
     Schur step over 4 shards and on one device on the map with every
     keyframe but the first moved by 1 cm, within the same pose and pixel
     bars.
     (b) distributed_ba on the multi-host harness's problem (K 32, M 32768,
     O 8, 10 LM iterations) over 1, 2 and 4 shards on the card: poses
     within 1e-4 of one shard's, the cost lower than at the start; the ms
     per LM iteration from CUDA events after a warm-up (shards on one card
     share its SMs: the cost of sharding, not a scale-out).  (c)
     dryrun_multichip over 4 mesh entries (4 x cuda:0 on one card):
     extraction (B1, B2) bit-exact and matching (B4) identical against one
     device, its BA step within 1e-4 (landmarks 1e-3 m); counters zeroed
     before and read after: B1, B2 and B4 launched.  (d) (a)'s problem over
     a one-rank NCCL process group (parallel/multiprocess.py, the only
     NCCL world one card allows): poses within 1e-4 of (a)'s one shard.
     Last, the cost of the kernel wrappers' device guard (cuda_build.
     on_device) a launch, and over the launches the run counted.
 22. supporting code (`supporting_code_phase`).  (a) A EuRoC mav0/ folder
     of 40 stereo frames at 752x480 and 20 Hz (the stereo_blackout row's
     world and circle, fx 458.654, a 0.11 m baseline; PNGs written by
     io/png, 200 Hz IMU, ground truth) and a EuRoC-style settings file
     (1200 features, 8 levels), run through examples/run_euroc.main on
     the card with frames 30-32 inside utils/metrics.trace.  Bars: 0 LOST,
     40 trajectory lines, ATE against the ground truth < 0.02 m, B1-B4
     among the trace's CUDA kernels, B1 and B2 once a frame, and
     System.shutdown(print_report=True)'s table with its frame and track
     rows.  Prints the median ms of a frame.  (b) The stereo_lem row of
     examples/evaluate_ntimes.py at its own size (640x480, 600 features,
     4 levels, the first 180 frames of the figure-eight: one lap of the
     row's two, cut for the script's time), seed 11, with a
     viz.Viewer(every_n_kf=5) polling.  Bars: keyframe ATE after the final
     GBA finite and < 0.05 m, a viewer PNG read back with drawn pixels.
     Prints the row's numbers beside ACCURACY_r05.json's means (of the
     two-lap row).  (c)
     extract_orb_batch of phase 5's stereo pair under ORB_BATCHED_SELECT
     off, on and concat: equal in every field; the median ms of each.
     (d) mutual_filter on the card equal to the CPU.  (e) entry(): the
     frontend step's outputs finite, B1 and B2 once, B3 and B4 launched.
 23. the RANSAC draws (`draw_parity_phase`).  (a) utils/prng's
     categorical, the JAX package's draw, on the card against the same
     call on the CPU at the solvers' full-width shapes (two-view init
     (256, 8, 1000), 3D-3D PnP (1024, 3, 512), DLT PnP (2048, 6, 512),
     Sim3 (128, 3, 512), an all-invalid mask): equal in every index.  (b)
     The first 60 frames of the mono_loop row at its own size (640x480,
     1000 features, 4 levels), noise seed 11, on the card.  Bars: the
     first OK frame is the JAX package's (JAX_MONO_LOOP_INIT_FRAME), no
     frame is LOST and the scale-aligned keyframe ATE RMSE stays under
     0.02 m.  Prints its seconds.

 24. extraction bits (`extraction_bits_phase`): the stereo_loop row at
     noise seed 0, 752x480, frames 0-5 rendered in turn; the card's
     extract_orb of the left images of frames 0, 1 and 5 must equal the
     JAX package's features of its keyframe slots 0-2
     (tests/data/stereo_loop_752_seed0_closure.npz: uv, level, descriptor
     and valid, byte for byte), through the ops/xla_f32 kernels (counters
     zeroed before).  Then the card's pyramid of frame 0, the moments and
     angles of 4000 random patches, and atan2 / sin / cos of the inputs in
     tests/data/xla_f32_libm.npz, each equal to the CPU build's bits.

Stdout ends with three lines: the kernels JSON, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3
# bandwidth, and the f32 rate outside the tensor cores.  None of the five
# kernels uses the tensor cores; their 32-bit integer ops are counted
# against the same 67 T/s, which the card's int32 rate does not exceed.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

BASELINE = 0.2
WORLD = dict(n_landmarks=1800, seed=3, extent=(6.0, 4.5, 3.0))
# The world, rotation rate and photometric hardening of the monocular row
# of examples/evaluate_ntimes.py.
MONO_WORLD = dict(n_landmarks=2200, seed=4, extent=(6.0, 4.5, 3.0))
MONO_OMEGA = 0.35
# Noise seeds of the stereo blackout phase: 0, and 11, the first run of
# each row in evaluate_ntimes.py (seed0 + 7 * run), comparable with its
# rows.  Seed 0 is the harder of the two at full width (§6 of PERF.md):
# its closure raises the keyframe ATE and its recovered map keeps an
# offset.  The stereo loop phase runs seed 0 alone (a seed-11 run and its
# profiled closure took ~200 s of the script's time on the H100); the
# host waits of a relocalization are profiled at seed 0 alone (the counts
# repeat across seeds).
PLACE_SEEDS = (0, 11)
LOOP_SEED = PLACE_SEEDS[0]
# Phase 14's frames of the vio_loop row (one and a half laps; the row's
# 360 took ~236 s of the script's time on the H100).
VIO_LOOP_FRAMES = 270
# Phase 15's final-acceptance span of the VI init (the rows' 15 s needs
# more frames than the 60 of stereo_vio): past it the PRV window BA runs.
VIO_ASYNC_FINAL_SPAN = 4.0
# Phase 7's sequence through the JAX package with its own draws: the
# two-view init comes on frame 3 (64 good points of 263 matches), the track
# is LOST from frame 40 on, and the OK frames' scale-aligned ATE RMSE is
# 0.22862 m (`python3 scripts/row_parity.py --row smoke_mono --seed 0
# --device cpu`, x64 off; the port on the CPU gives the same states).
JAX_MONO_KNOWN = (3, 40, 0.22862)
# Phase 7's tolerance against JAX_MONO_KNOWN, scripts/vio_rows.py's for a
# row's ATE and LOST count.
MONO_KNOWN_TOL = 0.3
# Phase 23: the JAX package's mono_loop row at noise seed 11 is OK from
# frame 1 (its two-view init on frames 0 and 1) and not LOST in its first
# 60 frames, keyframe ATE RMSE 0.0036117 m (`python3 scripts/row_parity.py
# --row mono_loop --seed 11 --frames 60 --sides jax`, on the CPU with x64
# off).
MONO_LOOP_SEED = 11
MONO_LOOP_FRAMES = 60
JAX_MONO_LOOP_INIT_FRAME = 1
# Phases 9 and 10 against the JAX package's runs of the same rows at the
# same size (752x480, 1200 features, 8 levels), which ACCURACY_fullwidth.json
# holds (`python3 scripts/row_parity.py --row stereo_blackout --seed 0,11
# --width 752 --features 1200 --levels 8 --sides jax --out ...` and the
# same for --row stereo_loop --seed 0, on the CPU with x64 off).  A count
# or an ATE agrees within 30 % of the JAX package's, or within one (a
# count) or 1 mm (an ATE) where that is more: scripts/vio_rows.py's row
# bounds.  The loop row's first closure is the same pair of keyframes.
FULLWIDTH_REF = "ACCURACY_fullwidth.json"
REF_REL_TOL = 0.3
# Phase 24: the JAX package's state at its seed-0 closure of the loop row
# (752x480), whose keyframe slots 0-2 are frames KF_FRAMES, and the CPU
# build's atan2 / sin / cos of fixed inputs (scripts/xla_order.py
# --save-libm).
CLOSURE_STATE = "tests/data/stereo_loop_752_seed0_closure.npz"
KF_FRAMES = (0, 1, 5)
LIBM_REF = "tests/data/xla_f32_libm.npz"


_T0 = time.perf_counter()


def log(msg):
    """A line of the report, with the seconds since the script started."""
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def fullwidth_reference():
    """The JAX package's full-width runs (ACCURACY_fullwidth.json): a
    function of (row, seed) that returns its numbers and closures."""
    path = ROOT / FULLWIDTH_REF
    if not path.is_file():
        fail(f"{path} is missing")
    ref = json.loads(path.read_text())
    size = [ref["meta"][k] for k in ("width", "features", "levels")]
    if size != [752, 1200, 8]:
        fail(f"{FULLWIDTH_REF} holds another size: {size}")

    def run(row, seed):
        try:
            return ref["scenarios"][row]["seeds"][str(seed)]["jax_cpu"]
        except KeyError:
            fail(f"{FULLWIDTH_REF} holds no JAX run of {row} at seed {seed}")
    return run


def near(value, want, floor):
    """`value` within REF_REL_TOL of `want`, or within `floor` where that
    is more."""
    return abs(value - want) <= max(REF_REL_TOL * abs(want), floor)


def nvidia_smi():
    from vieo_slam_tpu_torch.utils import device

    try:
        return device.nvidia_smi()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        fail(str(e))


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps=30, warmup=3):
    """Median ms of fn() over warm runs, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def device_ms(torch, fn, kernel, reps=10):
    """ms per fn() call that the card spends inside the CUDA kernels whose
    name contains `kernel`, read from torch.profiler (time_ms brackets the
    wrapper's host work as well); None where the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us else None


def aten_ops(torch, fn):
    """{PyTorch operator: calls} that one fn() calls on the host (what a
    wrapper does around its launch), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("aten::")}


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# FAST-9/16 at two thresholds + 3x3 NMS + blend, counted for the least
# implementation, whose work follows the data (b1_work counts it):
#  - every pixel: the compass reject (any 9 consecutive circle positions
#    hold two of the taps 0, 4, 8, 12) -- 4 differences, 8 comparisons, 6
#    adds, 2 comparisons and an or;
#  - every pixel that passes it: the other 12 differences and, per
#    threshold, 32 comparisons, 32 ops packing them into two 16-bit masks
#    and 24 for the two 9-run tests by doubling;
#  - every corner, per threshold: 96 for the exceedance sums (sub, max, add
#    per tap and sign), their max, 8 max + compare + select for the NMS,
#    and compare + add + select for the blend.
B1_REJECT_OPS = 4 + 8 + 6 + 2 + 1
B1_TEST_OPS = 12 + 2 * (32 + 32 + 24)
B1_SCORE_OPS = 96 + 1 + 10 + 3
# Per candidate pair of the Hamming best-2: 8 XOR, 8 popcount, 7 adds,
# the row best/second update (3) and the column minimum (1).
HAMMING_OPS = 27
# Per pair of the projection window + level gate: 2 sub, 2 mul, add,
# compare, level sub + abs + compare, 2 ands.
WINDOW_OPS = 11
# Per keypoint of the tail: two moments over the 709 disc pixels (multiply
# and add each); the separable 7-tap blur, 7 multiplies and 6 adds for each
# of the 53x47 row outputs and 47x47 column outputs; per BRIEF pair two
# rotated points (4 multiplies, 2 adds, 2 roundings each) and the compare.
TAIL_OPS_PER_KP = 4 * 709 + 13 * (53 * 47 + 47 * 47) + 256 * 17


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def scene(n_frames, width, world_cfg=None, omega=0.25):
    """The test_image_e2e world (or `world_cfg`) and an outward circle at
    `omega` rad/s, with a pinhole camera of the given width (focal length
    scaled with it, height 480)."""
    from vieo_slam_tpu_torch.cameras import models as cm
    from vieo_slam_tpu_torch.sim import world as sim

    s = width / 640.0
    cam = cm.make_pinhole(400.0 * s, 400.0 * s, width / 2.0, 240.0, width,
                          480)
    world = sim.SyntheticWorld(sim.WorldConfig(**(world_cfg or WORLD)))
    ts = np.arange(n_frames) * 0.1
    Rwc, twc, _, _ = sim.circle_trajectory(ts, radius=1.0, omega=omega,
                                     look_outward=True)
    Rcw, tcw = sim.trajectory_to_tcw(Rwc, twc)
    return cam, cam.fx * BASELINE, world, ts, Rcw, tcw, twc


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def b1_work(torch, levels, th_hi, th_lo):
    """(pixels, pixels that pass the compass reject at the lower threshold,
    corners summed over the two thresholds) of a list of images: what the
    operations of B1 follow."""
    import torch.nn.functional as F

    from vieo_slam_tpu_torch.ops import cuda_fast

    px = survivors = corners = 0
    th = min(th_hi, th_lo)
    for im in levels:
        h, w = im.shape
        p = F.pad(im[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
        d = torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - im
                         for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))])
        keep = ((d > th).sum(0) >= 2) | ((d < -th).sum(0) >= 2)
        px += im.numel()
        survivors += int(keep.sum())
        corners += sum(int((s > 0).sum()) for s in
                       cuda_fast.fast_score_maps(im, (th_hi, th_lo)))
    return px, survivors, corners


def tail_centers(torch, levels, cfg, th):
    """The tail's centers for a list of level images (the levels of one
    image or of several, in order): the keypoints selected on each level,
    the first four moved onto the image border."""
    from vieo_slam_tpu_torch.ops import cuda_fast, orb

    out = []
    for i, im in enumerate(levels):
        n_l = int(cfg.features_per_level[i % cfg.n_levels])
        uv, _, _ = orb.select_keypoints(cuda_fast.fast_nms_blend(im, *th),
                                        n_l, cfg)
        h, w = im.shape
        uv = uv.clone()
        uv[:4] = torch.tensor([[0, 0], [w - 1, h - 1], [3, h - 1],
                               [w - 1, 2]], dtype=uv.dtype, device=im.device)
        out.append(uv.contiguous())
    return out


def nearest_grid(torch, img, centers, r):
    """[1, N * d, d, 2] sampling grid of the d x d windows around the
    clamped centers, normalized for align_corners=True: with
    F.grid_sample(mode="nearest", padding_mode="border") it gathers what
    B2 gathers (B2's library yardstick)."""
    H, W = img.shape
    d = 2 * r + 1
    off = torch.arange(-r, r + 1, device=img.device)
    x = centers[:, 0].long().clamp(0, W - 1)[:, None, None] + off
    y = centers[:, 1].long().clamp(0, H - 1)[:, None, None] + off[:, None]
    xn = 2 * x.float() / (W - 1) - 1
    yn = 2 * y.float() / (H - 1) - 1
    grid = torch.stack(torch.broadcast_tensors(xn, yn), -1)
    return grid.reshape(1, -1, d, 2)


def check_kernels(torch, dev):
    from vieo_slam_tpu_torch.ops import cuda_build, cuda_fast, cuda_gather
    from vieo_slam_tpu_torch.ops import cuda_matching, cuda_tail, matching, orb

    cam, bf, world, ts, Rcw, tcw, _ = scene(1, 752)
    cfg = orb.OrbConfig(n_features=1200, n_levels=8)
    left, right = world.render_stereo(cam, Rcw[0], tcw[0], BASELINE)
    img = torch.from_numpy(left).to(dev)
    pyramid = orb.build_pyramid(img, cfg)
    rows = {}

    # B1: FAST + NMS + blend at the 8 level shapes of one image, and of
    # the stereo pair (16 maps), each in one launch; and the lists of the
    # known and mono cells (4 levels of 640x480, one image and a pair).
    th = (cfg.fast_threshold, cfg.fast_min_threshold)
    pair = pyramid + orb.build_pyramid(torch.from_numpy(right).to(dev), cfg)
    cam4, _, _, _, Rcw4, tcw4, _ = scene(1, 640)
    cfg4 = orb.OrbConfig(n_features=600, n_levels=4)
    pair4 = [lv for x in world.render_stereo(cam4, Rcw4[0], tcw4[0], BASELINE)
             for lv in orb.build_pyramid(torch.from_numpy(x).to(dev), cfg4)]
    err = 0.0
    for levels in (pyramid, pair, pair4[:4], pair4):
        n0 = cuda_build.LAUNCHES["fast_nms_blend"]
        got = cuda_fast.fast_nms_blend_multi(levels, *th)
        if cuda_build.LAUNCHES["fast_nms_blend"] != n0 + 1:
            fail(f"B1 took more than one launch for {len(levels)} levels")
        want = cuda_fast.fast_nms_blend_multi_plain(levels, *th)
        for im, g, w in zip(levels, got, want):
            if not torch.equal(g, w):
                fail(f"B1 differs from its plain version at "
                     f"{tuple(im.shape)} of {len(levels)} levels in "
                     f"{int((g != w).sum())} pixels")
            err = max(err, float((g - w).abs().max()))
    px, survivors, corners = b1_work(torch, pyramid, *th)
    rows["fast_nms_blend"] = dict(
        device_ms=device_ms(torch, lambda: cuda_fast.fast_nms_blend_multi(
            pyramid, *th), "fast_nms_blend_kernel"),
        ms=time_ms(torch, lambda: cuda_fast.fast_nms_blend_multi(pyramid,
                                                                 *th)),
        pair_device_ms=device_ms(
            torch, lambda: cuda_fast.fast_nms_blend_multi(pair, *th),
            "fast_nms_blend_kernel"),
        pair_ms=time_ms(torch, lambda: cuda_fast.fast_nms_blend_multi(pair,
                                                                      *th)),
        aten_ops=aten_ops(torch, lambda: cuda_fast.fast_nms_blend_multi(
            pair, *th)),
        plain_ms=time_ms(torch, lambda: cuda_fast.fast_nms_blend_multi_plain(
            pyramid, *th), reps=10),
        max_abs_err=err,
        bound=bound(8 * px, B1_REJECT_OPS * px + B1_TEST_OPS * survivors
                    + B1_SCORE_OPS * corners),
        shapes=[tuple(im.shape) for im in pyramid], survivors=survivors,
        corners=corners)

    # B2: 53x53 tail patches around each image's selected keypoints (1200
    # an image), the first four of every level moved onto the image
    # border; the 8 levels of one image and the 16 of the stereo pair in
    # one launch each, and the 4-level lists of the known and mono cells.
    centers = tail_centers(torch, pyramid, cfg, th)
    pair_centers = centers + tail_centers(torch, pair[len(pyramid):], cfg, th)
    r, d = orb._TAIL_R, 2 * orb._TAIL_R + 1
    for levels, cs in ((pyramid, centers), (pair, pair_centers),
                       (pair4[:4], tail_centers(torch, pair4[:4], cfg4, th)),
                       (pair4, tail_centers(torch, pair4, cfg4, th))):
        n0 = cuda_build.LAUNCHES["gather_patches"]
        got = cuda_gather.gather_patches_multi(levels, cs, r)
        if cuda_build.LAUNCHES["gather_patches"] != n0 + 1:
            fail(f"B2 took more than one launch for {len(levels)} levels")
        want = cuda_gather.gather_patches_multi_plain(levels, cs, r)
        for im, g, w in zip(levels, got, want):
            if not torch.equal(g, w):
                fail(f"B2 differs from its plain version at "
                     f"{tuple(im.shape)} of {len(levels)} levels")
    # The library yardstick: one grid_sample a level, grids built before.
    import torch.nn.functional as F

    grids = [nearest_grid(torch, im, c, r) for im, c in zip(pyramid, centers)]

    def library():
        return [F.grid_sample(im[None, None], g, mode="nearest",
                              padding_mode="border", align_corners=True)
                for im, g in zip(pyramid, grids)]

    library_equal = all(torch.equal(o.reshape(-1, d, d), w) for o, w in zip(
        library(), cuda_gather.gather_patches_multi_plain(pyramid, centers,
                                                          r)))
    n_kp = sum(int(c.shape[0]) for c in centers)
    rows["gather_patches"] = dict(
        device_ms=device_ms(torch, lambda: cuda_gather.gather_patches_multi(
            pyramid, centers, r), "gather_patches_kernel"),
        ms=time_ms(torch, lambda: cuda_gather.gather_patches_multi(
            pyramid, centers, r)),
        pair_device_ms=device_ms(
            torch, lambda: cuda_gather.gather_patches_multi(
                pair, pair_centers, r), "gather_patches_kernel"),
        pair_ms=time_ms(torch, lambda: cuda_gather.gather_patches_multi(
            pair, pair_centers, r)),
        library_ms=time_ms(torch, library) if library_equal else None,
        library_equal=library_equal,
        plain_ms=time_ms(torch, lambda: cuda_gather.gather_patches_multi_plain(
            pyramid, centers, r), reps=10),
        max_abs_err=0.0,
        bound=bound(4 * px + 8 * n_kp + 4 * n_kp * d * d, 0),
        shapes=[n_kp, d, d])

    # B3: the stereo search of this frame (1200 x 1200, stereo mask).
    fl = orb.extract_orb(img, cfg, device=dev)
    fr = orb.extract_orb(torch.from_numpy(right).to(dev), cfg, device=dev)
    mask = matching.stereo_candidate_mask(
        fl.uv, fl.level, fl.valid, fr.uv, fr.level, fr.valid,
        min_disp=bf / 15.0, max_disp=bf / 0.3,
        level_scales=cfg.level_scales.astype(np.float32)).contiguous()
    M, N = mask.shape
    got = cuda_matching.fused_best2(fl.desc, fr.desc, mask)
    want = cuda_matching.fused_best2_plain(fl.desc, fr.desc, mask)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    if err:
        fail(f"B3 differs from its plain version (max |diff| {err})")
    cand = int(mask.sum())
    rows["fused_best2"] = dict(
        device_ms=device_ms(torch, lambda: cuda_matching.fused_best2(
            fl.desc, fr.desc, mask), "best2_"),
        ms=time_ms(torch, lambda: cuda_matching.fused_best2(
            fl.desc, fr.desc, mask)),
        plain_ms=time_ms(torch, lambda: cuda_matching.fused_best2_plain(
            fl.desc, fr.desc, mask), reps=10),
        max_abs_err=float(err),
        bound=bound(32 * (M + N) + M * N + 4 * (3 * M + N),
                    M * N + HAMMING_OPS * cand),
        shapes=[M, N], candidates=cand)

    # B4: a 4096-landmark tracking slab against the left image's 1200
    # keypoints: ~1000 slab rows are the keypoints' own positions and
    # descriptors, perturbed; the rest project elsewhere or are invalid.
    g = torch.Generator(device="cpu").manual_seed(0)
    LC = 4096
    src = torch.randint(0, N, (LC,), generator=g).to(dev)
    proj_uv = fl.uv[src] + 4.0 * torch.randn(LC, 2, generator=g).to(dev)
    proj_uv[1000:] = torch.rand(LC - 1000, 2, generator=g).to(dev) \
        * torch.tensor([752.0, 480.0], device=dev)
    flips = torch.randint(0, 2, (LC, 8), generator=g, dtype=torch.int32)
    proj_desc = (fl.desc[src] ^ (flips.to(dev) << 5)).contiguous()
    proj_level = fl.level[src]
    proj_valid = torch.arange(LC, device=dev) < 3000
    scales = torch.from_numpy(cfg.level_scales.astype(np.float32)).to(dev)
    radius = 15.0 * scales[proj_level.long()]
    args = (proj_desc, fl.desc, proj_uv, radius, proj_level, proj_valid,
            fl.uv, fl.level, fl.valid, 8)
    got = cuda_matching.fused_projection_best2(*args)
    want = cuda_matching.fused_projection_best2_plain(*args)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    if err:
        fail(f"B4 differs from its plain version (max |diff| {err})")
    cand = int(cuda_matching.projection_mask(*args[2:]).sum())
    rows["fused_projection_best2"] = dict(
        device_ms=device_ms(torch, lambda: cuda_matching.
                            fused_projection_best2(*args), "best2_"),
        ms=time_ms(torch, lambda: cuda_matching.fused_projection_best2(
            *args)),
        aten_ops=aten_ops(torch, lambda: cuda_matching.
                          fused_projection_best2(*args)),
        plain_ms=time_ms(torch, lambda: cuda_matching.
                         fused_projection_best2_plain(*args), reps=10),
        max_abs_err=float(err),
        bound=bound(32 * (LC + N) + 20 * LC + 16 * N + 4 * (3 * LC + N),
                    WINDOW_OPS * LC * N + HAMMING_OPS * cand),
        shapes=[LC, N], candidates=cand)

    # B5: the whole tail of this image in one launch -- the 8 levels and
    # the 1200 centers B2 was given above (selected keypoints, four of
    # every level moved onto the image border).
    got = cuda_tail.tail_fused_multi(pyramid, centers)
    want = cuda_tail.tail_fused_multi_plain(pyramid, centers)
    ang_err, flips = 0.0, 0
    for (ang, desc), (ang_p, desc_p) in zip(got, want):
        ang_err = max(ang_err, float((ang - ang_p).abs().max()))
        x = (desc ^ desc_p).cpu().numpy().view(np.uint8)
        flips += int(np.unpackbits(x).sum())
    if ang_err > 1e-6 or flips:
        fail(f"B5 differs from its plain version: max angle difference "
             f"{ang_err:.3g} rad (bound 1e-6), {flips} of {n_kp * 256} "
             f"descriptor bits (bound 0)")
    # The path B5 replaces: one launch of B2 and the PyTorch tail.
    replaced_ms = time_ms(torch, lambda: orb.extract_tail_fused_multi(
        pyramid, centers), reps=10)
    rows["tail_fused"] = dict(
        device_ms=device_ms(torch, lambda: cuda_tail.tail_fused_multi(
            pyramid, centers), "tail_fused_kernel"),
        ms=time_ms(torch, lambda: cuda_tail.tail_fused_multi(pyramid,
                                                             centers)),
        plain_ms=time_ms(torch, lambda: cuda_tail.tail_fused_multi_plain(
            pyramid, centers), reps=10),
        max_abs_err=ang_err, replaced_ms=replaced_ms, bit_flips=flips,
        bound=bound(4 * px + 8 * n_kp + 16 * 256 + 36 * n_kp,
                    TAIL_OPS_PER_KP * n_kp),
        shapes=[n_kp, [tuple(im.shape) for im in pyramid]])
    return rows


def check_place_cases(torch, dev):
    """B3 and B4 against their plain versions at the shapes of the
    place-recognition path, on the full-width frame of phase 3: the
    relocalization match (the left image's 1200 keypoints against the
    right's, octave gate |level difference| <= 1), the harvest (2048
    projected points at radius 10, level tolerance 8, predicted level 0),
    and both on all-invalid inputs (a blacked-out frame).  Returns
    {case: {ms, matched}}."""
    from vieo_slam_tpu_torch.ops import cuda_matching, orb

    cam, _, world, _, Rcw, tcw, _ = scene(1, 752)
    cfg = orb.OrbConfig(n_features=1200, n_levels=8)
    left, right = world.render_stereo(cam, Rcw[0], tcw[0], BASELINE)
    fl = orb.extract_orb(torch.from_numpy(left).to(dev), cfg, device=dev)
    fr = orb.extract_orb(torch.from_numpy(right).to(dev), cfg, device=dev)
    N = fl.desc.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1)
    scales = torch.from_numpy(cfg.level_scales.astype(np.float32)).to(dev)
    reloc_mask = (fl.valid[:, None] & fr.valid[None, :]
                  & ((fl.level[:, None] - fr.level[None, :]).abs() <= 1))
    HC = 2048
    h_src = torch.randint(0, N, (HC,), generator=g).to(dev)
    h_uv = fl.uv[h_src] + 3.0 * torch.randn(HC, 2, generator=g).to(dev)
    h_uv[1200:] = torch.rand(HC - 1200, 2, generator=g).to(dev) \
        * torch.tensor([752.0, 480.0], device=dev)
    h_desc = (fl.desc[h_src] ^ (torch.randint(0, 2, (HC, 8), generator=g,
                                              dtype=torch.int32).to(dev)
                                << 9)).contiguous()
    h_level = torch.zeros(HC, dtype=torch.int32, device=dev)
    h_valid = torch.arange(HC, device=dev) < 1800
    h_radius = 10.0 * scales[h_level.long()]
    harvest = (h_desc, fl.desc, h_uv, h_radius, h_level, h_valid, fl.uv,
               fl.level, fl.valid, 8)
    b3 = (cuda_matching.fused_best2, cuda_matching.fused_best2_plain)
    b4 = (cuda_matching.fused_projection_best2,
          cuda_matching.fused_projection_best2_plain)
    cases = {
        "B3 reloc 1200x1200 octave mask": (
            *b3, (fl.desc, fr.desc, reloc_mask.contiguous())),
        "B3 all-invalid": (
            *b3, (fl.desc, fr.desc, torch.zeros_like(reloc_mask))),
        "B4 harvest 2048x1200": (*b4, harvest),
        "B4 all-invalid rows": (
            *b4, harvest[:5] + (torch.zeros_like(h_valid),) + harvest[6:]),
        "B4 all-invalid keypoints": (
            *b4, harvest[:8] + (torch.zeros_like(fl.valid), 8)),
    }
    out = {}
    for case, (fn, plain, a) in cases.items():
        got, want = fn(*a), plain(*a)
        err = max(int((x.long() - y.long()).abs().max()) for x, y in
                  zip(got, want))
        if err:
            fail(f"{case}: differs from its plain version (max |diff| "
                 f"{err})")
        out[case] = dict(ms=time_ms(torch, lambda: fn(*a)),
                         matched=int((got[1] < cuda_matching.INF).sum()))
    return out


def check_rig_kernels(torch, dev, rig, images, cfg):
    """B1 and B2 over every level of every rig image in one launch each
    (32 entries for 4 cameras at 8 levels) and B3 under the epipolar mask
    of each cam0 <-> cam_i pair, against their plain versions, on one
    multicam frame's images.  Returns {case: {ms, device_ms, plain_ms,
    bound, ...}}, the bounds counted as phase 3 counts them."""
    from vieo_slam_tpu_torch.cameras import models as cm
    from vieo_slam_tpu_torch.frontend.frame import epipolar_mask
    from vieo_slam_tpu_torch.ops import (cuda_build, cuda_fast, cuda_gather,
                                         cuda_matching, orb)

    imgs = [torch.from_numpy(x).to(dev) for x in images]
    pyramids = [orb.build_pyramid(im, cfg) for im in imgs]
    levels = [lv for p in pyramids for lv in p]
    th = (cfg.fast_threshold, cfg.fast_min_threshold)
    n = len(levels)
    out = {}
    n0 = cuda_build.LAUNCHES["fast_nms_blend"]
    got = cuda_fast.fast_nms_blend_multi(levels, *th)
    if cuda_build.LAUNCHES["fast_nms_blend"] != n0 + 1:
        fail(f"B1 took more than one launch for {n} rig levels")
    for g, w in zip(got, cuda_fast.fast_nms_blend_multi_plain(levels, *th)):
        if not torch.equal(g, w):
            fail(f"B1 differs from its plain version over {n} rig levels")
    px, survivors, corners = b1_work(torch, levels, *th)
    out[f"B1 {n} entries"] = dict(
        ms=time_ms(torch, lambda: cuda_fast.fast_nms_blend_multi(levels,
                                                                 *th)),
        device_ms=device_ms(torch, lambda: cuda_fast.fast_nms_blend_multi(
            levels, *th), "fast_nms_blend_kernel"),
        plain_ms=time_ms(torch, lambda: cuda_fast.fast_nms_blend_multi_plain(
            levels, *th), reps=5),
        bound=bound(8 * px, B1_REJECT_OPS * px + B1_TEST_OPS * survivors
                    + B1_SCORE_OPS * corners))
    centers = [c for p in pyramids for c in tail_centers(torch, p, cfg, th)]
    r = orb._TAIL_R
    n0 = cuda_build.LAUNCHES["gather_patches"]
    got = cuda_gather.gather_patches_multi(levels, centers, r)
    if cuda_build.LAUNCHES["gather_patches"] != n0 + 1:
        fail(f"B2 took more than one launch for {n} rig levels")
    for g, w in zip(got, cuda_gather.gather_patches_multi_plain(
            levels, centers, r)):
        if not torch.equal(g, w):
            fail(f"B2 differs from its plain version over {n} rig levels")
    n_kp, d = sum(int(c.shape[0]) for c in centers), 2 * r + 1
    out[f"B2 {n} entries"] = dict(
        ms=time_ms(torch, lambda: cuda_gather.gather_patches_multi(
            levels, centers, r)),
        device_ms=device_ms(torch, lambda: cuda_gather.gather_patches_multi(
            levels, centers, r), "gather_patches_kernel"),
        plain_ms=time_ms(torch, lambda: cuda_gather.gather_patches_multi_plain(
            levels, centers, r), reps=5),
        bound=bound(4 * px + 8 * n_kp + 4 * n_kp * d * d, 0))
    f = orb.extract_orb_batch(torch.stack(imgs), cfg, device=dev)
    rays0 = cm.unproject(rig[0], f.uv[0])
    for i in range(1, len(rig)):
        mask = (f.valid[0][:, None] & f.valid[i][None, :]
                & epipolar_mask(rig[0], rig[i], rays0,
                                cm.unproject(rig[i], f.uv[i]), 0.01))
        a = (f.desc[0], f.desc[i], mask.contiguous())
        got = cuda_matching.fused_best2(*a)
        want = cuda_matching.fused_best2_plain(*a)
        err = max(int((x.long() - y.long()).abs().max()) for x, y in
                  zip(got, want))
        if err:
            fail(f"B3 under the epipolar mask of cam0-cam{i} differs from "
                 f"its plain version (max |diff| {err})")
        M, N, cand = a[0].shape[0], a[1].shape[0], int(mask.sum())
        out[f"B3 epipolar cam0-cam{i}"] = dict(
            ms=time_ms(torch, lambda: cuda_matching.fused_best2(*a)),
            device_ms=device_ms(torch, lambda: cuda_matching.fused_best2(*a),
                                "best2_"),
            plain_ms=time_ms(torch, lambda: cuda_matching.fused_best2_plain(
                *a), reps=5),
            bound=bound(32 * (M + N) + M * N + 4 * (3 * M + N),
                        M * N + HAMMING_OPS * cand),
            candidates=cand,
            matched=int((got[1] < cuda_matching.INF).sum()))
    return out


# ---------------------------------------------------------------------------
# Phases 4 to 10: end to end
# ---------------------------------------------------------------------------


def run_sequence(torch, dev, width, n_features, n_levels, n_frames,
                 slab=4096, profile_from=None, sensor="stereo",
                 world_cfg=None, omega=0.25, hardened=False,
                 async_mapping=False, lockstep=False):
    """build_*_frame of `sensor` (stereo, rgbd or mono) +
    System.track_frame over the sequence; returns the system, the states,
    per-frame stage times, the ATE (scale-aligned over the tracked frames
    for mono) and the inputs.  `hardened` renders with photometric noise
    and brightness drift.  With `async_mapping` the mapping worker runs
    behind tracking (its queue joined after each frame, outside the
    times, with `lockstep`), and the track time is the whole track_frame
    call.  With `profile_from`, the frames from that index on run under
    torch.profiler, which is returned last (with its wall seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.frontend import frame as fr
    from vieo_slam_tpu_torch.frontend.tracking import TrackerConfig
    from vieo_slam_tpu_torch.io.evaluate import ate
    from vieo_slam_tpu_torch.ops import orb
    from vieo_slam_tpu_torch.system import SensorMode, System, SystemConfig
    from vieo_slam_tpu_torch.utils.metrics import metrics

    cam, bf, world, ts, Rcw, tcw, twc = scene(n_frames, width, world_cfg,
                                              omega)
    cfg = orb.OrbConfig(n_features=n_features, n_levels=n_levels)
    rng = np.random.RandomState(0)
    images = []
    for i in range(n_frames):
        kw = {}
        if hardened:
            g, b = ev.gain_bias(float(ts[i]))
            kw = dict(noise_sigma=ev.NOISE_SIGMA, gain=g, bias=b, rng=rng)
        if sensor == "stereo":
            images.append(world.render_stereo(cam, Rcw[i], tcw[i], BASELINE,
                                              **kw))
        elif sensor == "rgbd":
            images.append(world.render_view(cam, Rcw[i], tcw[i],
                                            return_depth=True, **kw))
        else:
            images.append((world.render_view(cam, Rcw[i], tcw[i], **kw),))

    def build(i):
        on_dev = [torch.from_numpy(x).to(dev) for x in images[i]]
        t = float(ts[i])
        if sensor == "stereo":
            return fr.build_stereo_frame(
                *on_dev, cfg, bf=bf, min_depth=0.3, max_depth=15.0,
                timestamp=t, device=dev)
        if sensor == "rgbd":
            return fr.build_rgbd_frame(*on_dev, cfg, bf=bf, timestamp=t,
                                       device=dev)
        return fr.build_mono_frame(*on_dev, cfg, timestamp=t, device=dev)

    metrics.reset()
    mode = {"stereo": SensorMode.STEREO, "rgbd": SensorMode.RGBD,
            "mono": SensorMode.MONOCULAR}[sensor]
    system = System(cam, bf, SystemConfig(
        sensor=mode, tracker=TrackerConfig(use_predicted_scale=True,
                                           local_landmark_cap=slab),
        async_mapping=async_mapping), device=dev)
    states, times = [], []
    prof, prof_s = None, 0.0
    for i in range(n_frames):
        if i == profile_from:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("frame_build"):
            frame = build(i)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        lm0 = metrics.stages["local_mapping"].total
        with record_function("track_frame"):
            states.append(system.track_frame(frame))
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        lm = 0.0 if async_mapping \
            else metrics.stages["local_mapping"].total - lm0
        times.append((t1 - t0, t2 - t1 - lm, lm))
        if lockstep:
            system._kf_queue.join()
        if prof is not None:
            prof_s += t2 - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    system.wait_idle()
    traj = system.tracker.trajectory
    if sensor == "mono":        # no pose before the two-view initialization
        traj = [x for x in traj if x[3] == "OK"]
    poses = np.asarray([-(R.T @ t) for _, R, t, _ in traj])
    if not np.isfinite(poses).all():
        fail("non-finite poses")
    res = ate(np.asarray([x[0] for x in traj]), poses, ts, twc,
              with_scale=sensor == "mono")
    return system, states, times, res, (cam, bf, cfg, images), (prof, prof_s)


def split_frame_build(torch, dev, cam, bf, cfg, images):
    """Median ms of the two extractions and of the stereo search of a
    frame, each stage synchronized (run after the counted pass)."""
    from vieo_slam_tpu_torch.ops import matching, orb

    ext, ste = [], []
    for left, right in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl = orb.extract_orb(torch.from_numpy(left).to(dev), cfg, device=dev)
        fr = orb.extract_orb(torch.from_numpy(right).to(dev), cfg,
                             device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        matching.search_stereo_rectified(
            fl.uv, fl.level, fl.desc, fl.valid, fr.uv, fr.level, fr.desc,
            fr.valid, min_disp=bf / 15.0, max_disp=bf / 0.3,
            level_scales=cfg.level_scales.astype(np.float32))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ext.append(t1 - t0)
        ste.append(t2 - t1)
    return 1e3 * float(np.median(ext)), 1e3 * float(np.median(ste))


def with_tail_kernel(mode, fn):
    """fn() with ops.orb.TAIL_KERNEL_MODE set to `mode`."""
    from vieo_slam_tpu_torch.ops import orb

    before = orb.TAIL_KERNEL_MODE
    orb.TAIL_KERNEL_MODE = mode
    try:
        return fn()
    finally:
        orb.TAIL_KERNEL_MODE = before


def extract_ms(torch, dev, cfg, images):
    """Median ms of extract_orb over the first image of each entry,
    synchronized, after one warm call."""
    from vieo_slam_tpu_torch.ops import orb

    times = []
    for n, entry in enumerate([images[0]] + list(images)):
        img = torch.from_numpy(entry[0]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orb.extract_orb(img, cfg, device=dev)
        torch.cuda.synchronize()
        if n:
            times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def check_counts(phase, launches, exact, at_all):
    """Each kernel of `exact` ran exactly that often (B1, and B2 or the
    tail kernel B5: once per frame) and each of `at_all` at least once in
    the run the counts were read from."""
    for k, n in exact.items():
        if launches[k] != n:
            fail(f"{phase}: {k} launched {launches[k]} times, expected {n}")
    idle = [k for k in at_all if launches[k] == 0]
    if idle:
        fail(f"{phase}: kernels never launched: {idle}")


def host_waits(torch, fn):
    """(fn(), {host wait call: count}) of one fn() under torch.profiler:
    stream and device synchronizations and the copies between host and
    device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key: e.count for e in prof.key_averages()
                 if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaMemcpyAsync", "cudaEventSynchronize")}


TUMVI_STYLE_YAML = """%YAML:1.0
# A TUM-VI-style two-camera KB8 rig (Camera2.Trc: camera-from-rig).
Camera.type: "KannalaBrandt8"
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: 240.0
Camera.k1: {k[0]}
Camera.k2: {k[1]}
Camera.k3: {k[2]}
Camera.k4: {k[3]}
Camera.width: {w}
Camera.height: 480
Camera.bf: {bf}
Camera2.fx: {fx}
Camera2.fy: {fx}
Camera2.cx: {cx}
Camera2.cy: 240.0
Camera2.k1: {k[0]}
Camera2.k2: {k[1]}
Camera2.k3: {k[2]}
Camera2.k4: {k[3]}
Camera2.Trc: !!opencv-matrix
  rows: 3
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, {tx},
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0]
ORBextractor.nFeatures: 1200
ORBextractor.nLevels: 8
"""


def rig_from_yaml(cams):
    """The 2-camera rig parsed from a TUM-VI-style YAML by the port's
    io.config, checked equal to `cams` (rig, geometry camera)."""
    from vieo_slam_tpu_torch.io import config

    rig, geom = cams
    c0, c1 = rig
    text = TUMVI_STYLE_YAML.format(
        fx=c0.fx, cx=c0.cx, k=[float(x) for x in c0.dist], w=c0.width,
        bf=c0.fx * BASELINE, tx=float(c1.tcr[0]))
    fd, path = tempfile.mkstemp(suffix=".yaml")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    try:
        settings = config.load_settings(path)
    finally:
        os.unlink(path)
    parsed = config.rig_cameras(settings)
    for a, b in zip(parsed, rig):
        same = (a.kind == b.kind and (a.fx, a.fy, a.cx, a.cy, a.width,
                                      a.height) == (b.fx, b.fy, b.cx, b.cy,
                                                    b.width, b.height)
                and all(np.array_equal(getattr(a, x), getattr(b, x))
                        for x in ("dist", "Rcr", "tcr")))
        if not same:
            fail(f"the rig parsed from YAML differs from the row's: {a} "
                 f"against {b}")
    if len(parsed) != len(rig) or settings.n_features != 1200:
        fail("the YAML rig's camera count or ORB settings differ")
    return parsed, geom


def rig_images(rig):
    """The rig's images of the first frame of the multicam rows."""
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.sim import world as sim

    sc = ev.scenario("multicam_kb8", 1)
    world = sim.SyntheticWorld(sc.world_cfg)
    Rcw, tcw = sim.trajectory_to_tcw(sc.Rwc, sc.twc)
    return [world.render_view(c, c.Rcr @ Rcw[0], c.Rcr @ tcw[0] + c.tcr)
            for c in rig]


def run_row(torch, dev, row, seed, width=752, n_features=1200, n_levels=8,
            profile=None, async_mapping=None, vio_cfg=None, cams=None,
            n_frames=None):
    """One row of the port's evaluate_ntimes.py at full width, driven
    frame by frame by its `Row` (the one copy of the rows), with the
    diagnostics of this script around it: stereo_blackout, stereo_loop,
    stereo_async, stereo_vio, vio_blackout, vio_loop, vieo, veo /
    veo_blackout, multicam_kb8 / multicam4_kb8 (or the rig `cams` = (rig,
    geometry camera)) and map_reuse, 360 frames for a loop row and 60
    otherwise (or `n_frames`: the row's first frames).
    Returns a dict of the system (and the front end), the states, the
    ATEs, the launches counted and the host seconds spent inside the
    relocalization calls, inside loop_closer.process_keyframe and inside
    its candidate verification (_try_close), the inputs of the last
    recovery frame, the frame where
    the VI initialization took, the frames the encoder fused, the rig's
    per-view triangulation stats a frame and the ms of save_map and
    load_map.  `profile` = (first, last) runs those frames under
    torch.profiler, returned with their wall seconds.  `async_mapping`
    (default: the stereo_async row only) and `vio_cfg` (VioConfig fields
    over the rows') vary the row; the threads that ran the VIO window BA
    are returned."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.frontend import relocalization
    from vieo_slam_tpu_torch.io.evaluate import ate
    from vieo_slam_tpu_torch.ops import cuda_build
    from vieo_slam_tpu_torch.system import System
    from vieo_slam_tpu_torch.utils.metrics import metrics

    n = n_frames or (2 * ev.LOOP_FRAMES_PER_LAP if row.endswith("_loop")
                     else 60)
    metrics.reset()
    r = ev.Row(row, seed, n, dev, width, n_features, n_levels,
               async_mapping=async_mapping, vio_cfg=vio_cfg, rig=cams)
    sc, front = r.sc, r.front
    vio = sc.base in ("stereo_vio", "vieo")
    fused_at = []
    if sc.base == "veo":
        fuse = front._fuse

        def fuse_counted(frame):
            fused_at.append(len(r.states))
            return fuse(frame)

        front._fuse = fuse_counted
    window_ba_threads = []
    if vio:
        step = front._backend_worker_step

        def worker_step(k):
            window_ba_threads.append(threading.current_thread().name)
            return step(k)

        front._backend_worker_step = worker_step

    inside = {"reloc": {}, "loop": {}, "verify": {}}
    # (host seconds, result) of each wrapped call
    spent = {"reloc": [], "loop": [], "verify": []}

    def counted(kind, fn):
        def wrapped(*a, **kw):
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            out = None
            try:
                out = fn(*a, **kw)
                return out
            finally:
                spent[kind].append((time.perf_counter() - t0, out))
                acc = inside[kind]
                for k, v in cuda_build.LAUNCHES.items():
                    acc[k] = acc.get(k, 0) + v - before[k]
        return wrapped

    reuse_ms = {}

    def timed(name, fn):
        def wrapped(system, path):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(system, path)
            torch.cuda.synchronize()
            reuse_ms[name] = 1e3 * (time.perf_counter() - t0)
            return out
        return wrapped

    def instrument(lc):
        lc.process_keyframe = counted("loop", lc.process_keyframe)
        lc._try_close = counted("verify", lc._try_close)

    patched = [(relocalization, "try_relocalize",
                counted("reloc", relocalization.try_relocalize)),
               (System, "save_map", timed("save_map", System.save_map)),
               (System, "load_map", timed("load_map", System.load_map))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    for obj, name, fn in patched:
        setattr(obj, name, fn)
    frame_s, recovered_at, last_frame, init_at = [], None, None, None
    prof, prof_s, profiled, instrumented = None, 0.0, None, None
    t_run = time.perf_counter()
    try:
        for i in range(n):
            images = r.prepare(i)
            if r.system is not instrumented:       # new, or the map reused
                instrument(r.system.loop_closer)
                instrumented = r.system
            if profile is not None and i == profile[0]:
                prof = torch_profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                prof.__enter__()
            n_reloc = metrics.counters.get("reloc_success", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.track(i, images)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            if prof is not None:
                prof_s += frame_s[-1]
                if i == profile[1] - 1:
                    prof.__exit__(None, None, None)
                    prof, profiled = None, prof
            if vio and r.front.inited and init_at is None:
                init_at = i
            if metrics.counters.get("reloc_success", 0) > n_reloc:
                if recovered_at is None:
                    recovered_at = i
                last_frame = r.frame
        r.system.wait_idle()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    res = r.finish()
    traj = r.system.tracker.trajectory
    poses = np.asarray([-(R.T @ t) for _, R, t, _ in traj])
    return dict(system=r.system, front=r.front, states=r.states, n=n,
                ts=sc.ts, twc=sc.twc, bo=sc.bo, recovered_at=recovered_at,
                last_frame=last_frame, inside=inside, spent=spent,
                hook_s=r.hook_s, closures=r.lc_events, run_s=run_s,
                frame_s=frame_s, init_at=init_at,
                window_ba_threads=window_ba_threads,
                ate_track=ate(np.asarray([x[0] for x in traj]), poses,
                              sc.ts, sc.twc)["rmse"],
                ate_no_gba=res["rmse_noFullBA"], ate_gba=res["rmse_fullBA"],
                ate_post_recovery=res.get("rmse_postRecovery"),
                reuse_at=sc.reuse_at, reuse_ms=reuse_ms, fused_at=fused_at,
                view_stats=np.asarray(r.view_stats), report=metrics.report(),
                numbers=res,
                profile=None if profiled is None else
                (profiled, prof_s, profile[1] - profile[0]))


def graph_error(torch, g):
    """Largest |difference| between a utils.cuda_graph.CapturedCall's last
    replay and the plain call on the same inputs (the graph's own input
    and output tensors), and the plain call's ms."""
    from torch.utils._pytree import tree_flatten

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = g.plain()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_flatten(plain)[0], tree_flatten(g.outputs)[0]))
    return err, ms


def chain_graphs(call):
    """(name, CapturedCall) of each chain-block graph of a window BA's
    utils.cuda_graph.GraphedCall."""
    from torch.utils._pytree import tree_unflatten

    out = []
    for g in call.graphs.values():
        args, kwargs = tree_unflatten(g.inputs, g.spec)
        out.append((f"the window BA's chain blocks, {args[0].p.shape[0]} "
                    f"chains{'' if kwargs['jacobian'] else ', cost only'}, "
                    f"captured on {g.thread}, replays {dict(g.replays)}",
                    g))
    return out


def check_graphs(torch, tag, graphs):
    """Each named CapturedCall's last replay against the plain call."""
    for name, g in graphs:
        err, ms = graph_error(torch, g)
        log(f"{tag} {name} replayed from its CUDA graph against the plain "
            f"call on the same inputs: max |diff| {err:.3g}; the plain call "
            f"{ms:.2f} ms")
        if not err <= 1e-5:
            fail(f"{tag} the graphed {name} differs from the plain call")


def loop_closing_ms(out):
    """Host ms of loop_closer.process_keyframe with the seconds of
    run_row's closure hook taken out: the mean over all
    keyframes, the keyframe that closed the first loop, and the split
    between candidate verification (_try_close: calls, ms in all) and the
    per-keyframe work around it (the purge, the BoW descent, the database
    query and insert: ms a keyframe)."""
    calls, verify, hook = (out["spent"]["loop"], out["spent"]["verify"],
                           out["hook_s"])
    if not calls:
        return None
    total = sum(dt for dt, _ in calls) - sum(hook)
    verify_s = sum(dt for dt, _ in verify) - sum(hook)
    closing = next((dt for dt, closed in calls if closed), None)
    return dict(
        n_kf=len(calls), per_kf=1e3 * total / len(calls),
        closing_kf=None if closing is None else 1e3 * (closing - hook[0]),
        verify_calls=len(verify), verify_ms=1e3 * verify_s,
        rest_per_kf=1e3 * (total - verify_s) / len(calls))


def stage_ms(report, name):
    """(count, mean ms, total ms) of a stage timer, zeros if it never ran."""
    st = report["stages_ms"].get(name)
    return (st["count"], st["mean"], st["total"]) if st else (0, 0.0, 0.0)


def summarize_profile(prof, wall_s, n_frames, tag="[8 profile]", top=10):
    """Device busy share, kernel launches and host waits per frame, the
    device time under each stage label, and the top device entries;
    returns the device ops and busy ms a frame (None if the profiler saw
    no device time)."""
    events = prof.key_averages()
    labels = ("frame_build", "track_frame")

    def dev_us(e, total=False):
        return getattr(e, "device_time_total" if total else
                       "self_device_time_total", 0.0)

    # Device-side entries: kernels, copies and fills (the profiler also
    # mirrors the two stage labels onto the device timeline; they are
    # spans, not work).
    on_dev = [e for e in events if dev_us(e) > 0 and e.key not in labels
              and "cuda" in str(getattr(e, "device_type", "")).lower()]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    if not on_dev:
        log(f"{tag} device time not measured: the profiler saw no CUDA "
            "events")
        return None
    launches = sum(e.count for e in on_dev)
    ours_ms = sum(dev_us(e) for e in on_dev if any(
        k in e.key for k in ("fast_nms_blend_kernel", "gather_patches_kernel",
                             "best2_", "tail_fused_kernel"))) / 1e3
    waits = {e.key: e.count for e in events
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync", "cudaEventSynchronize")}
    wall_ms = 1e3 * wall_s / n_frames
    log(f"{tag} {n_frames} full-width frames under torch.profiler: "
        f"wall {wall_ms:.2f} ms/frame, device busy {busy_ms / n_frames:.2f} "
        f"ms/frame, idle share {1 - busy_ms / (wall_ms * n_frames):.4f}, "
        f"{launches / n_frames:.0f} device ops/frame, host waits/frame "
        f"{ {k: round(v / n_frames, 1) for k, v in waits.items()} }; "
        f"the hand-written kernels {ours_ms / n_frames:.3f} ms/frame "
        f"({ours_ms / busy_ms:.4f} of device time)")
    for label in labels:
        e = next((e for e in events if e.key == label), None)
        if e is not None:
            log(f"{tag} {label}: host {e.cpu_time_total / 1e3 / n_frames:.2f}"
                f" ms/frame, device {dev_us(e, True) / 1e3 / n_frames:.2f} "
                f"ms/frame")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:top]:
        log(f"{tag}   device {dev_us(e) / 1e3 / n_frames:8.3f} ms/frame "
            f"{e.count / n_frames:7.1f}x  {e.key[:90]}")
    on_host = [e for e in events if e.key not in labels and e not in on_dev]
    for e in sorted(on_host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]:
        log(f"{tag}   host {e.self_cpu_time_total / 1e3 / n_frames:8.3f}"
            f" ms/frame {e.count / n_frames:7.1f}x  {e.key[:90]}")
    return dict(ops=launches / n_frames, busy_ms=busy_ms / n_frames,
                wall_ms=wall_ms)


def rig_encoder_reuse_phases(torch, dev, launches_place, stereo_vio_ate):
    """Phases 16-20: the KB8 rigs of 2 and 4 cameras, VEO through a
    blackout, VIEO and map reuse, each at full width with its launches
    counted into `launches_place`.  Returns the rig kernel cases of phase
    17 (B1/B2 over 32 entries, B3 under the epipolar masks)."""
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.ops import cuda_build

    vio_path = ("fast_nms_blend", "gather_patches", "fused_best2",
                "fused_projection_best2")
    # 16-17. the distorted KB8 rigs of 2 and 4 cameras
    rig_kernels = {}
    for phase, row, n_cams in ((16, "multicam_kb8", 2),
                               (17, "multicam4_kb8", 4)):
        tag = f"[{phase} {row}, seed 0]"
        cams = ev.rig_cameras(752, n_cams)
        if n_cams == 2:
            cams = rig_from_yaml(cams)
            log(f"{tag} the rig parsed from a TUM-VI-style YAML by "
                f"io.config equals the row's rig")
        cuda_build.reset_launches()
        out = run_row(torch, dev, row, 0, cams=cams)
        launches_place[row, None] = dict(cuda_build.LAUNCHES)
        system, states, vs = out["system"], out["states"], out["view_stats"]
        tri = vs[:, :, 1].mean(0)
        err2 = [float(np.nanmean(np.where(vs[:, v, 1] > 0, vs[:, v, 2],
                                          np.nan)))
                for v in range(vs.shape[1])]
        n = out["n"]
        log(f"{tag} {n} frames 752x480 x {n_cams} KB8 cameras, 1200 "
            f"features, 8 levels: LOST {states.count('LOST')}; keyframe ATE "
            f"without / with the final GBA {out['ate_no_gba']:.5f} / "
            f"{out['ate_gba']:.5f} m; triangulations a frame by view "
            f"{[round(float(x), 2) for x in tri]}, mean_err2 "
            f"{[round(x, 4) for x in err2]} (the 640x480 row: view 1 218.15 "
            f"/ 0.2582{', views 2-3 109.82 / 0.715, 38.91 / 0.2544' if n_cams == 4 else ''}); "
            f"{system.map.n_keyframes()} keyframes, "
            f"{system.map.n_landmarks()} landmarks; launches "
            f"{launches_place[row, None]} ({out['run_s']:.1f} s)")
        log(f"{tag} ms: frame median {1e3 * np.median(out['frame_s']):.2f}; "
            f"(count, mean, total) " + ", ".join(
                f"{k} {stage_ms(out['report'], k)}" for k in (
                    "track", "local_mapping", "loop_closing", "frame")))
        check_counts(row, launches_place[row, None],
                     {"fast_nms_blend": n, "gather_patches": n,
                      "tail_fused": 0}, vio_path)
        if launches_place[row, None]["fused_best2"] < (n_cams - 1) * n:
            fail(f"{row}: B3 launched fewer than {n_cams - 1} times a frame")
        if states.count("LOST") or not out["ate_no_gba"] < 0.02 \
                or not (vs[:, 0, 1] > 0).all():
            fail(f"{row} misses its bars")
        if n_cams == 4:
            images = rig_images(cams[0])
            from vieo_slam_tpu_torch.ops import orb
            rig_kernels = check_rig_kernels(
                torch, dev, cams[0], images,
                orb.OrbConfig(n_features=1200, n_levels=8))
            for case, r in rig_kernels.items():
                on_card = "not measured" if r["device_ms"] is None \
                    else f"{r['device_ms']:.4f} ms"
                log(f"{tag} {case}: equal to its plain version, "
                    f"{r['ms']:.4f} ms a call, {on_card} in the kernel "
                    f"(plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound'][0]:.4f} ms by {r['bound'][1]})"
                    + (f", {r['candidates']} candidates, {r['matched']} rows "
                       f"matched" if "candidates" in r else ""))
        system.shutdown()

    # 18. VEO with the blackout's black frames: the wheel encoder carries
    # the pose through them
    tag = "[18 veo_blackout, seed 0]"
    cuda_build.reset_launches()
    out = run_row(torch, dev, "veo_blackout", 0)
    launches_place["veo_blackout", None] = dict(cuda_build.LAUNCHES)
    system, veo, states = out["system"], out["front"], out["states"]
    b0, b1 = out["bo"]
    black = states[b0:b1]
    ok_frames = [i for i in range(1, out["n"]) if states[i] == "OK"]
    n_reloc = out["report"]["counters"].get("reloc_success", 0)
    log(f"{tag} {out['n']} frames 752x480, 1200 features, 8 levels, frames "
        f"{b0}-{b1 - 1} black: LOST {states.count('LOST')}, "
        f"{black.count('ODOMOK')} black frames ODOMOK, relocalizations "
        f"{n_reloc}; fused {len(out['fused_at'])} frames, the first "
        f"{out['fused_at'][:1]}, of {len(ok_frames)} OK frames after the "
        f"first; keyframe ATE {out['ate_no_gba']:.5f} m, after the recovery "
        f"{out['ate_post_recovery']:.5f} m; launches "
        f"{launches_place['veo_blackout', None]} ({out['run_s']:.1f} s)")
    log(f"{tag} ms: (count, mean, total) " + ", ".join(
        f"{k} {stage_ms(out['report'], k)}" for k in (
            "veo.predict", "veo.fuse", "track", "local_mapping", "frame")))
    check_counts("veo_blackout", launches_place["veo_blackout", None],
                 {"tail_fused": 0}, vio_path)
    check_graphs(torch, tag, [("the prior-augmented motion solve", g)
                              for g in veo._fused.graphs.values()])
    if states.count("LOST") or black.count("ODOMOK") != len(black) \
            or n_reloc or out["fused_at"] != ok_frames \
            or out["fused_at"][:1] != [1] \
            or not out["ate_post_recovery"] < 0.02:
        fail("veo_blackout misses its bars")

    # 19. VIEO: stereo_vio with the wheel encoder in the fused solve
    tag = "[19 vieo, seed 0]"
    cuda_build.reset_launches()
    out = run_row(torch, dev, "vieo", 0)
    launches_place["vieo", None] = dict(cuda_build.LAUNCHES)
    vio, states = out["front"], out["states"]
    after = 1e3 * np.asarray(out["frame_s"][(out["init_at"] or 0) + 1:])
    log(f"{tag} {out['n']} frames 752x480, 1200 features, 8 levels: VI init "
        f"at frame {out['init_at']}, |g| {np.linalg.norm(vio.gw):.4f}, bg "
        f"{vio.bg} (true {ev.VIO_BG}); LOST {states.count('LOST')}; keyframe "
        f"ATE {out['ate_no_gba']:.5f} m (phase 12, stereo_vio: "
        f"{stereo_vio_ate:.5f} m); {vio.enc_ring.size()} wheel "
        f"samples; whole frame after the init median "
        f"{np.median(after) if after.size else float('nan'):.2f} ms; "
        f"launches {launches_place['vieo', None]} ({out['run_s']:.1f} s)")
    log(f"{tag} ms: (count, mean, total) " + ", ".join(
        f"{k} {stage_ms(out['report'], k)}" for k in (
            "vio.preintegrate", "vio.fuse", "vio.init", "track", "frame")))
    check_counts("vieo", launches_place["vieo", None], {"tail_fused": 0},
                 vio_path)
    check_graphs(torch, tag, [
        ("the fused solve with the encoder factor", g)
        for g in vio._fused.graphs.values()]
        + [(f"the preintegration of {g.inputs[0].shape[0]} samples", g)
           for g in list(vio._preint.graphs.values())[:1]])
    if not vio.inited or abs(np.linalg.norm(vio.gw) - 9.81) > 0.05 \
            or np.abs(vio.bg - ev.VIO_BG).max() > 1.2e-2 \
            or states.count("LOST") or not out["ate_no_gba"] < 0.02:
        fail("vieo misses its bars")

    # 20. map reuse: save at 3/5 of the run, load into a fresh System
    tag = "[20 map_reuse, seed 0]"
    cuda_build.reset_launches()
    out = run_row(torch, dev, "map_reuse", 0)
    launches_place["map_reuse", None] = dict(cuda_build.LAUNCHES)
    system, states = out["system"], out["states"]
    at, rec = out["reuse_at"], out["recovered_at"]
    n_reloc = out["report"]["counters"].get("reloc_success", 0)
    lost_after = None if rec is None else states[rec:].count("LOST")
    log(f"{tag} {out['n']} frames 752x480, 1200 features, 8 levels, the map "
        f"saved and loaded into a fresh System at frame {at}: "
        f"relocalized at frame {rec} ({n_reloc} relocalizations), LOST "
        f"after it {lost_after}; keyframe ATE after the recovery "
        f"{out['ate_post_recovery']:.5f} m, whole run without / with the "
        f"final GBA {out['ate_no_gba']:.5f} / {out['ate_gba']:.5f} m; "
        f"save_map {out['reuse_ms']['save_map']:.2f} ms, load_map "
        f"{out['reuse_ms']['load_map']:.2f} ms; {system.map.n_keyframes()} "
        f"keyframes; launches {launches_place['map_reuse', None]}, inside "
        f"the relocalization calls {out['inside']['reloc']} "
        f"({out['run_s']:.1f} s)")
    check_counts("map_reuse", launches_place["map_reuse", None],
                 {"fast_nms_blend": out["n"], "gather_patches": out["n"],
                  "tail_fused": 0}, vio_path)
    if rec is None or not at <= rec < at + 3 or lost_after \
            or not out["ate_post_recovery"] < 0.02:
        fail("map_reuse misses its bars")
    if not (out["inside"]["reloc"].get("fused_best2", 0) > 0
            and out["inside"]["reloc"].get("fused_projection_best2", 0) > 0):
        fail(f"the relocalization after load_map did not launch B3 and B4: "
             f"{out['inside']['reloc']}")

    return rig_kernels


# Phase 21's bars: keyframe poses of two global BAs of one map within
# 1e-4 rad and 1e-4 m, landmarks within 0.1 px in their observations (the
# 1e-4 m pose tolerance seen from 0.5 m at fx 470), keyframe ATEs within
# 1e-4 m of each other and under 0.02 m; the dry run's BA step within
# 1e-4 (landmarks 1e-3 m); the stages of
# System.final_global_ba; the LM iterations and size of the JAX package's
# multi-host harness (scripts/multihost_bench.py: K 32, M 32768, 10
# iterations; O 8 as scripts/gba_scale_bench.py).
GBA_POSE_TOL = 1e-4
GBA_LM_TOL = 1e-3
GBA_PX_TOL = 0.1
GBA_STAGES = (10, 15)
# One stage: both GBA branches run the same algorithm (no chi2
# classification is carried into a later stage).
GBA_ONE_STAGE = (25,)
SCALE_K, SCALE_M, SCALE_O, SCALE_ITERS = 32, 32768, 8, 10


def pose_diff(R_a, t_a, R_b, t_b):
    """(largest rotation angle in rad, largest translation difference in
    m) between two pose sets [n,3,3], [n,3]."""
    dR = np.einsum("nij,nkj->nik", np.asarray(R_a, np.float64),
                   np.asarray(R_b, np.float64))
    # atan2 of the skew and symmetric parts: arccos of the trace alone
    # reads 3e-4 rad between two copies of one f32 rotation
    sin = np.linalg.norm(np.stack([dR[:, 2, 1] - dR[:, 1, 2],
                                   dR[:, 0, 2] - dR[:, 2, 0],
                                   dR[:, 1, 0] - dR[:, 0, 1]], -1), axis=-1)
    cos = np.trace(dR, axis1=1, axis2=2) - 1
    return (float(np.arctan2(sin, cos).max()),
            float(np.abs(np.asarray(t_a) - np.asarray(t_b)).max()))


def distributed_gba_phase(torch, dev, run):
    """Phase 21: the landmark-sharded global BA (parallel/dist_ba.py).

    (a) The map `run` (a run_row result) ends with, saved with
    System.save_map and loaded into fresh Systems: run_global_ba over a
    mesh of 4 shards on the card, the single-device branch and the
    distributed algorithm over one shard, timed; both branches in one
    stage; then one damped step over 4 shards and on one device on the map
    moved by 1 cm.  (b)
    distributed_ba on the multi-host harness's synthetic problem over 1, 2
    and 4 shards on the card, ms per LM iteration from CUDA events after a
    warm-up.  (c) dryrun_multichip over 4 mesh entries (the visible GPUs
    where there are four, else 4 x this card), counters zeroed before and
    read after.  (d) (a)'s GBA problem over a one-rank NCCL process group
    (parallel/multiprocess.py) against (a)'s one shard.
    Returns the launches of (c)."""
    tag = "[21 distributed GBA]"
    from vieo_slam_tpu_torch.io.evaluate import ate
    from vieo_slam_tpu_torch.ops import cuda_build
    from vieo_slam_tpu_torch.parallel.dist_ba import (
        distributed_ba, distributed_ba_step, make_ba_mesh)
    from vieo_slam_tpu_torch.parallel.dryrun import dryrun_multichip
    from vieo_slam_tpu_torch.parallel.multiprocess import run_distributed_ba
    from vieo_slam_tpu_torch.parallel.synthetic import scaling_problem
    from vieo_slam_tpu_torch.solvers.local_ba import (_ba_iteration,
                                                      _total_cost)
    from vieo_slam_tpu_torch.system import System

    t_phase = time.perf_counter()
    src = run["system"]
    mesh4 = make_ba_mesh([dev] * 4)

    def kf_ate(m, kfs):
        p = np.stack([-(m.kf_Rcw[k].T @ m.kf_tcw[k]) for k in kfs])
        return ate(m.kf_timestamp[kfs], p, run["ts"], run["twc"])["rmse"]

    # (a) one map, three global BAs, timed, on the map as the run left it
    # (the final GBA's minimum): the single-device branch (twice: the
    # order of index_add_'s atomic sums changes from run to run, and the
    # two runs' spread is printed), the distributed branch over 4 shards,
    # and the distributed algorithm over a one-shard mesh (distributed_ba
    # stage by stage, written back as run_global_ba writes).  The 4 shards
    # are held to the one shard, the same algorithm; the single-device
    # branch carries its chi2 classification from the first stage into
    # the second and the distributed one does not (as in the JAX
    # package), so against it only the keyframe ATE is held.  Landmarks
    # are held in the pixels of their observations: f32 leaves the depth
    # of a far or mono-only landmark undetermined (compare the spread).
    # Then one damped Schur step of each on the map with every keyframe
    # but the first moved by 1 cm on each axis (tests/test_async_gba.py's
    # edit): many LM iterations from there carry f32 rounding in another
    # order far along the map's weak directions (scripts/gba_spread.py),
    # one step shows the sharded arithmetic itself.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        src.save_map(path)

        def load(mesh=None):
            s = System(src.cam, src.bf, src.cfg, device=dev)
            s.load_map(path)
            s.mapper.ba_mesh = mesh
            return s

        def gba(s, distributed, stages=GBA_STAGES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not s.mapper.run_global_ba(distributed=distributed,
                                          stage_iters=stages):
                fail(f"{tag} (a): a GBA did not run")
            torch.cuda.synchronize()
            return s.map, 1e3 * (time.perf_counter() - t0)

        def one_shard():
            s = load()
            prob0, kf_order, lm_ids, snap = s.mapper.global_problem()
            prob, mesh1 = prob0, make_ba_mesh([dev])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for it in GBA_STAGES:
                R, t, pw = distributed_ba(prob, src.cam, src.bf, mesh1,
                                          iters=it)
                prob = prob._replace(Rcw=R, tcw=t, pw=pw)
            torch.cuda.synchronize()
            took = 1e3 * (time.perf_counter() - t0)
            K, M = len(kf_order), len(lm_ids)
            R, t, pw = (x.cpu().numpy() for x in (R, t, pw))
            with s.map.lock:
                s.mapper._apply_gba_result(kf_order, lm_ids, R[:K], t[:K],
                                           pw[:M], n_free=K - 1,
                                           snap_next_kf=snap)
            return s.map, took, (R[:K], t[:K]), (prob0, kf_order, lm_ids)

        def compare(m_a, m_b):
            """Keyframe poses (rad, m), landmarks (max and median m, max
            px in their observations), keyframe ATEs of a and b."""
            kfs = m_b.keyframe_ids()
            dR, dt = pose_diff(m_a.kf_Rcw[kfs], m_a.kf_tcw[kfs],
                               m_b.kf_Rcw[kfs], m_b.kf_tcw[kfs])
            if not np.array_equal(m_a.lm_valid, m_b.lm_valid):
                return dR, dt, np.inf, np.inf, np.inf, kf_ate(m_a, kfs), \
                    kf_ate(m_b, kfs)
            ids = np.nonzero(m_b.lm_valid)[0]
            err = np.linalg.norm(m_a.lm_pw[ids] - m_b.lm_pw[ids], axis=1)
            obs_kf, _ = m_b.landmark_observations(ids)
            k = np.clip(obs_kf, 0, None)

            def px(m):
                pc = np.einsum("moij,mj->moi", m.kf_Rcw[k], m.lm_pw[ids]) \
                    + m.kf_tcw[k]
                return np.stack([src.cam.fx * pc[..., 0] / pc[..., 2],
                                 src.cam.fy * pc[..., 1] / pc[..., 2]], -1)

            d_px = np.linalg.norm(px(m_a) - px(m_b), axis=-1)[obs_kf >= 0]
            return dR, dt, err.max(), np.median(err), d_px.max(), \
                kf_ate(m_a, kfs), kf_ate(m_b, kfs)

        def said(c):
            return (f"keyframe poses within {c[0]:.3g} rad / {c[1]:.3g} m, "
                    f"landmarks {c[2]:.3g} m (median {c[3]:.3g}), "
                    f"{c[4]:.3g} px")

        (m_s, ms_s), (m_2, ms_2) = gba(load(), False), gba(load(), False)
        m_d, ms_d = gba(load(mesh4), True)
        m_1, ms_1, poses_1, (prob_p, kf_order, lm_ids) = one_shard()
        shards, branch, spread = (compare(m_d, m_1), compare(m_d, m_s),
                                  compare(m_2, m_s))
        log(f"{tag} (a) run_global_ba stages {GBA_STAGES} on the map as "
            f"left: single device {ms_s:.2f} / {ms_2:.2f} ms, 4 shards "
            f"{ms_d:.2f} ms on {[str(d) for d in mesh4.devices]}, one "
            f"shard (distributed_ba) {ms_1:.2f} ms; 4 shards against one "
            f"shard: {said(shards)}; against the single-device branch: "
            f"{said(branch)}; the single-device branch against itself: "
            f"{said(spread)}; keyframe ATE 4 shards {shards[5]:.6f} m, one "
            f"shard {shards[6]:.6f} m, single device {branch[6]:.6f} / "
            f"{spread[5]:.6f} m")
        if max(shards[:2]) > GBA_POSE_TOL or not shards[4] <= GBA_PX_TOL \
                or abs(shards[5] - shards[6]) > GBA_POSE_TOL \
                or abs(branch[5] - branch[6]) > GBA_POSE_TOL \
                or not shards[5] < 0.02:
            fail(f"{tag} (a): the 4-shard GBA misses its bars")
        # One stage: the single-device branch carries no classification
        # either, so the branches run one algorithm and are held to each
        # other.
        (m_s1, ms_s1), (m_d1, ms_d1) = (gba(load(), False, GBA_ONE_STAGE),
                                        gba(load(mesh4), True, GBA_ONE_STAGE))
        same = compare(m_d1, m_s1)
        log(f"{tag} (a) run_global_ba stages {GBA_ONE_STAGE}, the same "
            f"algorithm on both branches: single device {ms_s1:.2f} ms, 4 "
            f"shards {ms_d1:.2f} ms; 4 shards against the single-device "
            f"branch: {said(same)}; keyframe ATE {same[5]:.6f} / "
            f"{same[6]:.6f} m")
        if max(same[:2]) > GBA_POSE_TOL or not same[4] <= GBA_PX_TOL:
            fail(f"{tag} (a): in one stage the 4-shard GBA misses the "
                 f"single-device branch")
        moved = load()
        moved.map.kf_tcw[moved.map.keyframe_ids()[1:]] += np.float32(0.01)
        prob_m, _, _, _ = moved.mapper.global_problem()
        lam = torch.tensor(1e-4, device=dev)
        step_s = _ba_iteration(prob_m.Rcw, prob_m.tcw, prob_m.pw, prob_m,
                               src.cam, torch.tensor(src.bf, device=dev),
                               prob_m.obs_valid, lam)
        step_d = distributed_ba_step(prob_m, src.cam, src.bf,
                                     prob_m.obs_valid, lam, mesh4)
        step = pose_diff(*(x.cpu().numpy() for x in (
            step_d[0], step_d[1], step_s[0], step_s[1])))
        step_lm = float((step_d[2] - step_s[2]).norm(dim=1).max())
        k = prob_m.obs_kf.clamp_min(0).long()

        def px(R, t, pw):
            pc = torch.einsum("moij,mj->moi", R[k], pw) + t[k]
            return torch.stack([src.cam.fx * pc[..., 0] / pc[..., 2],
                                src.cam.fy * pc[..., 1] / pc[..., 2]], -1)

        seen = prob_m.obs_valid & (prob_m.obs_kf >= 0)
        step_px = float((px(*step_d) - px(*step_s)).norm(dim=-1)[seen].max())
        moved_by = float((step_s[1] - prob_m.tcw).abs().max())
        log(f"{tag} (a) one damped step on the map moved 1 cm (poses moved "
            f"up to {moved_by:.3g} m): 4 shards against one device within "
            f"{step[0]:.3g} rad / {step[1]:.3g} m, landmarks {step_lm:.3g} m,"
            f" {step_px:.3g} px")
        if max(step) > GBA_POSE_TOL or not step_px <= GBA_PX_TOL:
            fail(f"{tag} (a): the sharded step misses the single-device one")
    K, M = len(kf_order), len(lm_ids)
    log(f"{tag} (a) the GBA problem: K {K}, M {M}, padded M "
        f"{prob_p.pw.shape[0]}")

    # (b) the multi-host harness's problem over 1, 2 and 4 shards
    cam_b, bf_b, prob_b = scaling_problem(SCALE_K, SCALE_M, SCALE_O,
                                          device=dev)
    bf_t = torch.tensor(bf_b, device=dev)

    def cost(R, t, pw):
        return float(_total_cost(R, t, pw, prob_b, cam_b, bf_t,
                                 prob_b.obs_valid))

    cost0, res = cost(prob_b.Rcw, prob_b.tcw, prob_b.pw), {}
    for n in (1, 2, 4):
        mesh = make_ba_mesh([dev] * n)
        distributed_ba(prob_b, cam_b, bf_b, mesh, iters=SCALE_ITERS)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = distributed_ba(prob_b, cam_b, bf_b, mesh, iters=SCALE_ITERS)
        b.record()
        b.synchronize()
        res[n] = (a.elapsed_time(b) / SCALE_ITERS, cost(*out),
                  [x.cpu().numpy() for x in out])
    diffs = {n: pose_diff(res[n][2][0], res[n][2][1], res[1][2][0],
                          res[1][2][1]) for n in (2, 4)}
    log(f"{tag} (b) K {SCALE_K}, M {SCALE_M}, O {SCALE_O}, {SCALE_ITERS} LM "
        f"iterations: ms per iteration " + ", ".join(
            f"{n} shard{'s' if n > 1 else ''} {res[n][0]:.3f}"
            for n in res) + f" (shards share the card's SMs: the cost of "
        f"sharding, not a scale-out); cost {cost0:.1f} -> " + ", ".join(
            f"{res[n][1]:.1f}" for n in res) + "; poses against 1 shard: "
        + ", ".join(f"{n} shards {d[0]:.3g} rad / {d[1]:.3g} m"
                    for n, d in diffs.items()))
    if any(max(d) > GBA_POSE_TOL for d in diffs.values()) \
            or not all(r[1] < cost0 for r in res.values()):
        fail(f"{tag} (b): shard counts disagree or the cost did not drop")

    # (c) the dry run, its kernels counted
    n_gpu = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(4)] if n_gpu >= 4 \
        else [dev] * 4
    cuda_build.reset_launches()
    dr = dryrun_multichip(devs)
    launches = dict(cuda_build.LAUNCHES)
    log(f"{tag} (c) dryrun_multichip over {[str(d) for d in devs]}: "
        f"{json.dumps(dr)}; launches {launches}")
    if dr["extraction"]["max_abs_diff"] != 0 \
            or dr["matching"]["max_abs_diff"] != 0 \
            or not dr["matching"]["matched"] \
            or not dr["ba_step"]["max_abs_diff"] <= GBA_POSE_TOL \
            or not dr["ba_step"]["pw_max_abs_diff"] <= GBA_LM_TOL:
        fail(f"{tag} (c): the dry run differs from one device")
    check_counts("dryrun_multichip", launches, {},
                 ("fast_nms_blend", "gather_patches",
                  "fused_projection_best2"))

    # (d) (a)'s problem over a one-rank NCCL world
    t0 = time.perf_counter()
    R_n, t_n = run_distributed_ba(prob_p, src.cam, src.bf, 1,
                                  stage_iters=GBA_STAGES, backend="nccl",
                                  timeout=300.0)
    nccl_s = time.perf_counter() - t0
    d_one = pose_diff(R_n[:K], t_n[:K], *poses_1)
    d_branch = pose_diff(R_n[:K], t_n[:K], m_s.kf_Rcw[kf_order],
                         m_s.kf_tcw[kf_order])
    log(f"{tag} (d) one NCCL rank on cuda:0 ({nccl_s:.1f} s with the "
        f"process start), (a)'s problem: poses against (a)'s one shard in "
        f"the process {d_one[0]:.3g} rad / {d_one[1]:.3g} m, against its "
        f"single-device branch {d_branch[0]:.3g} rad / {d_branch[1]:.3g} m "
        f"({time.perf_counter() - t_phase:.1f} s)")
    if max(d_one) > GBA_POSE_TOL:
        fail(f"{tag} (d): the NCCL world's poses miss (a)'s one shard")
    return launches


# Phase 22's EuRoC-style sequence: the stereo_blackout row's world and
# circle (no blackout) seen by a 752x480 EuRoC-like camera at 20 Hz (fx
# 458.654, cam0's principal point, a 0.11 m baseline), written as a
# mav0/ folder with PNG images, 200 Hz IMU and ground truth, and read back
# through examples/run_euroc.py with this settings file.
EUROC_FRAMES = 40
EUROC_T0_NS = 1403636579763555584          # MH_01's first image stamp
EUROC_DT = 0.05
EUROC_FX, EUROC_CX, EUROC_CY, EUROC_BASELINE = 458.654, 367.215, 248.375, 0.11
EUROC_STYLE_YAML = """%YAML:1.0
# A EuRoC-style stereo settings file (rectified pinhole pair).
Camera.type: "PinHole"
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: {bf}
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
# The trace of frames [30, 33) must show these kernels on the card (a
# template argument tells B3 from B4).
TRACE_KERNELS = {"fast_nms_blend": "fast_nms_blend_kernel",
                 "gather_patches": "gather_patches_kernel",
                 "fused_best2": "best2_kernel<false>",
                 "fused_projection_best2": "best2_kernel<true>"}
TRACE_FRAMES = (30, 33)


def write_euroc_folder(root):
    """The phase-22 sequence as a EuRoC mav0/ folder under `root`; returns
    the settings file's path."""
    from vieo_slam_tpu_torch.cameras import models as cm
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.io.png import write_png
    from vieo_slam_tpu_torch.io.serialization import quat_wxyz
    from vieo_slam_tpu_torch.sim import world as sim

    sc = ev.scenario("stereo_blackout", EUROC_FRAMES)
    world = sim.SyntheticWorld(sc.world_cfg)
    ts = np.arange(EUROC_FRAMES) * EUROC_DT
    Rwc, twc, v_w, a_w = sim.circle_trajectory(ts, radius=1.0,
                                               omega=MONO_OMEGA,
                                               look_outward=True)
    Rcw, tcw = sim.trajectory_to_tcw(Rwc, twc)
    cam = cm.make_pinhole(EUROC_FX, EUROC_FX, EUROC_CX, EUROC_CY, 752, 480)
    mav = Path(root) / "mav0"
    ns = [EUROC_T0_NS + int(round(t * 1e9)) for t in ts]
    rng = np.random.RandomState(0)
    for c in ("cam0", "cam1"):
        (mav / c / "data").mkdir(parents=True)
        (mav / c / "data.csv").write_text(
            "#timestamp [ns],filename\n"
            + "".join(f"{t},{t}.png\n" for t in ns))
    for i, t in enumerate(ns):
        g, b = ev.gain_bias(float(ts[i]))
        pair = world.render_stereo(cam, Rcw[i], tcw[i], EUROC_BASELINE,
                                   t=float(ts[i]), noise_sigma=ev.NOISE_SIGMA,
                                   gain=g, bias=b, rng=rng)
        for c, img in zip(("cam0", "cam1"), pair):
            write_png(str(mav / c / "data" / f"{t}.png"),
                      np.clip(np.rint(img), 0, 255).astype(np.uint8))
    t_imu, gyro, acc = sim.make_imu_samples(ts, Rwc.astype(np.float64), v_w,
                                            a_w, rate_hz=200.0)
    (mav / "imu0").mkdir()
    (mav / "imu0" / "data.csv").write_text(
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "".join(
            f"{EUROC_T0_NS + int(round(t * 1e9))},"
            + ",".join(f"{x:.9f}" for x in (*w, *a)) + "\n"
            for t, w, a in zip(t_imu, gyro, acc)))
    (mav / "state_groundtruth_estimate0").mkdir()
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "".join(
            f"{t}," + ",".join(f"{x:.9f}" for x in (*p, *quat_wxyz(R)))
            + "\n" for t, p, R in zip(ns, twc.astype(np.float64), Rwc)))
    path = Path(root) / "euroc_stereo.yaml"
    path.write_text(EUROC_STYLE_YAML.format(
        fx=EUROC_FX, cx=EUROC_CX, cy=EUROC_CY,
        bf=EUROC_FX * EUROC_BASELINE))
    return str(path)


def trace_kernel_names(path):
    """The names of the CUDA kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def supporting_code_phase(torch, dev, launches_place):
    """Phase 22: run_euroc on a EuRoC folder at full width with a trace
    of three frames, the stereo_lem row with the viewer polling, the
    three keypoint selection paths, mutual_filter and entry() on the
    card.  Counts launches of (a) and (b) into `launches_place`."""
    import contextlib
    import io

    from vieo_slam_tpu_torch.entry import entry
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.examples import run_euroc
    from vieo_slam_tpu_torch.io.euroc import load_euroc
    from vieo_slam_tpu_torch.io.evaluate import ate
    from vieo_slam_tpu_torch.io.png import read_png
    from vieo_slam_tpu_torch.ops import cuda_build, matching, orb
    from vieo_slam_tpu_torch.system import System
    from vieo_slam_tpu_torch.utils.metrics import metrics, trace
    from vieo_slam_tpu_torch.viz import Viewer

    t_phase = time.perf_counter()
    # (a) run_euroc at 752x480 from a EuRoC folder and settings file
    tag = "[22a run_euroc]"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        settings = write_euroc_folder(tmp)
        write_s = time.perf_counter() - t0
        states, ends, tracing = [], [], []
        track = System.track_frame
        trace_dir = os.path.join(tmp, "trace")

        def traced(system, frame):
            i = len(states)
            if i == TRACE_FRAMES[0]:
                tracing.append(trace(trace_dir))
                tracing[0].__enter__()
            st = track(system, frame)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            states.append(st.name)
            if i == TRACE_FRAMES[1] - 1:
                tracing[0].__exit__(None, None, None)
            return st

        out = os.path.join(tmp, "traj.txt")
        metrics.reset()
        cuda_build.reset_launches()
        System.track_frame = traced
        try:
            system = run_euroc.main([tmp, settings, "--out", out,
                                     "--device", str(dev)])
        finally:
            System.track_frame = track
        launches_place["euroc_full_width", None] = dict(cuda_build.LAUNCHES)
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            system.shutdown(print_report=True)
        table = report.getvalue()
        print(table, flush=True)
        rows = {line.split()[0] for line in table.splitlines() if line}
        traj = np.loadtxt(out, ndmin=2)
        seq = load_euroc(tmp)
        res = ate(traj[:, 0], traj[:, 1:4], seq.t_gt, seq.p_gt)
        names = trace_kernel_names(os.path.join(trace_dir, "trace.json"))
    # the frame period of the run, after 5 warm-up frames, outside the
    # traced frames and the trace's export
    period = [1e3 * (ends[i] - ends[i - 1]) for i in range(6, len(ends))
              if not TRACE_FRAMES[0] <= i <= TRACE_FRAMES[1]]
    seen = {k: sorted(n for n in names if v in n)
            for k, v in TRACE_KERNELS.items()}
    log(f"{tag} {len(states)} frames of a EuRoC folder (752x480 PNGs "
        f"written in {write_s:.1f} s) through run_euroc.main: LOST "
        f"{states.count('LOST')}, {len(traj)} trajectory lines, ATE RMSE "
        f"{res['rmse']:.5f} m against the ground truth; frame median "
        f"{np.median(period):.2f} ms (load, build, track); launches "
        f"{launches_place['euroc_full_width', None]}; CUDA kernels in the "
        f"trace of frames {TRACE_FRAMES[0]}-{TRACE_FRAMES[1] - 1}: "
        f"{len(names)} names, of them "
        + "; ".join(f"{k}: {v}" for k, v in seen.items())
        + f"; all best2 names: {sorted(n for n in names if 'best2' in n)}")
    if states.count("LOST") or len(traj) != EUROC_FRAMES \
            or not res["rmse"] < 0.02:
        fail(f"{tag} misses its bars")
    if not all(seen.values()):
        fail(f"{tag} the trace lacks kernels: "
             f"{[k for k, v in seen.items() if not v]}")
    if not {"frame", "track"} <= rows:
        fail(f"{tag} the report lacks the frame and track rows")
    check_counts(tag, launches_place["euroc_full_width", None],
                 {"fast_nms_blend": EUROC_FRAMES,
                  "gather_patches": EUROC_FRAMES, "tail_fused": 0},
                 ("fused_best2", "fused_projection_best2"))

    # (b) the stereo_lem row at its own size with the viewer polling, one
    # lap of its two (cut for the script's time)
    tag = "[22b stereo_lem, seed 11]"
    t0 = time.perf_counter()
    n = ev.LOOP_FRAMES_PER_LAP
    cuda_build.reset_launches()
    row = ev.Row("stereo_lem", 11, n, dev)
    with tempfile.TemporaryDirectory() as tmp:
        viewer = Viewer(tmp, every_n_kf=5)
        drawn = []
        for i in range(n):
            row.step(i)
            p = viewer.poll(row.system)
            if p is not None:
                drawn.append(p)
        got = row.finish()
        pngs = [read_png(p) for p in drawn]
    launches_place["stereo_lem", None] = dict(cuda_build.LAUNCHES)
    ref = json.loads((ROOT / "ACCURACY_r05.json").read_text())[
        "scenarios"]["stereo_lem"]
    last = (pngs[-1][0].shape, pngs[-1][1].get("Title")) if pngs else None
    log(f"{tag} {n} frames 640x480, 600 features, 4 levels in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.5g} (ACCURACY_r05 mean "
                    f"{ref.get('avg_' + k, float('nan')):.5g})"
                    for k, v in got.items())
        + f"; {len(drawn)} viewer PNGs, the last {last}; launches "
        f"{launches_place['stereo_lem', None]}")
    if not (np.isfinite(got["rmse_fullBA"]) and got["rmse_fullBA"] < 0.05):
        fail(f"{tag} keyframe ATE {got['rmse_fullBA']} misses 0.05 m")
    if not any((pix != 255).any() for pix, _ in pngs):
        fail(f"{tag} no viewer PNG with a drawn pixel")

    # (c) extract_orb_batch of phase 5's stereo pair, three selection paths
    tag = "[22c selection]"
    cam, _, world, _, Rcw, tcw, _ = scene(1, 752)
    pair = torch.from_numpy(np.stack(world.render_stereo(
        cam, Rcw[0], tcw[0], BASELINE))).to(dev)
    cfg = orb.OrbConfig(n_features=1200, n_levels=8)
    mode0, feats, ms = orb.BATCHED_SELECT_MODE, {}, {}
    try:
        for mode in ("off", "on", "concat"):
            orb.BATCHED_SELECT_MODE = mode
            feats[mode] = orb.extract_orb_batch(pair, cfg, device=dev)
            ms[mode] = time_ms(torch, lambda: orb.extract_orb_batch(
                pair, cfg, device=dev), reps=20)
    finally:
        orb.BATCHED_SELECT_MODE = mode0
    same = {m: all(torch.equal(a, b) for a, b in zip(feats["off"], feats[m]))
            for m in ("on", "concat")}
    log(f"{tag} extract_orb_batch of a 752x480 stereo pair, 1200 features, "
        f"8 levels, median ms: per level {ms['off']:.3f}, batched "
        f"{ms['on']:.3f}, concat {ms['concat']:.3f}; equal in every field "
        f"to the per-level path: {same}")
    if not all(same.values()):
        fail(f"{tag} a selection path differs from the per-level path")

    # (d) mutual_filter on the card against the CPU, with ties and invalid
    # rows
    g = torch.Generator(device="cpu").manual_seed(0)
    na, nb = 1200, 900
    best = torch.randint(-1, nb // 3, (na,), generator=g, dtype=torch.int32)
    valid = (torch.rand(na, generator=g) < 0.8) & (best >= 0)
    want = matching.mutual_filter(best, na, nb, valid)
    got_d = matching.mutual_filter(best.to(dev), na, nb, valid.to(dev))
    log(f"[22d mutual_filter] {na} rows onto {nb // 3} columns: "
        f"{int(want.sum())} kept, the card equal to the CPU: "
        f"{torch.equal(got_d.cpu(), want)}")
    if not torch.equal(got_d.cpu(), want):
        fail("mutual_filter on the card differs from the CPU")

    # (e) entry(): the frontend step on its own inputs
    fn, args = entry(dev)
    cuda_build.reset_launches()
    outs = fn(*args)
    torch.cuda.synchronize()
    ok = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    log(f"[22e entry] frontend step at 752x480: {int(outs[2])} inliers, "
        f"outputs finite {ok}, launches {dict(cuda_build.LAUNCHES)}")
    check_counts("[22e entry]", cuda_build.LAUNCHES,
                 {"fast_nms_blend": 1, "gather_patches": 1},
                 ("fused_best2", "fused_projection_best2"))
    if not ok:
        fail("entry()'s outputs are not finite")
    log(f"[22 supporting code] {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 23: the RANSAC draws
# ---------------------------------------------------------------------------


def draw_parity_phase(torch, dev):
    """Phase 23: the JAX package's draw (utils/prng) on the card against
    the CPU at the solvers' shapes, then the start of the mono_loop row at
    seed 11, which must initialize at the JAX package's frame."""
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    rng = np.random.RandomState(23)
    cases = [("two-view init", (256, 8), rng.rand(1000) < 0.4),
             ("3D-3D PnP", (1024, 3), rng.rand(512) < 0.7),
             ("DLT PnP", (2048, 6), rng.rand(512) < 0.7),
             ("Sim3", (128, 3), np.arange(512) < 300),
             ("DLT PnP, no valid row", (2048, 6), np.zeros(512, bool))]
    for n, (name, shape, valid) in enumerate(cases):
        key = prng.prng_key(rng.randint(0, 2 ** 31))
        v = torch.from_numpy(valid)
        want = prng.categorical_valid(key, v, shape)
        t0 = time.perf_counter()
        got = prng.categorical_valid(key, v.to(dev), shape)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        same = torch.equal(got.cpu(), want)
        extra = ""
        if n == 0:
            logits = torch.where(v, 0.0, prng.INVALID_LOGIT)
            full = prng.categorical(key, logits.to(dev), shape)
            same &= torch.equal(full.cpu(), want)
            extra = ", the full draw over the logits too"
        log(f"[23a draws] {name} {(*shape, valid.size)}, {int(valid.sum())} "
            f"valid rows: the card equal to the CPU in every index{extra}: "
            f"{same} ({ms:.2f} ms on the card, first call included)")
        if not same:
            fail(f"the {name} draw on the card differs from the CPU")

    t0 = time.perf_counter()
    row = ev.Row("mono_loop", MONO_LOOP_SEED, 2 * ev.LOOP_FRAMES_PER_LAP,
                 dev)
    for i in range(MONO_LOOP_FRAMES):
        row.step(i)
    states = row.states
    first = states.index("OK") if "OK" in states else None
    lost = [i for i, x in enumerate(states) if x == "LOST"]
    row.system.wait_idle()
    kf_ate = row.kf_ate()["rmse"]
    log(f"[23b mono_loop] seed {MONO_LOOP_SEED}, the first "
        f"{MONO_LOOP_FRAMES} frames at 640x480, 1000 features, 4 levels: "
        f"first OK frame {first} (the JAX package's "
        f"{JAX_MONO_LOOP_INIT_FRAME}), LOST frames {lost}, "
        f"{row.system.map.n_keyframes()} keyframes, keyframe ATE RMSE "
        f"{kf_ate:.5f} m ({time.perf_counter() - t0:.1f} s)")
    row.system.shutdown()
    if first != JAX_MONO_LOOP_INIT_FRAME or lost or not kf_ate < 0.02:
        fail("mono_loop does not start as the JAX package's row does")
    log(f"[23 draws] {time.perf_counter() - t_phase:.1f} s")


def extraction_bits_phase(torch, dev):
    """24. The card's ORB extraction against the JAX package's bits."""
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.ops import orb, xla_f32

    tag = "[24 extraction bits]"
    t0 = time.perf_counter()
    z = np.load(ROOT / CLOSURE_STATE)
    row = ev.Row("stereo_loop", 0, 360, device=dev, width=752,
                 n_features=1200, n_levels=8)
    left = [row.prepare(i)[0] for i in range(6)]    # the noise runs on
    cfg = orb.OrbConfig(1200, 8)
    xla_f32.reset_launches()
    diffs = []
    for slot, i in enumerate(KF_FRAMES):
        f = orb.extract_orb(torch.from_numpy(left[i]).to(dev), cfg,
                            device=dev)
        got = {k: getattr(f, k).cpu().numpy() for k in
               ("uv", "level", "desc", "valid")}
        want = {"uv": z["map_kf_uv"][slot], "level": z["map_kf_level"][slot],
                "desc": z["map_kf_desc"][slot].view(np.int32),
                "valid": z["map_kf_kp_valid"][slot]}
        diffs.append({k: int((np.ascontiguousarray(got[k]).view(np.uint8)
                              != np.ascontiguousarray(want[k]).view(
                                  np.uint8)).sum()) for k in got})
    launched = dict(xla_f32.LAUNCHES)
    log(f"{tag} stereo_loop seed 0, frames {KF_FRAMES} (keyframe slots 0-2 "
        f"of {CLOSURE_STATE}): bytes that differ from the JAX package's "
        f"features {diffs}; xla_f32 launches {launched}")
    if any(v for d in diffs for v in d.values()):
        fail("the card's extraction of the loop row's first keyframes "
             "differs from the JAX package's features")
    if not all(launched[k] for k in ("resize", "ic_angle", "brief",
                                     "blur7")):
        fail(f"extraction did not run the xla_f32 kernels: {launched}")
    # The card's pyramid, moments and angles against the CPU build's on the
    # same inputs; the card's atan2 / sin / cos against the CPU build's
    # outputs saved with the test data (scripts/xla_order.py --save-libm).
    img = torch.from_numpy(left[0])
    card = orb.build_pyramid(img.to(dev), cfg)
    cpu = orb.build_pyramid(img, cfg)
    pyr = sum(int((c.cpu().numpy().view(np.int32)
                   != h.numpy().view(np.int32)).sum())
              for c, h in zip(card, cpu))
    rng = np.random.RandomState(24)
    patches = torch.from_numpy((rng.rand(4000, 31, 31) * 255)
                               .astype(np.float32))
    a_card, m_card = xla_f32.ic_angle(patches.to(dev), moments=True)
    a_cpu, m_cpu = xla_f32.ic_angle(patches, moments=True)
    mom = int((m_card.cpu().numpy().view(np.int32)
               != m_cpu.numpy().view(np.int32)).sum())
    ang = int((a_card.cpu().numpy().view(np.int32)
               != a_cpu.numpy().view(np.int32)).sum())
    ref = np.load(ROOT / LIBM_REF)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    libm = {}
    for name, got in (("atan2", xla_f32.atan2(t(ref["y"]), t(ref["x"]))),
                      ("sin", xla_f32.sin(t(ref["v"]))),
                      ("cos", xla_f32.cos(t(ref["v"])))):
        g, w = got.cpu().numpy(), ref[name]
        libm[name] = int(((g.view(np.int32) != w.view(np.int32))
                          & ~(np.isnan(g) & np.isnan(w))).sum())
    log(f"{tag} card against the CPU build: pyramid of frame 0 "
        f"({sum(x.numel() for x in cpu)} pixels on 8 levels) {pyr} differ; "
        f"4000 random patches: moments {mom}, angles {ang} differ; against "
        f"{LIBM_REF}: {libm} of {len(ref['y'])} / {len(ref['v'])} inputs "
        f"differ ({time.perf_counter() - t0:.1f} s)")
    if pyr or mom or ang or any(libm.values()):
        fail("the card's extraction stages differ from the CPU build's")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "vieo_slam_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no vieo_slam_tpu_torch package",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    jax_run = fullwidth_reference()
    from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
    from vieo_slam_tpu_torch.ops import cuda_build

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1 device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build_all(verbose=True)
    for src in cuda_build.SOURCES:
        cuda_build.library(src)
    log(f"[2 build] {len(cuda_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    rows = check_kernels(torch, dev)
    place = check_place_cases(torch, dev)
    for k, r in rows.items():
        on_card = "not measured" if r["device_ms"] is None \
            else f"{r['device_ms']:.4f} ms"
        log(f"[3 kernels] {k}: {r['ms']:.4f} ms a call, {on_card} of it in "
            f"the kernel on the card (plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max_abs_err {r['max_abs_err']}, shapes {r['shapes']}")
    r = rows["fast_nms_blend"]
    log(f"[3 kernels] fast_nms_blend: the 16 levels of a stereo pair in one "
        f"launch take {r['pair_ms']:.4f} ms a call, "
        f"{'not measured' if r['pair_device_ms'] is None else format(r['pair_device_ms'], '.4f')}"
        f" ms in the kernel")
    r = rows["gather_patches"]
    log(f"[3 kernels] gather_patches: the 16 levels of a stereo pair in one "
        f"launch take {r['pair_ms']:.4f} ms a call, "
        f"{'not measured' if r['pair_device_ms'] is None else format(r['pair_device_ms'], '.4f')}"
        f" ms in the kernel; library yardstick (8 x F.grid_sample, nearest, "
        f"border): " + (f"{r['library_ms']:.4f} ms, equal bit for bit"
                        if r["library_equal"] else "NOT equal, not timed"))
    for k in ("fast_nms_blend", "fused_projection_best2"):
        log(f"[3 kernels] {k}: PyTorch operators in one call of the "
            f"wrapper{' (stereo pair)' if k == 'fast_nms_blend' else ''}: "
            f"{rows[k]['aten_ops']}")
    r = rows["tail_fused"]
    log(f"[3 kernels] tail_fused: angles within {r['max_abs_err']:.3g} rad "
        f"of the plain version (bound 1e-6), {r['bit_flips']} descriptor "
        f"bits differ (bound 0); the path it replaces (one gather_patches "
        f"launch + the PyTorch tail) takes {r['replaced_ms']:.4f} ms on these "
        f"inputs")
    for case, r in place.items():
        log(f"[3 kernels] {case}: equal to its plain version, "
            f"{r['ms']:.4f} ms a call, {r['matched']} rows with a candidate")
    log(f"[3 kernels] all five equal their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4. known configuration (tests/test_image_e2e.py)
    t0 = time.perf_counter()
    system, states, _, res, _, _ = run_sequence(torch, dev, 640, 600, 4, 40)
    lost = sum(s.name == "LOST" for s in states)
    n_kf, n_lm = system.map.n_keyframes(), system.map.n_landmarks()
    log(f"[4 known] 40 frames: LOST {lost}, ATE RMSE {res['rmse']:.5f} m, "
        f"{n_kf} keyframes, {n_lm} landmarks "
        f"({time.perf_counter() - t0:.1f} s)")
    if lost or not res["rmse"] < 0.02 or n_kf < 5 or n_lm <= 200:
        fail("known configuration misses the bars of test_image_e2e")

    # 5. full width: the counted main-path run
    n_frames, warm = 30, 5
    cuda_build.reset_launches()
    system, states, times, res, (cam, bf, cfg, images), _ = run_sequence(
        torch, dev, 752, 1200, 8, n_frames)
    launches = dict(cuda_build.LAUNCHES)
    lost = sum(s.name == "LOST" for s in states)
    t = 1e3 * np.asarray(times[warm:])
    kf_frames = t[:, 2] > 0
    log(f"[5 full width] {n_frames} frames 752x480, 1200 features, 8 levels, "
        f"slab 4096: LOST {lost}, ATE RMSE {res['rmse']:.5f} m, "
        f"{system.map.n_keyframes()} keyframes, "
        f"{system.map.n_landmarks()} landmarks; launches {launches}")
    ext_ms, ste_ms = split_frame_build(torch, dev, cam, bf, cfg,
                                       images[warm:warm + 10])
    log(f"[5 full width] median ms/frame after {warm} warm-up frames: "
        f"frame build {np.median(t[:, 0]):.2f} (extract x2 {ext_ms:.2f}, "
        f"stereo {ste_ms:.2f}), track {np.median(t[:, 1]):.2f}, "
        f"local mapping {np.median(t[kf_frames, 2]) if kf_frames.any() else 0.0:.2f} "
        f"on the {int(kf_frames.sum())} keyframe frames, total "
        f"{np.median(t.sum(1)):.2f}")
    if lost:
        fail(f"full-width run lost track in {lost} frames")
    ate5, track5_ms, frame5_ms = (res["rmse"], np.median(t[:, 1]),
                                  np.median(t.sum(1)))
    check_counts("full width", launches,
                 {"fast_nms_blend": n_frames, "gather_patches": n_frames,
                  "tail_fused": 0},
                 ("fused_best2", "fused_projection_best2"))

    # 6. RGB-D full width, tail kernel on: its own counted run
    t0 = time.perf_counter()
    cuda_build.reset_launches()
    system, states, times, res, (_, _, cfg, images), _ = with_tail_kernel(
        "on", lambda: run_sequence(torch, dev, 752, 1200, 8, n_frames,
                                   sensor="rgbd"))
    launches_rgbd = dict(cuda_build.LAUNCHES)
    lost = sum(s.name == "LOST" for s in states)
    n_kf, n_lm = system.map.n_keyframes(), system.map.n_landmarks()
    t = 1e3 * np.asarray(times[warm:])
    log(f"[6 rgbd full width] {n_frames} frames 752x480, 1200 features, 8 "
        f"levels, slab 4096, tail kernel on: LOST {lost}, ATE RMSE "
        f"{res['rmse']:.5f} m, {n_kf} keyframes, {n_lm} landmarks; launches "
        f"{launches_rgbd}; median ms/frame after {warm} warm-up frames: "
        f"frame build {np.median(t[:, 0]):.2f}, track "
        f"{np.median(t[:, 1]):.2f}, total {np.median(t.sum(1)):.2f} "
        f"({time.perf_counter() - t0:.1f} s)")
    if lost or not res["rmse"] < 0.02 or n_kf < 5 or n_lm <= 200:
        fail("RGB-D full-width run misses its bars")
    check_counts("RGB-D full width", launches_rgbd,
                 {"fast_nms_blend": n_frames, "gather_patches": 0,
                  "tail_fused": n_frames},
                 ("fused_best2", "fused_projection_best2"))
    ext = [with_tail_kernel(m, lambda: extract_ms(torch, dev, cfg,
                                                  images[warm:warm + 10]))
           for m in ("on", "off", "off", "on")]
    log(f"[6 rgbd full width] extract_orb median ms/image over 10 images, "
        f"tail kernel on {ext[0]:.2f}, off {ext[1]:.2f}, off {ext[2]:.2f}, "
        f"on {ext[3]:.2f}")

    # 7. mono known configuration, tail kernel on: its own counted run
    t0 = time.perf_counter()
    n_mono = 60
    cuda_build.reset_launches()
    system, states, _, res, _, _ = with_tail_kernel(
        "on", lambda: run_sequence(
            torch, dev, 640, 1000, 4, n_mono, sensor="mono",
            world_cfg=MONO_WORLD, omega=MONO_OMEGA, hardened=True))
    launches_mono = dict(cuda_build.LAUNCHES)
    names = [s.name for s in states]
    first = names.index("OK") if "OK" in names else -1
    lost = sum(s != "OK" for s in names[first:]) if first >= 0 else n_mono
    lost_from = next((i for i in range(max(first, 0), n_mono)
                      if names[i] != "OK"), None)
    log(f"[7 mono known] {n_mono} frames 640x480, 1000 features, 4 levels, "
        f"tail kernel on: initialized at frame {first}, {lost} frames not OK "
        f"after it (from frame {lost_from}), scale-aligned ATE RMSE "
        f"{res['rmse']:.5f} m over {res['n']} frames (scale "
        f"{res['scale']:.4f}), {system.map.n_keyframes()} keyframes, "
        f"{system.map.n_landmarks()} landmarks; launches {launches_mono} "
        f"({time.perf_counter() - t0:.1f} s); the JAX package on this "
        f"sequence: initialized at frame {JAX_MONO_KNOWN[0]}, LOST from "
        f"frame {JAX_MONO_KNOWN[1]}, ATE RMSE {JAX_MONO_KNOWN[2]} m")
    if first != JAX_MONO_KNOWN[0]:
        fail("mono known configuration does not initialize at the JAX "
             "package's frame")
    if lost_from is not None and \
            lost_from < (1 - MONO_KNOWN_TOL) * JAX_MONO_KNOWN[1]:
        fail(f"mono known configuration loses the track at frame "
             f"{lost_from}, before the JAX package's {JAX_MONO_KNOWN[1]} "
             f"less {MONO_KNOWN_TOL:.0%}")
    if not abs(res["rmse"] - JAX_MONO_KNOWN[2]) \
            <= MONO_KNOWN_TOL * JAX_MONO_KNOWN[2]:
        fail(f"mono known configuration's ATE {res['rmse']:.5f} m is not "
             f"within {MONO_KNOWN_TOL:.0%} of the JAX package's "
             f"{JAX_MONO_KNOWN[2]} m")
    check_counts("mono known", launches_mono,
                 {"fast_nms_blend": n_mono, "gather_patches": 0,
                  "tail_fused": n_mono},
                 ("fused_best2", "fused_projection_best2"))

    # 8. where the time goes: the last frames of a shorter full-width run
    # under torch.profiler (after the counted runs, so it adds no launches
    # to their counts)
    n_prof, prof_from = 10, 6
    *_, (prof, prof_s) = run_sequence(torch, dev, 752, 1200, 8, n_prof,
                                      profile_from=prof_from)
    prof8 = summarize_profile(prof, prof_s, n_prof - prof_from)

    # 9. stereo blackout at full width: relocalization, at each noise seed
    from vieo_slam_tpu_torch.frontend.relocalization import try_relocalize

    launches_place = {}
    for seed in PLACE_SEEDS:
        tag = f"[9 stereo blackout, seed {seed}]"
        cuda_build.reset_launches()
        bo = run_row(torch, dev, "stereo_blackout", seed)
        launches_place["stereo_blackout", seed] = dict(cuda_build.LAUNCHES)
        system, states = bo["system"], bo["states"]
        rec = bo["recovered_at"]
        n_reloc = bo["report"]["counters"].get("reloc_success", 0)
        lost_after = sum(x == "LOST" for x in states[rec + 1:]) \
            if rec is not None else None
        first_ok = next((i for i in range(bo["bo"][1], bo["n"])
                         if states[i] == "OK"), None)
        n_rl, rl_mean, _ = stage_ms(bo["report"], "relocalize")
        log(f"{tag} {bo['n']} frames 752x480, 1200 features, 8 levels, "
            f"frames {bo['bo'][0]}-{bo['bo'][1] - 1} black: LOST "
            f"{states.count('LOST')} frames, {n_reloc} relocalizations of "
            f"{bo['report']['counters'].get('reloc_attempts', 0)} attempts, "
            f"first at frame {rec}, OK again from frame {first_ok}, LOST "
            f"after the first recovery {lost_after}; keyframe ATE after the "
            f"recovery {bo['ate_post_recovery']:.5f} m, whole run without / "
            f"with the final GBA {bo['ate_no_gba']:.5f} / "
            f"{bo['ate_gba']:.5f} m; {system.map.n_keyframes()} keyframes, "
            f"{system.map.n_landmarks()} landmarks; launches "
            f"{launches_place['stereo_blackout', seed]}, inside the "
            f"relocalization calls {bo['inside']['reloc']} "
            f"({bo['run_s']:.1f} s)")
        lcm = loop_closing_ms(bo)
        log(f"{tag} ms: relocalize {rl_mean:.2f} mean over {n_rl} calls, "
            f"final GBA {stage_ms(bo['report'], 'final_gba')[1]:.2f}, loop "
            f"closing {lcm['per_kf']:.2f} a keyframe over {lcm['n_kf']} "
            f"({lcm['rest_per_kf']:.2f} around verification, "
            f"{lcm['verify_calls']} verifications in {lcm['verify_ms']:.2f}), "
            f"stages { {k: v['mean'] for k, v in bo['report']['stages_ms'].items()} }")
        if not n_reloc or first_ok is None or first_ok > 53 or lost_after \
                or not bo["ate_post_recovery"] < 0.02:
            fail(f"stereo blackout, seed {seed}, misses its bars")
        jb = jax_run("stereo_blackout", seed)["numbers"]
        held = [("LOST frames", bo["numbers"]["n_lost"], jb["n_lost"], 1.0),
                ("relocalizations", bo["numbers"]["n_relocs"],
                 jb["n_relocs"], 1.0),
                ("whole-run keyframe ATE (final GBA)", bo["ate_gba"],
                 jb["rmse_fullBA"], 1e-3)]
        log(f"{tag} port / JAX package ({FULLWIDTH_REF}): " + ", ".join(
            f"{what} {v:.6g} / {w:.6g}" for what, v, w, _ in held)
            + f"; without the final GBA {bo['ate_no_gba']:.6g} / "
            f"{jb['rmse_noFullBA']:.6g}; keyframe ATE after the recovery "
            f"{bo['ate_post_recovery']:.6g} / {jb['rmse_postRecovery']:.6g}")
        for what, v, w, floor in held:
            if not near(v, w, floor):
                fail(f"stereo blackout, seed {seed}: {what} {v:.6g} is not "
                     f"within {REF_REL_TOL:.0%} or {floor:g} of the JAX "
                     f"package's {w:.6g}")
        if not (bo["inside"]["reloc"].get("fused_best2", 0) > 0
                and bo["inside"]["reloc"].get("fused_projection_best2", 0)
                > 0):
            fail(f"relocalization did not launch B3 and B4: "
                 f"{bo['inside']['reloc']}")
        if seed == PLACE_SEEDS[0]:
            ok, waits = host_waits(torch, lambda: try_relocalize(
                system, system.loop_closer, bo["last_frame"]))
            log(f"{tag} host waits of one relocalization (the recovery "
                f"frame again, {'recovered' if ok else 'not recovered'}): "
                f"{waits}")

    # 10. stereo loop at full width: loop closing and global BA
    seed = LOOP_SEED
    tag = f"[10 stereo loop, seed {seed}]"
    cuda_build.reset_launches()
    lp = run_row(torch, dev, "stereo_loop", seed)
    launches_place["stereo_loop", seed] = dict(cuda_build.LAUNCHES)
    system, states = lp["system"], lp["states"]
    lc = system.loop_closer
    rep = lp["report"]
    first = lp["closures"][0] if lp["closures"] else None
    log(f"{tag} {lp['n']} frames 752x480, 1200 features, 8 levels: "
        f"LOST {states.count('LOST')}, {lc.n_loops_closed} loops closed "
        f"(first: keyframe {first[0] if first else None} to "
        f"{first[1] if first else None}), {lc.total_fuse_count} points "
        f"fused; keyframe ATE before / after the first closure "
        f"{first[2] if first else float('nan'):.5f} / "
        f"{first[3] if first else float('nan'):.5f} m, without / with "
        f"the final GBA {lp['ate_no_gba']:.5f} / {lp['ate_gba']:.5f} m; "
        f"{system.map.n_keyframes()} keyframes, "
        f"{system.map.n_landmarks()} landmarks; launches "
        f"{launches_place['stereo_loop', seed]}, inside "
        f"process_keyframe {lp['inside']['loop']} ({lp['run_s']:.1f} s)")
    lcm = loop_closing_ms(lp)
    log(f"{tag} ms: loop closing {lcm['per_kf']:.2f} a keyframe over "
        f"{lcm['n_kf']} ({lcm['rest_per_kf']:.2f} around verification, "
        f"{lcm['verify_calls']} verifications in {lcm['verify_ms']:.2f}; "
        f"the closing keyframe {lcm['closing_kf']}; the closure hook's "
        f"{1e3 * sum(lp['hook_s']):.2f} taken out); (count, mean, total) "
        + ", ".join(f"{k} {stage_ms(rep, k)}" for k in (
            "loop_closing", "gba", "final_gba", "local_mapping", "track",
            "frame")))
    if states.count("LOST") or not lc.n_loops_closed \
            or not lc.total_fuse_count > 0 or not lp["ate_gba"] < 0.02:
        fail(f"stereo loop, seed {seed}, misses its bars")
    jl = jax_run("stereo_loop", seed)
    jfirst = jl["closures"][0]
    log(f"{tag} port / JAX package ({FULLWIDTH_REF}): loops closed "
        f"{lc.n_loops_closed} / {len(jl['closures'])}, first closure keyframe "
        f"{first[0]} / {jfirst['k']} to {first[1]} / {jfirst['c']}, keyframe "
        f"ATE before it {first[2]:.6g} / {jfirst['ate_before']:.6g} m, after "
        f"it {first[3]:.6g} / {jfirst['ate_after']:.6g} m; points fused "
        f"{lc.total_fuse_count} / {jl['numbers']['fused_points']:.0f}; ATE "
        f"without / with the final GBA {lp['ate_no_gba']:.6g} / "
        f"{lp['ate_gba']:.6g} m against {jl['numbers']['rmse_noFullBA']:.6g} "
        f"/ {jl['numbers']['rmse_fullBA']:.6g} m")
    if (first[0], first[1]) != (jfirst["k"], jfirst["c"]):
        fail(f"stereo loop, seed {seed}: the first closure is keyframe "
             f"{first[0]} to {first[1]}, not the JAX package's "
             f"{jfirst['k']} to {jfirst['c']}")
    if not near(first[3], jfirst["ate_after"], 1e-3):
        fail(f"stereo loop, seed {seed}: the keyframe ATE after the first "
             f"closure {first[3]:.6g} m is not within {REF_REL_TOL:.0%} or "
             f"1 mm of the JAX package's {jfirst['ate_after']:.6g} m")
    if not near(lp["ate_gba"], jl["numbers"]["rmse_fullBA"], 1e-3):
        fail(f"stereo loop, seed {seed}: the ATE with the final GBA "
             f"{lp['ate_gba']:.6g} m is not within {REF_REL_TOL:.0%} or 1 mm "
             f"of the JAX package's {jl['numbers']['rmse_fullBA']:.6g} m")
    if not (lp["inside"]["loop"].get("fused_best2", 0) > 0
            and lp["inside"]["loop"].get("fused_projection_best2", 0)
            > 0):
        fail(f"loop closing did not launch B3 and B4: "
             f"{lp['inside']['loop']}")
    # 11. stereo async: phase 5's cell with the mapping worker behind
    # tracking, free-running and in lockstep
    t0 = time.perf_counter()
    async_runs = {}
    for mode in ("free", "lockstep"):
        cuda_build.reset_launches()
        system, states, times, res, *_ = run_sequence(
            torch, dev, 752, 1200, 8, n_frames, async_mapping=True,
            lockstep=mode == "lockstep")
        launches_place["stereo_async_" + mode, None] = dict(
            cuda_build.LAUNCHES)
        tr = 1e3 * np.asarray(times[warm:])[:, 1]
        async_runs[mode] = dict(
            lost=sum(s.name == "LOST" for s in states), ate=res["rmse"],
            version=system.map.version, n_kf=system.map.n_keyframes(),
            track_med=np.median(tr), track_p99=np.percentile(tr, 99))
        system.shutdown()
    fr_, lk = async_runs["free"], async_runs["lockstep"]
    log(f"[11 stereo async] {n_frames} frames 752x480, 1200 features, 8 "
        f"levels, mapping on the worker: free-running LOST {fr_['lost']}, "
        f"ATE RMSE {fr_['ate']:.5f} m, map version {fr_['version']} over "
        f"{fr_['n_kf']} keyframes; lockstep LOST {lk['lost']}, ATE RMSE "
        f"{lk['ate']:.5f} m (phase 5, sync: {ate5:.5f} m); track ms with "
        f"mapping behind it after {warm} warm-up frames: free median "
        f"{fr_['track_med']:.2f}, p99 {fr_['track_p99']:.2f}; lockstep "
        f"median {lk['track_med']:.2f}, p99 {lk['track_p99']:.2f}; phase 5's "
        f"sync track {track5_ms:.2f} and whole frame {frame5_ms:.2f}; "
        f"launches {launches_place['stereo_async_free', None]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if fr_["lost"] or lk["lost"] or not fr_["version"] > fr_["n_kf"] \
            or not fr_["ate"] < 0.02 or not lk["ate"] <= 1.1 * ate5 + 5e-4:
        fail("stereo async misses its bars")
    for mode in ("free", "lockstep"):
        check_counts(f"stereo async {mode}",
                     launches_place["stereo_async_" + mode, None],
                     {"fast_nms_blend": n_frames, "gather_patches": n_frames,
                      "tail_fused": 0},
                     ("fused_best2", "fused_projection_best2"))

    # 12-14. stereo VIO: the stereo_vio, vio_blackout and vio_loop rows
    vio_path = ("fast_nms_blend", "gather_patches", "fused_best2",
                "fused_projection_best2")
    vio_ate = {}
    for phase, row in ((12, "stereo_vio"), (13, "vio_blackout"),
                       (14, "vio_loop")):
        tag = f"[{phase} {row}, seed 0]"
        cuda_build.reset_launches()
        out = run_row(torch, dev, row, 0,
                      profile=(53, 54) if row == "stereo_vio" else None,
                      n_frames=VIO_LOOP_FRAMES if row == "vio_loop" else None)
        launches_place[row, None] = dict(cuda_build.LAUNCHES)
        system, vio, states = out["system"], out["front"], out["states"]
        rep_ = out["report"]
        after = 1e3 * np.asarray(out["frame_s"][(out["init_at"] or 0) + 1:])
        n_odomok = states.count("ODOMOK")
        n_reloc = rep_["counters"].get("reloc_success", 0)
        log(f"{tag} {out['n']} frames 752x480, 1200 features, 8 levels: "
            f"VI init at frame {out['init_at']} (final: {vio.final_inited}), "
            f"|g| {np.linalg.norm(vio.gw):.4f}, bg {vio.bg} (true "
            f"{ev.VIO_BG}), ba {vio.ba} (true {ev.VIO_BA}); LOST "
            f"{states.count('LOST')}, ODOMOK {n_odomok}, relocalizations "
            f"{n_reloc}; ATE RMSE of the tracked frames "
            f"{out['ate_track']:.5f} m, keyframe ATE without / with the "
            f"final GBA {out['ate_no_gba']:.5f} / {out['ate_gba']:.5f} m; "
            f"{system.map.n_keyframes()} keyframes, "
            f"{system.map.n_landmarks()} landmarks; launches "
            f"{launches_place[row, None]} ({out['run_s']:.1f} s)")
        log(f"{tag} ms: whole frame after the init median "
            f"{np.median(after) if after.size else float('nan'):.2f}; "
            f"(count, mean, total) " + ", ".join(
                f"{k} {stage_ms(rep_, k)}" for k in (
                    "vio.preintegrate", "vio.fuse", "vio.init",
                    "vio.init_gba", "vio.local_ba", "track", "local_mapping",
                    "loop_closing", "gba", "final_gba", "frame")))
        check_counts(row, launches_place[row, None], {"tail_fused": 0},
                     vio_path)
        lost = states.count("LOST")
        vio_ate[row] = out["ate_no_gba"]
        if row == "stereo_vio":
            check_graphs(torch, tag, [
                ("the fused solve", g) for g in vio._fused.graphs.values()]
                + [(f"the preintegration of {g.inputs[0].shape[0]} samples",
                    g) for g in list(vio._preint.graphs.values())[:1]])
            if out["profile"] is not None:
                p12 = summarize_profile(*out["profile"], tag=tag, top=5)
                if p12 is not None and prof8 is not None:
                    log(f"{tag} device ops a fused frame {p12['ops']:.0f} "
                        f"against phase 8's {prof8['ops']:.0f} (stereo, no "
                        f"IMU); device busy {p12['busy_ms']:.2f} against "
                        f"{prof8['busy_ms']:.2f} ms a frame")
            if not vio.inited or abs(np.linalg.norm(vio.gw) - 9.81) > 0.05 \
                    or np.abs(vio.bg - ev.VIO_BG).max() > 1.2e-2 or lost \
                    or not out["ate_no_gba"] < 0.02:
                fail("stereo_vio misses its bars")
        elif row == "vio_blackout":
            b0, b1 = out["bo"]
            black = states[b0:b1]
            ok_from = all(x == "OK" for x in states[b1 + 2:])
            log(f"{tag} frames {b0}-{b1 - 1} black: {black.count('ODOMOK')} "
                f"of them ODOMOK, OK from frame {b1 + 2} on: {ok_from}; "
                f"keyframe ATE after the recovery "
                f"{out['ate_post_recovery']:.5f} m")
            if lost or black.count("ODOMOK") != len(black) or n_reloc \
                    or not ok_from or not out["ate_post_recovery"] < 0.02:
                fail("vio_blackout misses its bars")
        else:
            lc = system.loop_closer
            first = out["closures"][0] if out["closures"] else None
            n_lba = stage_ms(rep_, "vio.local_ba")[0]
            lcm = loop_closing_ms(out)
            log(f"{tag} {lc.n_loops_closed} loops closed, "
                f"{lc.total_fuse_count} points fused; keyframe ATE before / "
                f"after the first closure "
                f"{first[2] if first else float('nan'):.5f} / "
                f"{first[3] if first else float('nan'):.5f} m; PRV window "
                f"BA {n_lba} times; loop closing {lcm['per_kf']:.2f} ms a "
                f"keyframe over {lcm['n_kf']} (the closing keyframe "
                f"{lcm['closing_kf']})")
            check_graphs(torch, tag, chain_graphs(vio.backend._chain_graph))
            if lost or not vio.final_inited or n_lba < 1 \
                    or lc.n_loops_closed != 1 or not lc.total_fuse_count > 0 \
                    or not out["ate_gba"] < 0.02:
                fail("vio_loop misses its bars")

    # 15. stereo_vio over the async mapping worker: the window BA on the
    # worker, its chain-block graphs captured there while tracking goes on
    tag = "[15 stereo_vio async, seed 0]"
    cuda_build.reset_launches()
    out = run_row(torch, dev, "stereo_vio", 0, async_mapping=True,
                  vio_cfg=dict(init_final_span=VIO_ASYNC_FINAL_SPAN))
    launches_place["stereo_vio_async", None] = dict(cuda_build.LAUNCHES)
    vio, states = out["front"], out["states"]
    threads = out["window_ba_threads"]
    chain = [] if vio.backend is None else \
        chain_graphs(vio.backend._chain_graph)
    on_worker = [g for _, g in chain if g.replays["local-mapping"]]
    after = 1e3 * np.asarray(out["frame_s"][(out["init_at"] or 0) + 1:])
    log(f"{tag} {out['n']} frames 752x480, 1200 features, 8 levels, "
        f"mapping on the worker, final init after "
        f"{VIO_ASYNC_FINAL_SPAN} s of keyframes: VI init at frame "
        f"{out['init_at']} (final: {vio.final_inited}), |g| "
        f"{np.linalg.norm(vio.gw):.4f}, bg {vio.bg}; LOST "
        f"{states.count('LOST')}, ODOMOK {states.count('ODOMOK')}; keyframe "
        f"ATE {out['ate_no_gba']:.5f} m (phase 12, sync: "
        f"{vio_ate['stereo_vio']:.5f} m); PRV window BA {len(threads)} "
        f"times, on threads {sorted(set(threads))}; {len(on_worker)} of "
        f"{len(chain)} chain-block graphs replayed on the worker; whole "
        f"frame after the init median "
        f"{np.median(after) if after.size else float('nan'):.2f} ms; "
        f"launches {launches_place['stereo_vio_async', None]} "
        f"({out['run_s']:.1f} s)")
    check_counts("stereo_vio async", launches_place["stereo_vio_async", None],
                 {"tail_fused": 0}, vio_path)
    check_graphs(torch, tag, [
        ("the fused solve", g) for g in vio._fused.graphs.values()]
        + [(f"the preintegration of {g.inputs[0].shape[0]} samples", g)
           for g in vio._preint.graphs.values()] + chain)
    if states.count("LOST") or not vio.final_inited or not threads \
            or set(threads) != {"local-mapping"} or not on_worker \
            or abs(np.linalg.norm(vio.gw) - 9.81) > 0.05 \
            or np.abs(vio.bg - ev.VIO_BG).max() > 1.2e-2 \
            or not out["ate_no_gba"] < 0.02:
        fail("stereo_vio async misses its bars")

    # 16-20. distorted rigs, wheel encoder, map reuse
    rig_kernels = rig_encoder_reuse_phases(torch, dev, launches_place,
                                           vio_ate["stereo_vio"])

    # 21. distributed GBA on phase 10's map
    launches_place["distributed_gba", None] = distributed_gba_phase(
        torch, dev, lp)
    # the host cost of the kernel wrappers' device guard, a launch and
    # over every launch the run counted
    x, n_guard = torch.empty(1, device=dev), 20000
    t0 = time.perf_counter()
    for _ in range(n_guard):
        with cuda_build.on_device(x):
            pass
    guard_us = 1e6 * (time.perf_counter() - t0) / n_guard
    n_counted = sum(sum(c.values()) for c in (
        launches, launches_rgbd, launches_mono, *launches_place.values()))
    log(f"[21 distributed GBA] the kernel wrappers' device guard "
        f"(cuda_build.on_device): {guard_us:.3f} us a launch, "
        f"{1e-3 * guard_us * n_counted:.2f} ms over the {n_counted} "
        f"launches counted in this run")
    # 22. supporting code: run_euroc from a EuRoC folder, the stereo_lem
    # row with the viewer, the selection paths, mutual_filter, entry()
    supporting_code_phase(torch, dev, launches_place)
    # 23. the RANSAC draws on the card against the CPU; the start of the
    # mono_loop row
    draw_parity_phase(torch, dev)
    # 24. the card's extraction against the JAX package's bits
    extraction_bits_phase(torch, dev)

    meta = {
        "fast_nms_blend": ("fast_nms.cu", "vieo_slam_tpu/ops/pallas_fast.py:99",
                           "B1"),
        "gather_patches": ("gather.cu", "vieo_slam_tpu/ops/pallas_gather.py:73",
                           "B2"),
        "fused_best2": ("matching.cu",
                        "vieo_slam_tpu/ops/pallas_matching.py:246", "B3"),
        "fused_projection_best2": (
            "matching.cu", "vieo_slam_tpu/ops/pallas_matching.py:166", "B4"),
        "tail_fused": ("tail.cu", "vieo_slam_tpu/ops/pallas_tail.py:180",
                       "B5"),
    }
    # `launches`: B1-B4 as counted over the stereo full-width run, B5 over
    # the RGB-D full-width run (the stereo run keeps the default tail);
    # `launches_by_path` has every counted run.  Phases 9 and 10 are the
    # place-recognition path's counted runs.
    kernels = []
    for k, (src, replaces, _) in meta.items():
        r = rows[k]
        by_path = {"stereo_full_width": launches[k],
                   "rgbd_full_width": launches_rgbd[k],
                   "mono_known": launches_mono[k]}
        for (path, seed), counts in launches_place.items():
            by_path[path if seed in (None, PLACE_SEEDS[0])
                    else f"{path}_seed{seed}"] = counts[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"vieo_slam_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches_rgbd[k] if k == "tail_fused"
            else launches[k], "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            "device_ms": r["device_ms"],
            **{x: r[x] for x in ("pair_ms", "pair_device_ms", "candidates",
                                 "survivors", "corners") if x in r},
            "rig": {case: r for case, r in rig_kernels.items()
                    if case.split()[0] == meta[k][2]}})
    log(f"[done] phases 1-24 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
