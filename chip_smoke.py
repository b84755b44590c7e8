#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sqrtlm_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. build the hand-written kernels K1 (csrc/hamming.cu) and K2 with its
     chi2-only instance K3 (csrc/ba_assembly.cu) with nvcc for sm_90a, one
     compiler per source, started together;
  2. K1 against its plain PyTorch version on random full-32-bit
     descriptors at the main path's shapes and at ragged ones (1x1, 37x5,
     129x2047, 2047x129) — exactly equal — with both times; at the main
     shapes also the library yardstick, one cuBLAS `addmm` on the
     descriptors unpacked to +-1 in float16 (checked equal to K1 first; the
     unpack timed apart; the port never calls it);
  3. K2 against its plain version at (P, L, K) = (32, 4096, 8),
     (96, 8192, 5) and (1400, 60000, 7) (past the ~954 poses of K2's first
     design), and past 16 slots per landmark at (32, 4096, 24),
     (96, 8192, 32), (96, 4096, 64) and the dense (64, 4096, 64) and
     (96, 2048, 96) (with the number of U chunks per block), with and
     without the Huber kernel, at rtol 5e-3 / atol 5e-4, bitwise
     repeatable, with both times and the largest camera group of the
     camera pass;
  4. the main path at KITTI size: `SlamSystem.track_depth` over 16 frames of
     a synthetic world rendered at 1226x370 with the KITTI 00-02
     intrinsics, 2000 ORB features, default tracking and mapping configs.
     Launch counters are zeroed just before and read just after; every
     frame must track, with >= 3 keyframes, >= 1 local BA, both kernels
     launched, ATE < 0.05 m;
  5. the tracking shape of bench.py (240x320, 1000 features, 16 frames);
  6. local-BA LM iterations/s at the bench.py shape (P=96, L=8192, 5
     observations per landmark, Huber 2.447, 15 iterations per call, 5
     chained calls, one synchronize, best of 3); chi2 must fall;
  7. K3 against its plain version at (P, L, K) = (96, 8192, 5) (the bench
     problem), (600, 120000, 7) (phase 8's global-BA problem), and
     (1400, 60000, 7) and (6000, 60000, 7) (phase 3's generator: KITTI 00's
     keyframe count, and past the ~4,460 poses of K3's first design), and
     at phase 3's shapes past 16 slots per landmark, with and without the
     Huber kernel: rtol 1e-4 against the plain version evaluated in
     float64, bitwise repeatable, bitwise equal to K2's chi2 on the same
     inputs (past 16 slots also at L = 1, 127, 129), with both times, and
     with Huber K2's time at the same shape split by kernel (its landmark
     pass beside K3);
  8. global BA at scale (benchmarks/bench_scale.py's flow): 600 keyframes,
     1.2e5 landmarks, 5 observations each, drift 4e-4; the true loop edge
     through the essential graph (edge_cap 16384, 30 iterations), then 10 LM
     iterations of `LoopCloser.run_global_ba`. Counters zeroed just before
     the GBA and read just after; the ATE at each stage (drift, essential
     graph, GBA) must lie within 1e-3 m of 0.5363 / 0.1349 / 0.0951, chi2
     must fall, K2 and K3 must launch, and a second GBA from the same store
     must give bitwise-equal poses and landmarks. The essential graph and
     the GBA each run graphed (the first call captures: one Gauss-Newton
     step a graph; one LM iteration a graph), graphed again (replays only)
     and eagerly (`disable_graphs`): seconds, captures, replays and host
     reads of each, the memory the first call's captures keep
     (`memory_reserved` after `empty_cache`), and the three bitwise equal;
  9. the loop path end to end: `SlamSystem(..., loop_detection=True)` over
     the ring scene of tests/test_e2e_loop.py (ring_world(7, 2500), the
     first 148 of its 160 frames at frac 1.3, 240x320, 600 features, default
     LoopClosingConfig). Counters zeroed just before and read just after;
     all but 2 frames tracked,
     >= 1 loop closed, >= 20 landmarks fused, ATE < 0.3 m, K3 launched
     inside the loop's global BA. The frame that commits the loop is split
     by the loop corrector's calls, each bracketed by synchronizes:
     detection, Sim3, `correct_loop` (the essential graph, the fuse and, in
     sync mode, the GBA), with the Sim3 verification's graph captures,
     replays and host reads. Then the same ring with the loop corrector's
     calls run eagerly (`disable_graphs` around each) and the same split;
     its trajectory, keyframe poses and landmarks must equal the graphed
     ring's bit for bit. The loop frame's last `compute_sim3` call is run
     again on the final store, graphed and eagerly, three times each and
     then under torch.profiler (ms, CUDA launches, device ms, host reads),
     and the further `compute_sim3` calls after which the ring's graphed
     Sim3 total (its captures included) drops to the eager ring's.
 10. camera+LiDAR fusion at KITTI size: `SlamSystem.track_fusion` over 28
     frames of the street circuit of eval/planeworld.py
     (street_circuit_world(seed=0), circuit_trajectory(step=0.8) from 54 m
     along the first 60 m straight, so the window turns >= 30 degrees
     through the first corner; the yaw it turns is printed) rendered
     at 1226x370 with the KITTI 00-02 intrinsics, 2000 ORB features, the
     default LidarConfig (64 rings x 1800 columns) and TrackingConfig, scans
     of 64 rings x 1800 rays (~114,000 points; the rays centred on the
     range image's columns, `planeworld.center_scan_on_columns`), T_CAM_VELO.
     Run three times: graphed (the entry point's default) timed per frame
     with the launch counters zeroed just before and read just after (the
     slowest frame against the median, the keyframe frames' ms); graphed
     with local mapping's steps bracketed by synchronizes
     (`process_keyframe` split into triangulation, fuse, local BA and the
     LiDAR stage); eagerly (`utils.cache.disable_graphs`) with every stage
     bracketed (frame build split into ORB | LiDAR features | cloud
     projection + depth association, the tracking step, local mapping's
     steps; launches and idle share per frame: phase 18). Every frame must
     track in each, with >= 2 keyframes, ATE < 0.5 m, > 20 LiDAR
     associations on every steady frame, the LiDAR stage of local BA run
     at least once, K1 and K2 launched, and the three runs' trajectories,
     keyframe poses and landmarks bitwise equal;
 11. relocalisation on the same sequence: `recover_pose_no_prior` six
     times from one generator graphed (the first call captures, unless the
     run captured it before) and six times eagerly (`disable_graphs`), each
     timed to its read: ms cold and warm, captures, replays and host reads
     per recovery, CUDA launches and device ms of one more of each under
     torch.profiler, the graphed poses and counts bitwise equal to the
     eager ones, and the further recoveries after which the capture has
     paid for itself (K1's launches and the host reads of the eager and
     profiled comparison runs are left out of the path's counts); the map
     saved, `SlamSystem.load`ed on the card and a
     frame of the sequence fed in localisation mode (it must relocalise
     within 0.5 m of the ground truth and insert no keyframe); then, in the
     running system (> 5 keyframes), two frames with a blank image -> LOST
     -> recovery within two frames of vision returning.
 12. stereo at KITTI size: the first 16 frames of phase 10's street with
     right images rendered from the camera moved by the baseline b = bf / fx
     along x, through `SlamSystem.track_stereo` (phase 4's world of random
     binary patches gives the stereo matcher too many mismatches at this
     width: its first frame stalls, in the JAX package too; PERF.md section
     6). Counters zeroed just before and read just
     after; >= 13/16 tracked, median relative stereo depth error < 0.06 on
     frame 0 against the rendered depth, ATE < 0.1 m, K1 launched > 16 times;
     ms, kernel launches and host reads per frame, the slowest frame against
     the median and the keyframe frames' ms;
 13. monocular at KITTI size: phase 4's left images through
     `SlamSystem.track_monocular` (tests/test_e2e_mono.py's tracking config).
     Counters zeroed just before and read just after; >= 2 keyframes, > 80
     landmarks, >= 12/16 tracked, Sim3-aligned ATE < 0.4 m, K1 launched; the
     initialization frame and its ms, `used_homography`, and
     `initialize_two_view` timed cold (its first call, in the run: the
     graph's warm-up, capture and replay) and warm (again on the same
     inputs); the initializer's graph against its eager body on the same
     inputs and draws (bitwise equal, one replay and no host read), the
     CUDA launches and device ms of one call of each (torch.profiler), no
     SVD kernel among them (solver kernels listed); and a fresh process that
     runs only the monocular path up to the initialization
     (`mono_fresh_process`): its first `initialize_two_view` ms;
 14. standalone LiDAR odometry: `LidarOdometry.process` over the 28 fusion
     scans in the LiDAR frame (the corner included), run three times
     (graphed, graphed with its stages bracketed, eagerly): ATE < 0.5 m
     against the LiDAR-frame ground truth, > 100 associations per scan
     after the first, the three runs' poses bitwise equal, at most one
     `align_scan` capture; ms per scan (graphed and eager) split into
     feature extraction and alignment, CUDA launches, device ms and idle
     share per scan graphed and eager, and the padded scan sizes; then
     `backend_for_loop` with the true first-to-last relative pose must cut
     the end drift below 0.3 x: graphed (one Gauss-Newton step a graph;
     the first call captures), again and eagerly from the same chain, the
     three bitwise equal (`backend_ms`: the first call).
 15. the KITTI runner (`python -m sqrtlm_slam_tpu_torch.run_kitti`): 20
     frames of `eval/kitti_synth.generate` (1226x370, the street circuit
     from its start) in a directory under build/, the velodyne scans
     rewritten as 64 x 1800-ray scans centred on the columns (and Tr with
     them; the generator's 1440-ray scans give no LiDAR feature). The zlib
     PNG decoder is held equal to PIL there, and the native loader must
     build where libpng's header is installed. Then `run_kitti.main` in
     process, counters zeroed before and read after each run: (a) `--mode
     fusion --checkpoint` (every frame tracked, ATE < 0.5 m, >= 2
     keyframes, > 20 LiDAR associations on steady frames, K1 and K2
     launched); (b) `--async-mapping --pipelined`, then each alone, then
     sync again (ms per frame, also over the calls that inserted no
     keyframe, the share of step reads after which the device still had
     work queued: the next frame overlapping this frame's host
     bookkeeping; but for async alone the last 3 frames under
     torch.profiler: device ms, idle share, CUDA launches per frame) (every
     frame tracked, ATE < 0.5 m, the worker's queue
     drained and the worker joined); (c) `--resume` from (a)'s map over 4 frames (relocalised or
     re-initialised by the > 5-keyframe rule, reported); (d) `--mode lidar
     --json` as a subprocess (ATE < 0.5 m). Each run prints ms per frame,
     `wall_s`, host reads per frame, the loader and its ms per frame.
 16. the flat engine and distributed BA (`flat_and_distributed_phase`, also
     callable alone): (a) `Optimizer("flat").local_bundle_adjustment` against
     "bucketed" on the bench problem (96, 8192, 5): chi2 rtol 1e-3,
     survivors within 0.5%; both against the float64 optimum (the flat
     engine in float64 on the card; the engines agree to 1e-10 in float64,
     tests/test_torch_flat.py): bucketed pose_t 5e-3 and landmarks seen from
     >= 2 cameras 2e-2, flat 0.1 / 0.5 m (it forms W Hll^-1 W^T explicitly
     in float32); each backend (and "cg") graphed and eagerly: ms per call,
     captures, replays and host reads, bitwise equal, chi2 falling, the flat
     and cg backends replaying their graphs; phase 4's frames and on along
     its path, 40 in all, with `LocalMappingConfig(backend="flat")` and with
     "cg" (every frame tracked, >= 4 local BA, ATE < 0.05 m; K1, K2 and K3
     launched on the cg run; the captures of local BA's graphs in each
     local BA, none in the second half of the run's windows); the flat `global_ba` on the ring's GBA problem and
     `schur.global_ba_cg` (3 LM iterations) on phase 8's, graphed (first
     call and a replayed one) against eager: chi2 falls, bitwise equal;
     `calibrate_extrinsics` on 4096 points of phase 10's first scan from
     T_CAM_VELO perturbed, with and without plane terms, graphed against
     eager (bitwise equal, within 1e-3 of T_CAM_VELO); (b) the
     distributed Nielsen LM in process on the bench problem, 15 iterations,
     Huber 2.447, over 1, 2 and 4 shards on cuda:0 (the whole loop one
     graph): a first call (it captures) and a second (one replay, no
     capture, or the phase raises; bitwise equal to the first and to the
     eager call under `disable_graphs`), chi2 falling, 2 and 4 shards
     against 1 within tests/test_dist_ba.py's gates (accepted within 1,
     chi2 rtol 0.05, pose_t 5e-3, landmarks 2e-2), K2 launched D times per
     iteration and K3 D times per chi2 evaluation in the replayed call, ms
     per LM iteration graphed, through the segment graphs (bitwise equal
     to the whole loop) and eagerly, CUDA launches and device ms of a call
     graphed and eager (torch.profiler), the memory a capture keeps; the
     bucketed and the flat steps over 4 shards (3 a call, one graph a
     step): bitwise equal to eager, ms per step, host reads (the flat
     engine's edge plans, once a call); one flat distributed step over 4
     shards against the single-device flat step (mu 1e-3; pose_t 5e-4,
     landmarks 5e-3); (c) `python -m
     sqrtlm_slam_tpu_torch.parallel.mp_worker` at the JAX dryrun's shape
     (64, 16384, 4), 6 iterations: 2 processes x 2 shards with gloo on
     cuda:0 (per-device segment graphs, the all-reduces between them), and
     1 process x 4 shards with nccl (the whole loop one graph), each
     against the in-process 4-shard run (the same gates), every rank's
     result bitwise equal, and per rank the first call's seconds and
     captures, the timed call's wall seconds, captures (none) and replays,
     CUDA launches of a call graphed and eager, the eager call's wall
     seconds and its digest equal to the graphed one's, the all-reduce ms
     per iteration; (d) phase 7's (600, 120000, 7) problem, 3 iterations
     over 4 shards and over 1: a call that captures, one replay and an
     eager call, bitwise equal, chi2 falls, the two within the gates of
     (b), ms per iteration, peak device memory of each call and the memory
     the capture keeps.
 17. more than 16 slots per landmark on the callers (`wide_k_phase`, also
     callable alone): (a) phase 4's first 10 frames with
     `LocalMappingConfig(obs_cap=24)` (every frame tracked, >= 1 local BA,
     K2 called with 24 slots only, ATE < 0.05 m); (b) global BA (10 LM
     iterations) from a scale store with `obs_per_landmark=32` (800
     keyframes, 8,000 landmarks seen by 30 each) saved and loaded through
     `mapstore/checkpoint`: chi2 falls, K2 and K3 launch,
     a second GBA from a second load bitwise equal.
 18. the captured CUDA graphs (`graphs_phase`, also callable alone): the
     entry points replay graphs by default (phases 4-17 ran graphed; each of
     phases 4, 10 and 12-14 reports its graph captures and replays). (b) the
     RGB-D, stereo, monocular, fusion and LiDAR-odometry paths over 16
     frames (scans) each, graphed and eagerly (`disable_graphs`; the eager
     stereo, fusion and odometry runs over 10): ms per
     frame, CUDA launches (kernel launches plus graph launches), device ms
     and idle share from torch.profiler over the last 2, graph captures,
     replays and host reads per frame; (a) every captured function (the
     RGB-D, monocular, fusion and stereo builds, `extract_features_jit` of a
     padded 64 x 1800-ray scan, the tracking step's stage A, pipelined
     mode's stage A at both radii and stages B + C plain and fused, local
     BA, `align_scan` and the odometry's graphed `retract` / `local_delta`,
     `match_and_triangulate`, `_project_and_match` and
     `_project_and_match_many`, the monocular initializer) replayed on the
     KITTI-size inputs of its last call in (b) against its eager run:
     bitwise equal, or the phase raises; each with the device memory a
     fresh capture of it keeps (`memory_reserved` after `empty_cache`,
     before and after), and the fuse's 24-wide graph against 24 single
     replays; (c) phase 4's 16 frames graphed (phase 4's system and (b)'s)
     and eagerly, and (b)'s monocular runs: trajectories, keyframe poses
     and landmarks bitwise equal; (d) the tracking step's
     stage A as three graphs with the inlier read between them (sync mode)
     and as one graph running both radii with a `torch.where` select
     (pipelined mode): wall and CUDA-event ms per step, with and without
     the retry, both bitwise equal to the eager step; (e) the loop
     correction's graphs (a Gauss-Newton step of the essential graph at
     600 keyframes and at the ring's loop, the three graphs of global BA's
     LM iteration on phase 8's and the ring's problems, a step of phase
     14's LiDAR pose graph) and relocalisation's and the Sim3
     verification's (`recover_pose_no_prior`'s core on phase 11's last
     call; `ransac_sim3`'s core, `optimize_sim3`, `project_match` and
     `guided_sim3_match` on the ring's last calls in phase 9, with their
     CUDA launches per call replayed and eager), and the flat engine's LM
     loop (local and global captures) and three PCG graphs, the cg
     backend's local-BA graphs, distributed BA's graphs over 4 shards (the
     whole LM loop, the bucketed and flat steps, the eight segments; bench
     problem) and the calibration with and without plane terms, replayed
     against their eager runs as in (a), and
     global BA's two PCG designs ((a) all 100 PCG
     iterations in one graph of the whole LM iteration, no read, built
     here; (b) the port's, a read every 10) timed in turns on the ring's
     and phase 8's problems, bitwise equal.
Then the kernel summary line (each kernel's launches on the main path (K1
and K2: the fusion run; K3: the ring loop; `launches_by_path` has every
path's count, the runner's from run (a), `dist_ba` from phase 16 (b)'s
replayed 4-shard call, `cg_local_ba` from phase 16 (a)'s KITTI-size run with
the cg backend, `graphs_paths` from phase 18 (b)'s graphed runs; a
captured graph adds its kernels' launches at each replay), its
time, its plain version's, its bound from this run's shapes and, where one
PyTorch call computes the same function, that call's time), the card line,
and the final status line.

Imports nothing of JAX and nothing of the JAX package; inputs are made
from seeds with numpy. Needs `torch.cuda.is_available()`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

CARD = ""
KITTI_W, KITTI_H = 1226, 370
# KITTI 00-02 intrinsics (cfg/KITTI00-02.yaml; sqrtlm_slam_tpu/eval/kitti_synth.py).
KITTI_INTRINSICS = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)
K2_RTOL, K2_ATOL = 5e-3, 5e-4
K3_RTOL = 1e-4
# Global BA at scale: ATE (m) after the drift, the essential graph and GBA,
# as this flow gives them (first measured on the H100, float32 throughout).
GBA_ATE_STAGES = (0.5363, 0.1349, 0.0951)
GBA_ATE_TOL = 1e-3
# The fusion window starts this far along the circuit's first 60 m straight,
# so its 28 frames at 0.8 m (slowed to 0.36 m in the corner) turn ~35 degrees.
FUSION_START_S = 54.0
# Phase 16's KITTI-size RGB-D frames on the flat and cg backends: phase 4's
# 16 and on along its path, enough keyframes for several local BA windows.
BACKEND_FRAMES = 40
# The least time a kernel could take: NVIDIA H100 SXM peaks (data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores
INT8_OP_PER_S = 1979e12  # tensor cores, dense
# Float32 operations per slot of the BA assembly, counted from its formulas:
# projection, residual and Huber weight ~45, Jacobians ~110, Hll + bl ~110,
# U ~160; per active slot the camera sums Jp^T w Jp (upper triangle) and
# Jp^T w r ~180. K3 is the first ~45 alone.
K2_FLOP_SLOT, K2_FLOP_CAMERA, K3_FLOP_SLOT = 430, 180, 45
# More than 16 slots per landmark (phases 3 and 7): the local-BA shape of
# LocalMappingConfig(obs_cap=24), a global-BA-like problem at MapStore's
# obs_per_landmark=32, 64 slots, and dense problems (K = P: every pose sees
# every landmark, eval/synthetic.make_ba_problem(obs_per_landmark=0)). The
# sparse ones clip a landmark's slots at the chain's last pose, which then
# holds tens of thousands of slots; the dense ones hold L slots a camera.
WIDE_K_SHAPES = ((32, 4096, 24), (96, 8192, 32), (96, 4096, 64), (64, 4096, 64),
                 (96, 2048, 96))


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields,
                      "elapsed_s": time.perf_counter() - T_START}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median time of one call of `fn` in ms, CUDA events around each call:
    the device time plus any gap while the host dispatches (a wrapper's
    Python work idles the card for tens of microseconds)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, n: int = 20, warm: int = 3, by_kernel: bool = False):
    """Device time of one call of `fn` in ms: the summed time of the kernels
    (and copies) it runs on the card, from torch.profiler, over `n` calls.
    Host dispatch gaps between them are not counted. With `by_kernel`, also
    {kernel name: ms per call}.

    The tracer now and then returns a window without any device row, mostly
    for windows of a few microsecond kernels and several windows in a row.
    Such a window is taken again after a pause; if five in a row hold none,
    the call is timed with CUDA events (`cuda_ms`, host gaps included) and
    no per-kernel split is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in rows)
        if us > 0:
            break
        print(json.dumps({"phase": "profiler_window_empty", "attempt": attempt}), flush=True)
        time.sleep(0.1 * (attempt + 1))
    else:
        ms = cuda_ms(fn, n, warm=0)
        print(json.dumps({"phase": "profiler_window_empty", "timed_with": "cuda_events",
                          "ms": ms}), flush=True)
        return (ms, {}) if by_kernel else ms
    if by_kernel:
        return us / 1e3 / n, {e.key[:60]: e.self_device_time_total / 1e3 / n for e in rows}
    return us / 1e3 / n


def timed_ms(fn, n: int = 20) -> dict:
    """Device time (ms) per kernel and in all, and the event-timed call
    (call_ms) of `fn`."""
    ms, per_kernel = device_ms(fn, n, by_kernel=True)
    return {"ms": ms, "per_kernel_ms": per_kernel, "call_ms": cuda_ms(fn, n)}


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """Least time (ms) for `nbytes` of memory traffic and `ops` operations
    at `rate` per second, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k1_bound(Q: int, T: int) -> dict:
    # Descriptors read once (32 bytes a row), the int32 matrix written once;
    # 2 * 256 int8 operations per output on the tensor cores.
    return bound(32 * (Q + T) + 4 * Q * T, 2 * 256 * Q * T, INT8_OP_PER_S)


def k2_bound(P: int, L: int, K: int, n_active: int) -> dict:
    # In: poses (52 B), points (12 B), per slot camera + uvr + weight (20 B),
    # the camera plan (4 B per camera and per active slot). Out: Hll + bl
    # (48 B per landmark), U (72 B per slot), Hpp + bp (168 B per camera).
    nbytes = 52 * P + 12 * L + 20 * L * K + 4 * (P + 1 + n_active) \
        + 48 * L + 72 * L * K + 168 * P + 4
    return bound(nbytes, K2_FLOP_SLOT * L * K + K2_FLOP_CAMERA * n_active, F32_FLOP_PER_S)


def k3_bound(P: int, L: int, K: int) -> dict:
    return bound(48 * P + 12 * L + 20 * L * K + 4, K3_FLOP_SLOT * L * K, F32_FLOP_PER_S)


def lm_chunks(K: int) -> int:
    # K2's landmark pass goes through a landmark's slots in chunks of at most
    # 16 (csrc/ba_assembly.cu, kLmChunk); K3 in chunks of at most 64.
    return -(-K // 16)


def chi2_chunks(K: int) -> int:
    return -(-K // 64)


def pm1_half(desc):
    """(N, 8) int32 descriptors -> (N, 256) float16 of +1 (bit clear) and -1
    (bit set), bit j of word w at column 32 w + j: the operand of the
    library yardstick for K1."""
    import torch

    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).reshape(desc.shape[0], 256).to(torch.float16)


def gt_cam_to_world(poses) -> np.ndarray:
    out = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        out.append(np.linalg.inv(M))
    return np.stack(out)


def camera_center(pose) -> np.ndarray:
    """World position of the camera of a T_cw pose (tensors or arrays)."""
    R = np.asarray(pose.R.cpu() if hasattr(pose.R, "cpu") else pose.R, np.float64)
    t = np.asarray(pose.t.cpu() if hasattr(pose.t, "cpu") else pose.t, np.float64)
    return -R.T @ t


def yaw_deg(pose) -> float:
    """Heading of a T_cw pose's optical axis in the world's x-z plane."""
    f = np.asarray(pose.R, np.float64).T @ np.array([0.0, 0.0, 1.0])
    return float(np.degrees(np.arctan2(f[0], f[2])))


def staged_into(record: dict, name: str, fn):
    """`fn` bracketed by synchronizes, its seconds appended to record[name]."""
    import torch

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        record.setdefault(name, []).append(time.perf_counter() - t)
        return out
    return wrapper


_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


class ProfiledSpan:
    """torch.profiler (CUDA activity: kernels, copies and the CUDA runtime
    calls) between `start()` and `stop()`, read from its Chrome trace:
    kernel launches, graph launches (`cudaGraphLaunch`, one a replay), CUDA
    launches (both), device ms (kernels, copies, memsets) and wall s. The
    trace is read as JSON: parsing a window of ~10^5 kernels into profiler
    events takes minutes."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """The counts of the stopped span (its trace written and parsed)."""
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            f"chip_smoke_trace_{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        kernels = sum(1 for e in events if e.get("name") in _KERNEL_LAUNCHES)
        graphs = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
        dev_us = sum(e.get("dur", 0) for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        return dict(kernel_launches=kernels, graph_launches=graphs,
                    cuda_launches=kernels + graphs, device_ms=dev_us / 1e3, wall_s=self.wall,
                    kernel_names=names)


def profile_window(fn) -> dict:
    """Run `fn` under a `ProfiledSpan`: its counts, and fn's result as `out`."""
    span = ProfiledSpan()
    span.start()
    try:
        out = fn()
    finally:
        span.stop()
    return dict(span.read(), out=out)


def run_sequence(SlamSystem, cfg, cam, frames, device, time_from: int):
    """Track `frames`; returns (system, per-frame seconds, tracked count)."""
    import torch

    system = SlamSystem(cam, cfg, device=device)
    seconds, tracked = [], 0
    for img, depth in frames:
        t0 = time.perf_counter()
        pose = system.track_depth(img, depth)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        tracked += pose is not None
    return system, seconds[time_from:], tracked


def kitti_runner_phase(n_frames: int = 20, street=None, device: str = "cuda") -> dict:
    """15. The KITTI runner (`sqrtlm_slam_tpu_torch/run_kitti.py`) on a
    KITTI-layout sequence written by `eval/kitti_synth.generate`, in process
    through `run_kitti.main` (counters zeroed before and read after each run)
    and once as `python -m` in a subprocess. Returns the runs' records.
    `device="cpu"` rehearses it without a card."""
    import shutil

    import torch
    from sqrtlm_slam_tpu_torch import run_kitti, utils
    from sqrtlm_slam_tpu_torch.eval import kitti_synth, planeworld
    from sqrtlm_slam_tpu_torch.io import kitti as kitti_io
    from sqrtlm_slam_tpu_torch.io import native_loader, png
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly
    from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
    from sqrtlm_slam_tpu_torch.pipeline import tracking as tracking_mod

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "build", "chip_smoke_kitti")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    seq_dir = os.path.join(root, "sequences", "00")
    t0 = time.perf_counter()
    kitti_synth.generate(root, seq="00", n_frames=n_frames, seed=0, step=0.8,
                         log=lambda *a: None)
    generate_s = time.perf_counter() - t0
    # The generator's 1440-ray scans give no LiDAR feature under the default
    # LidarConfig (a fault of the reference): rescan with 64 x 1800 rays
    # centred on the range image's columns, and write the extrinsics that
    # the half-column yaw implies into calib.txt.
    t0 = time.perf_counter()
    street = street if street is not None else planeworld.street_circuit_world(seed=0)
    poses, _ = planeworld.circuit_trajectory(n_frames, step=0.8)
    for i, T in enumerate(poses):
        scan = street.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
        np.concatenate([pts, scan[:, 3:4]], axis=1).astype(np.float32).tofile(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))
    calib = os.path.join(seq_dir, "calib.txt")
    with open(calib) as f:
        rows = [ln for ln in f.read().splitlines() if not ln.startswith("Tr:")]
    with open(calib, "w") as f:
        f.write("\n".join(rows + ["Tr: " + " ".join(repr(float(x)) for x in T_cv[:3].ravel())])
                + "\n")
    rescan_s = time.perf_counter() - t0

    # The PNG readers: the zlib decoder against PIL where PIL is installed.
    first = os.path.join(seq_dir, "image_0", "000000.png")
    t0 = time.perf_counter()
    z = png.read_gray(first)
    zlib_ms = 1e3 * (time.perf_counter() - t0)
    backend = kitti_io.image_backend()
    zlib_equals_pil = None
    if backend == "PIL":
        from PIL import Image

        zlib_equals_pil = bool(np.array_equal(z, np.asarray(Image.open(first).convert("L"))))
        if not zlib_equals_pil:
            raise AssertionError("the zlib PNG decoder differs from PIL on the card")
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    png_h = gxx is not None and subprocess.run(
        [gxx, "-E", "-x", "c++", "-"], input="#include <png.h>\n", capture_output=True,
        text=True, timeout=60).returncode == 0
    native_ok = native_loader.NativeKittiLoader.available()
    emit("kitti_runner_setup", frames=n_frames, generate_s=generate_s, rescan_s=rescan_s,
         image_backend=backend, zlib_decode_ms=zlib_ms, zlib_equals_pil=zlib_equals_pil,
         png_h=png_h, native_loader=native_ok, native_build_error=native_loader.build_error())
    if png_h and not native_ok:
        raise AssertionError(f"png.h is here but the native loader failed: "
                             f"{native_loader.build_error()}")

    base = ["--root", root, "--seq", "00", "--mode", "fusion", "--device", device]
    ckpt = os.path.join(work, "map.npz")

    def run(name, extra, frames=n_frames, profile=False):
        """One in-process runner call: its summary, launches, host reads per
        frame, LiDAR associations per frame and the system it drove. Each
        read of a tracking step's results notes whether the device still
        had work queued when the read returned (`torch.cuda.Stream.query`):
        the next frame's work overlapping this frame's host bookkeeping.
        With `profile`, the last 3 frames run under torch.profiler (device
        ms, idle share); ms per frame is then the median of the others."""
        seen = {"matches": [], "system": None, "busy_after_read": [], "ms": []}
        track_fusion, shutdown = system_mod.SlamSystem.track_fusion, system_mod.SlamSystem.shutdown
        wait_host = tracking_mod.wait_host
        window = range(frames - 3, frames) if profile and device == "cuda" else range(0)
        span = ProfiledSpan()

        def noting_wait_host(copy):
            out = wait_host(copy)
            if device == "cuda":
                seen["busy_after_read"].append((len(seen["matches"]),
                                                not torch.cuda.current_stream().query()))
            return out

        def counted_track_fusion(self, *a, **k):
            i = len(seen["matches"])
            if window and i == window.start:
                span.start()
            n_kf = self.num_keyframes()
            t = time.perf_counter()
            pose = track_fusion(self, *a, **k)
            seen["ms"].append(1e3 * (time.perf_counter() - t))
            seen.setdefault("kf", []).append(self.num_keyframes() > n_kf)
            seen["matches"].append(self.tracker.last_lidar_matches)
            if i + 1 == window.stop:
                span.stop()  # read after the run: its wall_s holds no trace parsing
                seen["window"] = span
            return pose

        def kept_shutdown(self):
            seen["system"] = self
            return shutdown(self)
        system_mod.SlamSystem.track_fusion = counted_track_fusion
        system_mod.SlamSystem.shutdown = kept_shutdown
        tracking_mod.wait_host = noting_wait_host
        hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
        utils.host_reads = 0
        out = os.path.join(work, f"traj_{name}.txt")
        argv = base + ["--frames", str(frames), "--out", out] + extra
        try:
            res = run_kitti.main(argv)
        finally:
            system_mod.SlamSystem.track_fusion = track_fusion
            system_mod.SlamSystem.shutdown = shutdown
            tracking_mod.wait_host = wait_host
        if device == "cuda":
            torch.cuda.synchronize()
        rec = dict(res, launches={"hamming": hamming.launch_count,
                                  "ba_assembly": assembly.launch_count,
                                  "ba_chi2": assembly.chi2_launch_count},
                   host_reads_per_frame=utils.host_reads / frames,
                   trajectory_rows=int(np.loadtxt(out, ndmin=2).shape[0]),
                   lidar_matches=seen["matches"])
        outside = [b for i, b in seen["busy_after_read"] if i not in window]
        inside = [b for i, b in seen["busy_after_read"] if i in window]
        if outside:
            rec.update(step_reads=len(outside),
                       device_busy_after_step_read_share=sum(outside) / len(outside))
        rec["ms_per_frame"] = float(np.median([m for i, m in enumerate(seen["ms"])
                                               if i not in window]))
        plain = [m for i, m in enumerate(seen["ms"]) if i not in window and not seen["kf"][i]]
        rec["ms_per_frame_without_keyframe"] = float(np.median(plain)) if plain else None
        rec["keyframe_calls"] = int(sum(seen["kf"]))
        rec["max_ms"] = float(max(seen["ms"]))
        w = seen["window"].read() if "window" in seen else None
        if w is not None:
            rec["profiled"] = dict(
                frames=[window.start, window.stop - 1], device_ms_per_frame=w["device_ms"] / 3,
                device_idle_share=1.0 - w["device_ms"] / 1e3 / w["wall_s"],
                ms_per_frame=1e3 * w["wall_s"] / 3, cuda_launches_per_frame=w["cuda_launches"] / 3,
                device_busy_after_step_read_share=sum(inside) / max(len(inside), 1))
        emit("kitti_runner", run=name, args=extra, **rec)
        return rec, seen["system"]

    def check(name, rec, frames=n_frames):
        if rec["tracked"] != frames or not rec["ate_rmse_m"] < 0.5:
            raise AssertionError(f"runner {name}: tracked {rec['tracked']}/{frames}, "
                                 f"ATE {rec.get('ate_rmse_m')} m")
        if png_h and rec["loader"] != "native":
            raise AssertionError(f"runner {name}: the native loader was not used")

    runs = {}
    # (a) sync, with a checkpoint of the map.
    runs["sync"], _ = run("sync", ["--checkpoint", ckpt])
    a = runs["sync"]
    check("sync", a)
    steady = a["lidar_matches"][2:]
    if a["keyframes"] < 2 or min(steady) <= 20:
        raise AssertionError(f"runner sync: {a['keyframes']} keyframes, LiDAR associations "
                             f"{a['lidar_matches']}")
    if device == "cuda" and (a["launches"]["hamming"] <= 0 or a["launches"]["ba_assembly"] <= 0):
        raise AssertionError(f"runner sync: a kernel never launched: {a['launches']}")
    # (b) the asynchronous mapping worker with pipelined tracking, then each
    # alone and sync again for the timing (in turns, on one card).
    for name, extra in (("async_pipelined", ["--async-mapping", "--pipelined"]),
                        ("async", ["--async-mapping"]), ("pipelined", ["--pipelined"]),
                        ("sync_again", [])):
        runs[name], system = run(name, extra, profile=name != "async")
        check(name, runs[name])
        if system._worker is not None and (system._worker.is_alive()
                                           or system._kf_queue.unfinished_tasks):
            raise AssertionError(f"runner {name}: the mapping worker was not drained and joined")
        runs[name]["worker_joined"] = system._worker is not None
    # (c) resume from (a)'s map.
    runs["resume"], _ = run("resume", ["--resume", ckpt], frames=4)
    emit("kitti_runner_resume", **runs["resume"]["resume"])
    # (d) standalone LiDAR odometry through `python -m`, in a subprocess.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sqrtlm_slam_tpu_torch.run_kitti", "--root", root, "--seq",
         "00", "--mode", "lidar", "--frames", str(n_frames), "--device", device, "--json",
         "--out", os.path.join(work, "traj_lidar.txt")],
        cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"runner lidar (subprocess) failed:\n{proc.stderr[-3000:]}")
    d = json.loads(proc.stdout.strip().splitlines()[-1])
    runs["lidar"] = dict(d, process_s=time.perf_counter() - t0)
    emit("kitti_runner", run="lidar", args=["--mode", "lidar", "(python -m)"], **runs["lidar"])
    if not d["ate_rmse_m"] < 0.5:
        raise AssertionError(f"runner lidar: ATE {d['ate_rmse_m']} m")
    shutil.rmtree(work, ignore_errors=True)
    return runs


def kept_bytes() -> int:
    """The device memory the process keeps: `memory_reserved` after
    `empty_cache` (the captured graphs' pools, live tensors)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def capture_mb(fn, a, k):
    """The device memory a fresh capture of the graphed `fn` on (a, k)
    keeps (its private pool and static inputs): memory_reserved after
    empty_cache, before and after the capture. None off the card."""
    import torch
    from sqrtlm_slam_tpu_torch.utils import cache

    if not torch.cuda.is_available():
        return None
    fresh = cache.graphed(fn.eager, static_argnames=fn.static_argnames)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    fresh(*a, **k)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mb = (torch.cuda.memory_reserved() - r0) / 2**20
    del fresh
    torch.cuda.empty_cache()
    return mb


def run_counted(fn):
    """(fn(), dict(s, graph_captures, graph_replays, host_reads)) of one call
    ended by a synchronize (none without a card); the counters are zeroed
    just before it."""
    import torch
    from sqrtlm_slam_tpu_torch import utils

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    utils.graph_captures = utils.graph_replays = utils.host_reads = 0
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, dict(s=time.perf_counter() - t, graph_captures=utils.graph_captures,
                     graph_replays=utils.graph_replays, host_reads=utils.host_reads)


def wall_ms(fn, n: int = 3, warm: int = 1) -> float:
    """Median host time of one call of `fn` in ms, each call ended by a
    synchronize (for calls of many kernels and host work)."""
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def multi_camera(prob) -> np.ndarray:
    """(L,) True where a landmark's valid slots hold two or more distinct
    cameras. A landmark seen from one camera only has no determined depth
    (the generators give some at a chain's end): its position is compared
    by chi2 and the survivor gate, not coordinate by coordinate."""
    cams = np.sort(np.where(prob.obs_valid.cpu().numpy(), prob.obs_cam.cpu().numpy(), -1), 1)
    distinct = (cams[:, 0] >= 0).astype(int) + (
        (np.diff(cams, axis=1) != 0) & (cams[:, 1:] >= 0)).sum(1)
    return distinct >= 2


def compare_ba(a, b, multi: np.ndarray) -> dict:
    """Largest differences of two BA results (poses, landmarks seen from
    two or more cameras)."""
    import torch

    sel = torch.as_tensor(multi, device=a.points.device)
    return dict(
        pose_t_max_abs=float((a.pose_t - b.pose_t).abs().max()),
        pose_R_max_abs=float((a.pose_R - b.pose_R).abs().max()),
        points_max_abs=float((a.points - b.points).abs()[sel].max()),
    )


# Gates of distributed BA against one shard (or against one process):
# tests/test_dist_ba.py's (accepted within 1, chi2 rtol 0.05, pose_t atol
# 5e-3, landmarks atol 2e-2); the measured differences are printed beside
# them.
DIST_GATES = dict(acc=1, chi2_rtol=5e-2, pose_t=5e-3, points=2e-2)


def check_dist(name, got, ref, multi) -> dict:
    (out, chi2, acc), (out_r, chi2_r, acc_r) = got, ref
    d = compare_ba(out, out_r, multi)
    d.update(chi2_rel=abs(float(chi2) - float(chi2_r)) / abs(float(chi2_r)),
             accepted=[int(acc), int(acc_r)])
    g = DIST_GATES
    if (abs(int(acc) - int(acc_r)) > g["acc"] or d["chi2_rel"] > g["chi2_rtol"]
            or d["pose_t_max_abs"] > g["pose_t"] or d["points_max_abs"] > g["points"]):
        raise AssertionError(f"{name}: outside the gates {g}: {d}")
    return d


def mono_fresh_process(frames_path: str) -> None:
    """Phase 13's fresh process: `track_monocular` over the images in
    `frames_path` (an .npz of phase 4's first frames, up to the
    initialization) in a process that has run nothing else; prints one JSON
    line: each `initialize_two_view` call's ms (the first includes the
    graph's warm-up and capture), each frame's ms, whether the map
    initialized, and the first call's parts: a capture of a new instance
    of the graph once every kernel is loaded, a replay and an eager call."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import graph_calls
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.pipeline import initializer, tracking
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig
    from sqrtlm_slam_tpu_torch.utils import cache

    images = np.load(frames_path)["images"]
    two_view, calls, last = initializer.initialize_two_view, [], []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = two_view(*a, **k)
        torch.cuda.synchronize()
        calls.append(1e3 * (time.perf_counter() - t))
        last[:] = [a]
        return out

    tracking.initializer.initialize_two_view = timed
    cfg = SystemConfig(orb=ORBConfig(max_features=2000),
                       tracking=TrackingConfig(min_inliers_local=15))
    system = SlamSystem(Camera(**KITTI_INTRINSICS), cfg, device="cuda")
    frame_ms = []
    for img in images:
        t = time.perf_counter()
        system.track_monocular(img)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t))
    tracking.initializer.initialize_two_view = two_view
    # The first call's parts, on the last call's matches and fresh draws: a
    # capture of a new instance of the graph (warm-up, capture, replay; every
    # kernel loaded by now), its replays and eager calls.
    xy1, xy2, valid, cam = last[0][:4]
    _, a, k = graph_calls.init_calls(xy1, xy2, valid, cam,
                                     torch.Generator(device="cuda").manual_seed(0))[
        "_initialize_jit"]
    fresh = cache.graphed(initializer._initialize, static_argnames=("cam",))
    parts = dict(capture_again_ms=wall_ms(lambda: fresh(*a, **k), n=1, warm=0),
                 replay_ms=wall_ms(lambda: fresh(*a, **k), n=5, warm=0))
    with cache.disable_graphs():
        parts["eager_ms"] = wall_ms(lambda: fresh(*a, **k), n=3, warm=0)
    print(json.dumps(dict(initialize_two_view_ms=calls, frame_ms=frame_ms,
                          initialized=system.num_keyframes() >= 2, **parts)), flush=True)


def mono_fresh_subprocess(images) -> dict:
    """Run `mono_fresh_process` on `images` in a subprocess (its own CUDA
    context, kernels loaded from build/kernels); its JSON line and its wall
    seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    path = os.path.join(here, "build", f"mono_fresh_{os.getpid()}.npz")
    np.savez(path, images=np.stack(images))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke as c; c.mono_fresh_process({path!r})"],
            cwd=here, env=env, capture_output=True, text=True, timeout=300)
    finally:
        os.remove(path)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh monocular process failed:\n{proc.stderr[-3000:]}")
    return dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                process_s=time.perf_counter() - t0)


def flat_and_distributed_phase(kitti_frames=None, scale_problem=None, ring_problem=None,
                               scan=None, device: str = "cuda") -> dict:
    """16. The flat engine and distributed BA on one card: (a) the facade's
    flat and cg backends against the bucketed one at the bench problem,
    each graphed (the default) and eagerly (`disable_graphs`: bitwise
    equal, ms, captures, host reads), and the flat and cg backends under the
    main path (`LocalMappingConfig(backend=...)`) on `BACKEND_FRAMES`
    KITTI-size RGB-D frames, phase 4's and on (the cg run's K1 / K2 / K3
    launches are the `cg_local_ba` path; local BA's captures counted call
    by call, none left in the second half of the windows); the flat engine's `global_ba` on the
    ring's GBA problem (`ring_problem`; a 69-keyframe scale store when
    absent) and `global_ba_cg` on phase 8's (`scale_problem`), graphed
    against eager; `calibrate_extrinsics` graphed against eager on a LiDAR
    scan (`scan`, sensor frame; phase 10's first when given) and
    T_CAM_VELO perturbed; (b) the distributed
    Nielsen LM in process at the bench problem over 1, 2 and 4 shards on
    one card (the whole loop one graph: a capturing call and a replayed
    one, bitwise, against eager and the segment graphs), K2 / K3 launches
    per shard, the bucketed and flat steps graphed against eager, and
    one flat distributed step over 4 shards against the single-device flat
    step; (c) `python -m sqrtlm_slam_tpu_torch.parallel.mp_worker` at the
    JAX dryrun's shape (P=64, L=16384, K=4): 2 processes x 2 shards with
    gloo on one card and 1 process x 4 shards with nccl, against (b)'s
    in-process 4 shards, each rank against its eager rerun; (d) map scale
    (phase 7's 600 x 120000 problem), 4 shards against 1, 3 iterations,
    captured, replayed once and eager. Returns the launches of (b)'s
    replayed 4-shard call, and (a)'s cg run's under "cg_local_ba".
    `device="cpu"` rehearses it without a card (gloo only)."""
    import socket

    import torch
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, facade, schur, schur_bucketed
    from sqrtlm_slam_tpu_torch.parallel import dist_ba, mp_worker
    from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMappingConfig
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.utils import cache, to_host

    on_card = device == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    cam = synthetic.DEFAULT_CAM

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) The flat engine ---------------------------------------------------
    flat, _ = synthetic.make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6,
                                        obs_per_landmark=5)
    prob = schur_bucketed.from_flat(flat, 5, device=dev)
    multi = multi_camera(prob)
    chi2_0 = float(schur_bucketed.chi2_only(prob, cam, prob.obs_valid, 2.447))
    local = {}
    for backend in ("bucketed", "flat", "cg"):
        opt = facade.Optimizer(backend)
        (out, surv, chi2), first = run_counted(lambda: opt.local_bundle_adjustment(prob, cam))
        ms = wall_ms(lambda: opt.local_bundle_adjustment(prob, cam), n=3, warm=0)
        with cache.disable_graphs():
            want, eager = run_counted(lambda: opt.local_bundle_adjustment(prob, cam))
        _, again = run_counted(lambda: opt.local_bundle_adjustment(prob, cam))
        rec = dict(backend=backend, shape=[96, 8192, 5], ms_per_call=ms,
                   eager_ms_per_call=1e3 * eager["s"], first_call=first, replayed_call=again,
                   eager_call=eager, chi2=float(chi2),
                   bitwise_equal_to_eager=same_bits((out, surv, chi2), want))
        emit("local_ba_graphed_vs_eager", **rec,
             note="first_call / replayed_call / eager_call: seconds, captures, replays and "
                  "host reads of one call to a synchronize; the facade's bucketed backend "
                  "runs op by op (local mapping replays its graph, _bucketed_local_ba_jit)")
        if not (rec["bitwise_equal_to_eager"] and float(chi2) < chi2_0):
            raise AssertionError(f"{backend} local BA: graphed differs from eager or chi2 did "
                                 f"not fall: {rec}")
        if on_card and backend != "bucketed" and not (again["graph_replays"] > 0
                                                      and again["graph_captures"] == 0):
            raise AssertionError(f"{backend} local BA did not replay its graphs: {rec}")
        local[backend] = (out, surv, float(chi2), ms)
    # The float64 optimum: the flat engine (plain PyTorch, no kernel) in
    # float64 on the same device.
    f64 = {k: v.double() for k, v in prob._asdict().items() if v.is_floating_point()}
    ref64 = facade.Optimizer("flat").local_bundle_adjustment(prob._replace(**f64), cam)[0]
    (ob, sb_, cb, msb), (of, sf, cf, msf) = local["bucketed"], local["flat"]
    cg_chi2_rel = abs(local["cg"][2] - cb) / cb
    vs64 = {k: compare_ba(o, ref64, multi) for k, o in (("bucketed", ob), ("flat", of))}
    d = compare_ba(of, ob, multi)
    d.update(chi2_rel=abs(cf - cb) / cb, survivors_differ=int((sf != sb_).sum()))
    gates = dict(chi2_rtol=1e-3, survivors_differ=0.005,
                 bucketed_vs_f64=dict(pose_t=5e-3, points=2e-2),
                 flat_vs_f64=dict(pose_t=0.1, points=0.5))
    emit("flat_vs_bucketed_local_ba", shape=[96, 8192, 5], chi2_start_huber=chi2_0,
         chi2=dict(bucketed=cb, flat=cf, cg=local["cg"][2]), cg_vs_bucketed_chi2_rel=cg_chi2_rel,
         ms_per_call=dict(bucketed=msb, flat=msf, cg=local["cg"][3]),
         survivors=int(sf.sum()), multi_camera_landmarks=int(multi.sum()),
         flat_vs_bucketed=d, vs_float64_optimum=vs64, gates=gates,
         note="float32 engines against the flat engine run in float64 on the card; the "
              "flat engine forms W Hll^-1 W^T explicitly in float32 and lands cm from "
              "the float64 optimum on this 96-pose chain, the square-root bucketed one "
              "does not; ms = host time of one call to a synchronize")
    g64b, g64f = gates["bucketed_vs_f64"], gates["flat_vs_f64"]
    if (d["chi2_rel"] > gates["chi2_rtol"]
            or d["survivors_differ"] > gates["survivors_differ"] * sf.numel()
            or vs64["bucketed"]["pose_t_max_abs"] > g64b["pose_t"]
            or vs64["bucketed"]["points_max_abs"] > g64b["points"]
            or vs64["flat"]["pose_t_max_abs"] > g64f["pose_t"]
            or vs64["flat"]["points_max_abs"] > g64f["points"]):
        raise AssertionError(f"flat / bucketed local BA outside the gates {gates}: {d}, "
                             f"{vs64}")
    del ref64

    kcam = Camera(**KITTI_INTRINSICS)
    if kitti_frames is None:
        world = synthetic.SyntheticWorld(seed=1, n_points=3000)
        poses = synthetic.forward_trajectory(BACKEND_FRAMES, step=0.3)
        kitti_frames = [(world.render(T, kcam, H=KITTI_H, W=KITTI_W), T) for T in poses]
    cg_launches = None
    for backend in ("flat", "cg"):
        cfg = SystemConfig(orb=ORBConfig(max_features=2000),
                           local_mapping=LocalMappingConfig(backend=backend))
        # Local BA's captures, call by call: the padded plans are meant to
        # let successive windows share captures.
        local_graphs = ((schur._local_loop_jit,) if backend == "flat"
                        else schur_bucketed.LOCAL_GRAPHS)
        captures_per_call = []
        local_ba = facade.Optimizer.local_bundle_adjustment

        def counted(self, *a, **k):
            c0 = sum(g.captures for g in local_graphs)
            out = local_ba(self, *a, **k)
            captures_per_call.append(sum(g.captures for g in local_graphs) - c0)
            return out

        hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
        utils.graph_captures = utils.graph_replays = utils.host_reads = 0
        facade.Optimizer.local_bundle_adjustment = counted
        try:
            system, secs, tracked = run_sequence(SlamSystem, cfg, kcam,
                                                 [f for f, _ in kitti_frames], dev, time_from=3)
        finally:
            facade.Optimizer.local_bundle_adjustment = local_ba
        kernel_launches = dict(hamming=hamming.launch_count, ba_assembly=assembly.launch_count,
                               ba_chi2=assembly.chi2_launch_count)
        graphs = dict(graph_captures=utils.graph_captures, graph_replays=utils.graph_replays,
                      host_reads=utils.host_reads)
        ate, _ = ate_rmse(system.get_trajectory(),
                          gt_cam_to_world([T for _, T in kitti_frames]), align_scale=False)
        n_ba = system.local_mapper.num_local_ba
        rec = dict(backend=backend, frames=len(kitti_frames), tracked=tracked,
                   keyframes=system.num_keyframes(), local_ba=n_ba,
                   local_ba_captures_per_call=captures_per_call,
                   local_graph_entries=[g.num_entries() for g in local_graphs],
                   local_graph_max_entries=[g.max_entries for g in local_graphs],
                   ate_m=ate, median_ms=1e3 * float(np.median(secs)), launches=kernel_launches,
                   **graphs)
        emit(f"{backend}_backend_kitti_rgbd", **rec,
             note="local_ba_captures_per_call: captures of the backend's local-BA graphs "
                  "made in each local BA of the run, in order (one key a graph: the phase "
                  "and the padded plans' width buckets)")
        if tracked != len(kitti_frames) or n_ba < 4 or not ate < 0.05:
            raise AssertionError(f"{backend} backend on the KITTI-size frames: {rec}")
        if on_card and (len(captures_per_call) != n_ba
                        or sum(captures_per_call[n_ba // 2:]) != 0):
            raise AssertionError(f"{backend} local BA still captured in the run's second half "
                                 f"of windows: {rec}")
        if backend == "cg":
            cg_launches = kernel_launches
            if on_card and min(kernel_launches.values()) <= 0:
                raise AssertionError(f"a kernel never launched in the cg local BA run: {rec}")
        del system

    # The flat engine's global BA (ring) and its matrix-free global BA
    # (phase 8's problem), graphed against eager.
    if ring_problem is None:
        from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
        from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed

        store, _, _ = make_scale_store(n_kf=69, n_lm=17_000, obs_per_lm=5, drift=4e-4,
                                       radius=80.0 * 69 / 600)
        ring_problem = gather_global_problem_bucketed(store, "cpu")[0]
        del store
    gba_runs = [("flat_global_ba_ring", ring_problem,
                 lambda p: facade.Optimizer("flat").global_bundle_adjustment(p, cam)),
                ("flat_global_ba_cg_600kf", scale_problem,
                 lambda p: schur.global_ba_cg(facade.bucketed_to_flat(p), cam, num_iters=3))]
    for name, host_problem, run in gba_runs:
        if host_problem is None:
            continue  # phase 16 alone: (d) builds the 600-keyframe problem after this
        p = schur_bucketed.BucketedBAProblem(*[t.to(dev) for t in host_problem])
        c0 = float(schur_bucketed.chi2_only(p, cam, p.obs_valid, 2.447))
        got, first = run_counted(lambda: run(p))
        _, again = run_counted(lambda: run(p))
        with cache.disable_graphs():
            want, eager = run_counted(lambda: run(p))
        chi2 = float(got[2].chi2 if hasattr(got[2], "chi2") else got[2])
        mem = kept_bytes() if on_card else None
        rec = dict(shape=[p.num_poses, *p.obs_cam.shape], chi2_start=c0, chi2=chi2,
                   first_call=first, replayed_call=again, eager_call=eager,
                   bitwise_equal_to_eager=same_bits(got, want),
                   memory_reserved_mb=mem / 2**20 if mem is not None else None)
        emit(name, **rec)
        if not (rec["bitwise_equal_to_eager"] and chi2 < c0):
            raise AssertionError(f"{name}: graphed differs from eager or chi2 did not fall: "
                                 f"{rec}")
        del p, got, want

    # The extrinsic calibration on a LiDAR scan, T_CAM_VELO perturbed.
    from sqrtlm_slam_tpu_torch.eval import planeworld
    from sqrtlm_slam_tpu_torch.geometry import se3

    if scan is None:
        world_s = planeworld.street_circuit_world(seed=0)
        T0 = planeworld.circuit_trajectory(1, step=0.8, start_s=FUSION_START_S)[0][0]
        scan = world_s.lidar_scan(T0, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=0)
    calls, T_true = calibration_graph_calls(scan, dev)
    for name, (fn, a, k) in calls.items():
        got, first = run_counted(lambda: fn(*a, **k))
        _, again = run_counted(lambda: fn(*a, **k))
        with cache.disable_graphs():
            want, eager = run_counted(lambda: fn(*a, **k))
        err = float(torch.linalg.norm(se3.local_delta(got.T, T_true)))
        rec = dict(points=a[1].shape[0], plane_terms=bool(k), first_call=first,
                   replayed_call=again, eager_call=eager, error_to_truth=err,
                   bitwise_equal_to_eager=same_bits(got, want))
        emit(name, **rec)
        if not (rec["bitwise_equal_to_eager"] and err < 1e-3):
            raise AssertionError(f"{name}: {rec}")

    # (b) Distributed LM in one process ---------------------------------------
    # Each shard count: a first call (it captures the whole loop), a second
    # (a replay: the launch counts), ms per LM iteration graphed, through
    # the segment graphs (the cross-process form, on one card) and eagerly.
    iters, lm = 15, dict(cam=cam, num_iters=15, robust_delta=2.447, mu0=1e-3)
    runs, launches = {}, None

    def lm_result(r):
        return (r[0].pose_R, r[0].pose_t, r[0].points, r[1], r[2])

    for D in (1, 2, 4):
        mesh = dist_ba.make_mesh(D, dev)

        def run():
            return dist_ba.distributed_ba_lm(prob, cam, mesh, num_iters=iters, robust_delta=2.447)

        r1, first = run_counted(run)
        assembly.launch_count = assembly.chi2_launch_count = 0
        r2, again = run_counted(run)
        k2, k3 = assembly.launch_count, assembly.chi2_launch_count
        ms = wall_ms(run, n=3, warm=0)
        with cache.disable_graphs():
            want, eager = run_counted(run)
            eager_ms = wall_ms(run, n=2, warm=0)
        sp = dist_ba.to_shards(dist_ba.partition_bucketed(prob, D)[0], mesh)
        whole = dist_ba._lm_loop_jit(sp, **lm)
        seg = dist_ba._lm_segmented(mesh, sp, cam, iters, 2.447, 1e-3)
        seg_ms = wall_ms(lambda: dist_ba._lm_segmented(mesh, sp, cam, iters, 2.447, 1e-3), n=3,
                         warm=0)
        runs[D] = r1
        rec = dict(shards=D, iters=iters, chi2_start=chi2_0, chi2=float(r1[1]),
                   accepted=int(r1[2]), ms_per_iter=ms / iters,
                   segments_ms_per_iter=seg_ms / iters, eager_ms_per_iter=eager_ms / iters,
                   first_call=first, replayed_call=again, eager_call=eager,
                   launches=dict(ba_assembly=k2, ba_chi2=k3),
                   rerun_bitwise_equal=same_bits(lm_result(r1), lm_result(r2)),
                   bitwise_equal_to_eager=same_bits(lm_result(r2), lm_result(want)),
                   segments_bitwise_equal_to_whole=same_bits(tuple(whole), tuple(seg)))
        if on_card:
            w_g = profile_window(run)
            with cache.disable_graphs():
                w_e = profile_window(run)
            rec.update(cuda_launches=dict(graphed=w_g["cuda_launches"],
                                          eager=w_e["cuda_launches"]),
                       device_ms=dict(graphed=w_g["device_ms"], eager=w_e["device_ms"]),
                       graph_memory_mb=capture_mb(dist_ba._lm_loop_jit, (sp,), lm))
        if D > 1:
            rec["vs_one_shard"] = check_dist(f"distributed LM, {D} shards", r1, runs[1], multi)
        emit("dist_ba_lm_in_process", shape=[96, 8192, 5], **rec,
             note="first_call / replayed_call / eager_call: seconds, captures, replays and host "
                  "reads of one call (partition and write-back included) to a synchronize; "
                  "ms: median call over iters; segments: the start / head / solve / tail "
                  "graphs a process group replays, here on one card")
        if not (float(r1[1]) < chi2_0 and rec["rerun_bitwise_equal"]
                and rec["bitwise_equal_to_eager"] and rec["segments_bitwise_equal_to_whole"]):
            raise AssertionError(f"distributed LM over {D} shards: {rec}")
        if on_card and (k2 != D * iters or k3 != D * (iters + 1)):
            raise AssertionError(f"distributed LM over {D} shards launched K2 {k2} / K3 {k3} "
                                 f"times, expected {D * iters} / {D * (iters + 1)}")
        if on_card and not (again["graph_captures"] == 0 and again["graph_replays"] == 1):
            raise AssertionError(f"distributed LM over {D} shards is not one replay a call: "
                                 f"{again}")
        if D == 4:
            launches = dict(ba_assembly=k2, ba_chi2=k3, cg_local_ba=cg_launches)
        del sp, whole, seg
    # The bucketed and the flat steps over 4 shards, 3 steps a call: one
    # graph a step (the flat engine's edge plans built once a call, outside).
    tf = facade.bucketed_to_flat(prob)
    mesh4 = dist_ba.make_mesh(4, dev)
    steps = {
        "bucketed": lambda: dist_ba.distributed_ba_bucketed(prob, cam, mesh4, num_iters=3, mu=1e-3,
                                                            robust_delta=2.447),
        "flat": lambda: dist_ba.distributed_ba(tf, cam, mesh4, num_iters=3, mu=1e-3)}
    for engine, run in steps.items():
        got, first = run_counted(run)
        _, again = run_counted(run)
        ms = wall_ms(run, n=3, warm=0)
        with cache.disable_graphs():
            want, eager = run_counted(run)
            eager_ms = wall_ms(run, n=2, warm=0)
        rec = dict(engine=engine, shape=[96, 8192, 5], shards=4, steps=3, ms_per_step=ms / 3,
                   eager_ms_per_step=eager_ms / 3, first_call=first, replayed_call=again,
                   eager_call=eager, bitwise_equal_to_eager=same_bits(
                       (got[0].pose_R, got[0].pose_t, got[0].points, got[1]),
                       (want[0].pose_R, want[0].pose_t, want[0].points, want[1])))
        emit("dist_ba_steps", **rec,
             note="host_reads: the partition and write-back's, and for the flat engine its "
                  "edge plans (three a shard, once a call)")
        if not rec["bitwise_equal_to_eager"] or (on_card and not (
                again["graph_captures"] == 0 and again["graph_replays"] == 3)):
            raise AssertionError(f"distributed {engine} steps: {rec}")
    # One flat step (tests/test_dist_ba.py's mu and gates), beside the float32
    # error of the single-device step itself (against it in float64).
    mu = 1e-3
    out4, _ = dist_ba.distributed_ba(tf, cam, mesh4, num_iters=1, mu=mu)
    ne = schur.build_normal_equations(tf, cam, tf.obs_valid, None)
    dxp, dxl = schur.reduce_and_solve(*ne[:5], tf.pose_fixed, tf.point_valid,
                                      torch.tensor(mu, device=dev))
    dxp64, _ = schur.reduce_and_solve(*[x.double() for x in ne[:5]], tf.pose_fixed,
                                      tf.point_valid, torch.tensor(mu, device=dev,
                                                                   dtype=torch.float64))
    ref = schur_bucketed._apply_update(tf, dxp, dxl)
    d = compare_ba(out4, ref, multi)
    emit("dist_ba_flat_step", shape=[96, 8192, 5], shards=4, mu=mu, **d,
         single_device_f32_vs_f64_pose_step_max_abs=float((dxp.double() - dxp64).abs().max()),
         gates=dict(pose_t=5e-4, points=5e-3))
    if d["pose_t_max_abs"] > 5e-4 or d["points_max_abs"] > 5e-3:
        raise AssertionError(f"flat distributed step off the single-device step: {d}")
    del prob, tf, ne, runs

    # (c) Across processes (mp_worker) ----------------------------------------
    P, L, K, mp_iters = 64, 16384, 4, 6
    flat64, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, obs_per_landmark=K)
    b64 = schur_bucketed.from_flat(flat64, K, device=dev)
    multi64 = multi_camera(b64)
    ref = dist_ba.distributed_ba_lm(b64, cam, dist_ba.make_mesh(4, dev), num_iters=mp_iters)
    ref_digest = mp_worker.result_digest(*to_host(ref[0].pose_R, ref[0].pose_t, ref[0].points,
                                                  ref[1]))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    configs = (("2 processes x 2 shards", 2, 2, "gloo"),
               ("1 process x 4 shards", 1, 4, "nccl" if on_card else "gloo"))
    for name, nproc, spp, backend in configs:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.makedirs(os.path.join(here, "build"), exist_ok=True)
        out_path = os.path.join(here, "build", f"mp_{nproc}x{spp}.npz")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sqrtlm_slam_tpu_torch.parallel.mp_worker",
             "--coordinator", f"localhost:{port}", "--nproc", str(nproc), "--pid", str(pid),
             "--shards-per-proc", str(spp), "--device", device, "--backend", backend,
             "--poses", str(P), "--landmarks", str(L), "--obs-per-lm", str(K),
             "--iters", str(mp_iters), "--seed", "0", "--out", out_path],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(nproc)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise AssertionError(f"mp_worker ({name}) failed:\n{err[-3000:]}")
                results.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        process_s = time.perf_counter() - t0
        got = np.load(out_path)
        os.remove(out_path)
        mp_out = schur_bucketed.BucketedBAProblem(*ref[0])._replace(
            pose_R=torch.as_tensor(got["pose_R"], device=dev),
            pose_t=torch.as_tensor(got["pose_t"], device=dev),
            points=torch.as_tensor(got["points"], device=dev))
        d = check_dist(f"mp_worker {name}", (mp_out, float(got["chi2"]), int(got["n_acc"])),
                       ref, multi64)
        digests = {r["digest"] for r in results}
        per_rank = ("wall_s", "allreduce_ms_per_iter", "device", "first_call_s",
                    "first_call_captures", "graph_captures", "graph_replays", "cuda_launches",
                    "eager_wall_s", "eager_cuda_launches", "eager_bitwise_equal")
        rec = dict(config=name, backend=backend, shape=[P, L, K], iters=mp_iters,
                   ranks_bitwise_equal=len(digests) == 1,
                   bitwise_equal_to_in_process=digests == {ref_digest},
                   **{k: [r[k] for r in results] for k in per_rank}, processes_s=process_s,
                   vs_in_process_4_shards=d)
        emit("dist_ba_multiprocess", **rec,
             note="per rank: the first call (it captures), the timed call's wall s, captures "
                  "and replays, CUDA launches of one call graphed and eager (torch.profiler), "
                  "the eager call's wall s and whether its digest equals the graphed one")
        if len(digests) != 1:
            raise AssertionError(f"mp_worker {name}: ranks differ: {results}")
        if not all(rec["eager_bitwise_equal"]) or (on_card and any(rec["graph_captures"])):
            raise AssertionError(f"mp_worker {name}: a rank's graphed call differs from its "
                                 f"eager rerun, or its timed call captured: {results}")
    del b64, ref

    # (d) Map scale -----------------------------------------------------------
    if scale_problem is None:
        from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
        from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed

        store, _, _ = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5, drift=4e-4)
        scale_problem = gather_global_problem_bucketed(store, "cpu")[0]
        del store
    big = schur_bucketed.BucketedBAProblem(*[t.to(dev) for t in scale_problem])
    multi_s = multi_camera(big)
    chi2_s0 = float(schur_bucketed.chi2_only(big, cam, big.obs_valid, 2.447))
    scale = {}

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    for D in (4, 1):
        mesh = dist_ba.make_mesh(D, dev)

        def run():
            return dist_ba.distributed_ba_lm(big, cam, mesh, num_iters=3, robust_delta=2.447)

        kept0 = kept_bytes() if on_card else 0
        reset_peak()
        res, first = run_counted(run)  # the capture (warm-up, capture, replay)
        capture_peak = peak_gb()
        kept1 = kept_bytes() if on_card else 0
        reset_peak()
        again_res, again = run_counted(run)  # one replay
        replay_peak = peak_gb()
        with cache.disable_graphs():
            reset_peak()
            want, eager = run_counted(run)
            eager_peak = peak_gb()
        scale[D] = res
        rec = dict(shards=D, shape=[big.num_poses, *big.obs_cam.shape], iters=3,
                   chi2_start=chi2_s0, chi2=float(res[1]), accepted=int(res[2]),
                   ms_per_iter=1e3 * again["s"] / 3, capture_call_ms_per_iter=1e3 * first["s"] / 3,
                   eager_ms_per_iter=1e3 * eager["s"] / 3, first_call=first,
                   replayed_call=again, eager_call=eager, peak_mem_gb=dict(
                       capture_call=capture_peak, replay=replay_peak, eager=eager_peak),
                   kept_mb=dict(before=kept0 / 2**20, after_capture=kept1 / 2**20),
                   bitwise_equal_to_eager=same_bits(lm_result(again_res), lm_result(want))
                   and same_bits(lm_result(res), lm_result(want)))
        if D == 1:
            rec["four_vs_one_shard"] = check_dist("map scale, 4 shards", scale[4], res, multi_s)
        emit("dist_ba_map_scale", **rec,
             note="kept_mb: memory_reserved after empty_cache before the first call (the "
                  "earlier capture of the loop, evicted by this one) and after it (this "
                  "capture's pool and inputs); peak: max_memory_allocated of each call")
        if not (float(res[1]) < chi2_s0 and rec["bitwise_equal_to_eager"]):
            raise AssertionError(f"map scale over {D} shards: chi2 did not fall or the "
                                 f"replay differs from eager: {rec}")
        if on_card and not (again["graph_captures"] == 0 and again["graph_replays"] == 1):
            raise AssertionError(f"map scale over {D} shards is not one replay a call: {again}")
        del again_res, want
    del big, scale
    return launches


def wide_k_phase(kitti_frames=None, device: str = "cuda") -> dict:
    """17. More than 16 slots per landmark on the main path's callers: (a)
    the first 10 KITTI-size RGB-D frames of phase 4 with
    `LocalMappingConfig(obs_cap=24)` (every frame tracked, >= 1 local BA
    with 24 slots per landmark, ATE < 0.05 m); (b) global BA from a scale
    store with `obs_per_landmark=32` (800 keyframes on a ring of 16 m
    radius, 8,000 landmarks seen by 30 keyframes each: 0.13 m apart, so
    every landmark stays in front of its cameras) after a
    `mapstore/checkpoint` save and load:
    10 LM iterations of `LoopCloser.run_global_ba`, chi2 falling, K2 and K3
    launched, and a second GBA from the same loaded store bitwise equal.
    Counters zeroed just before each run and read just after. Returns the
    launches of (a) and (b). `device="cpu"` rehearses it without a card."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.mapstore import checkpoint
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
    from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMappingConfig
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # (a) Local BA with 24 slots per landmark --------------------------------
    kcam = Camera(**KITTI_INTRINSICS)
    if kitti_frames is None:
        world = synthetic.SyntheticWorld(seed=1, n_points=3000)
        poses = synthetic.forward_trajectory(16, step=0.3)[:10]
        kitti_frames = [(world.render(T, kcam, H=KITTI_H, W=KITTI_W), T) for T in poses]
    cfg = SystemConfig(orb=ORBConfig(max_features=2000),
                       local_mapping=LocalMappingConfig(obs_cap=24))
    widths = []
    assemble = assembly.assemble

    def spy(*args, **kw):  # the slots per landmark of every K2 call
        widths.append(int(args[4].shape[1]))
        return assemble(*args, **kw)

    assembly.launch_count = assembly.chi2_launch_count = hamming.launch_count = 0
    assembly.assemble = spy
    try:
        system, secs, tracked = run_sequence(SlamSystem, cfg, kcam,
                                             [f for f, _ in kitti_frames], dev, time_from=3)
    finally:
        assembly.assemble = assemble
    local_launches = {"ba_assembly": assembly.launch_count, "ba_chi2": assembly.chi2_launch_count,
                      "hamming": hamming.launch_count}
    ate, _ = ate_rmse(system.get_trajectory(), gt_cam_to_world([T for _, T in kitti_frames]),
                      align_scale=False)
    rec = dict(frames=len(kitti_frames), tracked=tracked, keyframes=system.num_keyframes(),
               local_ba=system.local_mapper.num_local_ba,
               k2_slots_per_landmark=sorted(set(widths)), ate_m=ate,
               median_ms=1e3 * float(np.median(secs)), launches=local_launches)
    emit("local_ba_obs_cap_24_kitti_rgbd", **rec)
    if (tracked != len(kitti_frames) or rec["local_ba"] < 1 or not ate < 0.05
            or rec["k2_slots_per_landmark"] != [24]):
        raise AssertionError(f"local BA with obs_cap=24 on the KITTI-size frames: {rec}")
    if dev.type == "cuda" and local_launches["ba_assembly"] <= 0:
        raise AssertionError(f"K2 never launched in local BA with obs_cap=24: {rec}")
    del system

    # (b) Global BA at 32 slots per landmark, from a checkpoint -------------
    cam = synthetic.DEFAULT_CAM
    store, _, _ = make_scale_store(n_kf=800, n_lm=8000, obs_per_lm=30, drift=4e-4,
                                   radius=16.0)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_wide_k.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    checkpoint.save_map(store, path)
    loaded = [checkpoint.load_map(path, device=dev)[0] for _ in range(2)]
    checkpoint_s = time.perf_counter() - t0
    os.remove(path)
    p0, _ = gather_global_problem_bucketed(loaded[0], dev)
    chi2_before = float(schur_bucketed.chi2_only(p0, cam, p0.obs_valid, None))
    shape = [p0.num_poses, *p0.obs_cam.shape]
    del p0
    gba_cfg = LoopClosingConfig(gba_iters=10, gba_chunk=10)
    runs = []
    for st in loaded:
        assembly.launch_count = assembly.chi2_launch_count = 0
        sync()
        t0 = time.perf_counter()
        ok = LoopCloser(st, cam, cfg=gba_cfg, device=dev).run_global_ba()
        sync()
        runs.append(dict(ok=bool(ok), s=time.perf_counter() - t0,
                         launches={"ba_assembly": assembly.launch_count,
                                   "ba_chi2": assembly.chi2_launch_count}))
    p1, _ = gather_global_problem_bucketed(loaded[0], dev)
    chi2_after = float(schur_bucketed.chi2_only(p1, cam, p1.obs_valid, None))
    del p1
    equal = all(np.array_equal(getattr(loaded[0], f), getattr(loaded[1], f))
                for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf"))
    gba = dict(problem_shape=shape, obs_per_landmark=loaded[0].obs_per_landmark,
               checkpoint_save_load_s=checkpoint_s, gba_s=[r["s"] for r in runs],
               chi2_before=chi2_before, chi2_after=chi2_after, repeat_bitwise_equal=equal,
               launches=runs[0]["launches"])
    emit("gba_obs_per_landmark_32", **gba)
    if not (all(r["ok"] for r in runs) and chi2_after < chi2_before and equal
            and shape[2] == 32):
        raise AssertionError(f"global BA at obs_per_landmark=32: {gba}")
    if dev.type == "cuda" and min(runs[0]["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of global BA at 32 slots never launched: {gba}")
    return dict(local_ba=local_launches, gba=runs[0]["launches"])


def same_bits(a, b) -> bool:
    """Bitwise equality of two nests of outputs (NaN bits compare equal)."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over the float tensors of two nests (0 when equal)."""
    import torch

    if isinstance(a, torch.Tensor):
        if not a.is_floating_point() or a.numel() == 0:
            return 0.0 if torch.equal(a, b) else float("inf")
        return float(torch.nan_to_num((a.double() - b.double()).abs(), nan=0.0).max())
    if isinstance(a, (tuple, list)):
        return max([max_abs_diff(x, y) for x, y in zip(a, b)] + [0.0])
    return 0.0


# Relocalisation's and the Sim3 verification's graphs: (module, attribute,
# phase 18's row) of each graphed name whose last call phases 9 and 11
# record for phase 18.
VERIFICATION_GRAPHS = (
    ("sqrtlm_slam_tpu_torch.loop.sim3_solver", "_ransac_sim3_jit", "ransac_sim3"),
    ("sqrtlm_slam_tpu_torch.loop.sim3_solver", "optimize_sim3", "optimize_sim3"),
    ("sqrtlm_slam_tpu_torch.loop.closing", "project_match", "project_match"),
    ("sqrtlm_slam_tpu_torch.loop.closing", "guided_sim3_match", "guided_sim3_match"),
    ("sqrtlm_slam_tpu_torch.pipeline.tracking", "_recover_pose_jit", "recover_pose"),
)
VERIFICATION_ROWS = {attr: row for _, attr, row in VERIFICATION_GRAPHS}


@contextlib.contextmanager
def recording_last_calls(targets, calls: dict):
    """Inside the block, each graphed `module.attribute` of `targets`
    (`VERIFICATION_GRAPHS` entries) keeps its last call made outside a
    capture in `calls[attribute]` as (graphed function, args, kwargs)."""
    import importlib

    from sqrtlm_slam_tpu_torch.utils import cache

    saved = []
    for mod_name, attr, _ in targets:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def call(*a, _fn=fn, _attr=attr, **k):
            if not getattr(cache._local, "busy", False):
                calls[_attr] = (_fn, a, k)
            return _fn(*a, **k)
        saved.append((mod, attr, fn))
        setattr(mod, attr, call)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def calls_to_repay(graphed_total_ms: float, eager_total_ms: float, graphed_ms: float,
                   eager_ms: float):
    """Further calls after which the graphed run's total time drops to the
    eager run's: the graphed run's extra time so far (its captures) over
    what each replay saves against an eager call. 0 where the graphs are
    ahead already, None where a replay saves nothing."""
    extra, saved = graphed_total_ms - eager_total_ms, eager_ms - graphed_ms
    if extra <= 0:
        return 0
    return int(np.ceil(extra / saved)) if saved > 0 else None


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise equality of two host arrays."""
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def make_verification_calls(frames, cam, device: str = "cuda") -> dict:
    """Phase 18's relocalisation and Sim3-verification inputs when it runs
    alone (phases 9 and 11 record them otherwise): `eval/verification.py`'s
    on a KITTI-size RGB-D frame (a local map of `local_map_capacity` rows
    from its depth keypoints, `match_cap` 3D-3D matches under a known Sim3,
    the loop group padded to `loop_points_cap`)."""
    import torch
    from sqrtlm_slam_tpu_torch.eval.verification import verification_calls
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod

    dev = torch.device(device)
    img, depth = (torch.as_tensor(a, device=dev) for a in frames[0])
    f = frame_mod.build_frame(img, cam, ORBConfig(max_features=2000), depth_img=depth)
    return verification_calls(f, cam, torch.Generator(device=dev).manual_seed(0))


def make_loop_inputs(device: str = "cuda") -> dict:
    """Phase 18's loop-correction inputs when it runs alone: phase 8's
    600-keyframe store (its GBA problem and essential graph), a 69-keyframe
    ring store in place of the ring's (the same step, 17,000 landmarks) and
    a 28-pose chain with a loop edge (phase 14's backend graph)."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
    from sqrtlm_slam_tpu_torch.geometry import se3, sim3
    from sqrtlm_slam_tpu_torch.lidar import backend
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed

    out = {}
    for tag, n_kf, n_lm in (("600kf", 600, 120_000), ("ring", 69, 17_000)):
        store, _, _ = make_scale_store(n_kf=n_kf, n_lm=n_lm, obs_per_lm=5, drift=4e-4,
                                       radius=80.0 * n_kf / 600)
        K = store.num_kf
        lc = LoopCloser(store, synthetic.DEFAULT_CAM, cfg=LoopClosingConfig(edge_cap=16384),
                        device=device)
        ones = np.ones(K, np.float32)
        R, t = store.kf_R[:K].copy(), store.kf_t[:K].copy()
        S12 = sim3.Sim3(torch.tensor(1.0), torch.eye(3), torch.zeros(3))
        out[f"pg_{tag}"] = lc._build_pose_graph(K - 1, 0, S12, ones, R, t, ones.copy(),
                                                R.copy(), t.copy())
        out[f"p_{tag}"] = gather_global_problem_bucketed(store, device)[0]
    rng = np.random.RandomState(0)
    chain = [se3.SE3(torch.eye(3, device=device),
                     torch.as_tensor(rng.normal(size=3).astype(np.float32), device=device))
             for _ in range(28)]
    out["chain"] = backend.build_chain_graph(chain, [(0, 27, chain[3])])
    return out


def loop_graph_calls(loop_inputs: dict, cam) -> list:
    """(row name, graphed function, args, kwargs) of the loop correction's
    graphs on `loop_inputs` (phase 8's, the ring's, phase 14's): a
    Gauss-Newton step of the essential graph and of the LiDAR pose graph,
    and the three graphs of global BA's LM iteration, each at its first
    iteration's state."""
    import torch
    from sqrtlm_slam_tpu_torch.lidar import backend
    from sqrtlm_slam_tpu_torch.loop import essential_graph
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed

    delta = 2.447  # global BA's Huber threshold, sqrt(CHI2_2DOF)
    rows = []
    for tag in ("600kf", "ring"):
        pg = loop_inputs[f"pg_{tag}"]
        rows.append((f"essential_graph_step_{tag}", essential_graph._gn_step_jit,
                     (pg, *essential_graph._step_plans(pg), 1e-6), {}))
        p = loop_inputs[f"p_{tag}"]
        act, plan = p.obs_valid, schur_bucketed.pose_plan(p, p.obs_valid)
        mu = torch.full((), 1e-3, device=p.points.device)
        nu = torch.full((), 2.0, device=p.points.device)
        chi2 = schur_bucketed.chi2_only(p, cam, act, delta)
        head = schur_bucketed._cg_head(p, act, mu, plan, cam, delta, 1e-2)
        lm = dict(cam=cam, robust_delta=delta)
        rows += [
            (f"gba_cg_head_{tag}", schur_bucketed._cg_head_jit, (p, act, mu, plan),
             dict(lm, tol=1e-2)),
            (f"gba_pcg_chunk_{tag}", schur_bucketed._pcg_chunk_jit,
             (head.ctx, head.Mp, p.obs_cam, p.pose_fixed, plan, head.pcg),
             dict(steps=schur_bucketed.PCG_CHECK_EVERY)),
            (f"gba_lm_tail_{tag}", schur_bucketed._lm_tail_jit,
             (p, head.ctx, head.pcg.x, chi2, mu, nu, act), lm),
        ]
    g = loop_inputs["chain"]
    rows.append(("se3_graph_step_chain28", backend._gn_step_jit,
                 (g, *backend._step_plans(g), 1e-6), {}))
    return rows


def _pcg_in_graph_lm_iteration(problem, chi2, mu, nu, active, plan, cam, robust_delta,
                               cg_iters: int):
    """PCG design (a), timed against the port's design (b): one LM iteration
    of `ba_iterate_cg` as one function (one graph), its PCG running all
    `cg_iters` iterations under the done mask, with no read."""
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed as sb

    head = sb._cg_head(problem, active, mu, plan, cam, robust_delta, 1e-2)
    s = sb._pcg_chunk(head.ctx, head.Mp, problem.obs_cam, problem.pose_fixed, plan, head.pcg,
                      cg_iters)
    return sb._lm_tail(problem, head.ctx, s.x, chi2, mu, nu, active, cam, robust_delta)


def pcg_designs(problem, cam, iters: int = 10) -> dict:
    """Global BA's two PCG designs on one problem (`iters` LM iterations of
    `ba_iterate_cg` from its start): (a) one graph an LM iteration, every
    PCG iteration under the done mask, no read (`_pcg_in_graph_lm_iteration`
    in `ba_iterate_cg`'s loop); (b) the port's three graphs, the done flag
    read every `PCG_CHECK_EVERY` iterations. Timed in turns a, b, b, a after
    a warm-up that captures; ms per LM iteration to a synchronize, host
    reads per call, the PCG iterations of the first LM iteration, whether
    the two give the same bits, and the memory (a)'s capture keeps
    (`memory_reserved` after `empty_cache`, before and after its first run,
    with that run's outputs)."""
    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed
    from sqrtlm_slam_tpu_torch.utils import cache

    delta = 2.447
    act = problem.obs_valid
    lm_iteration = cache.graphed(_pcg_in_graph_lm_iteration,
                                 static_argnames=("cam", "robust_delta", "cg_iters"))

    def run_a():
        chi2 = schur_bucketed.chi2_only(problem, cam, act, delta)
        mu = torch.full((), 1e-3, dtype=chi2.dtype, device=chi2.device)
        nu = torch.full((), 2.0, dtype=chi2.dtype, device=chi2.device)
        n_acc = torch.zeros((), dtype=torch.int32, device=chi2.device)
        plan = schur_bucketed.pose_plan(problem, act)
        prob = problem
        for _ in range(iters):
            s = lm_iteration(prob, chi2, mu, nu, act, plan, cam=cam, robust_delta=delta,
                             cg_iters=100)
            prob = prob._replace(pose_R=s.pose_R, pose_t=s.pose_t, points=s.points)
            chi2, mu, nu = s.chi2, s.mu, s.nu
            n_acc = n_acc + s.accept.to(torch.int32)
        return prob, chi2, n_acc

    def run_b():
        return schur_bucketed.ba_iterate_cg(problem, cam, act, iters, robust_delta=delta)

    def kept():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    runs = {"a": run_a, "b": run_b}
    outs, times, reads = {}, {"a": [], "b": []}, {}
    mem0 = kept()
    outs["a"] = run_a()  # captures (a)'s graph
    a_graph_memory_mb = (kept() - mem0) / 2**20
    for design in ("a", "b", "b", "a"):
        if design not in outs:
            outs[design] = runs[design]()  # captures
        out, rec = run_counted(runs[design])
        times[design].append(1e3 * rec["s"] / iters)
        reads[design] = rec["host_reads"]
        if not same_bits(out, outs[design]):
            raise AssertionError(f"PCG design {design}: two runs differ")
    # PCG iterations of the first LM iteration (the eager count).
    plan = schur_bucketed.pose_plan(problem, act)
    mu = torch.full((), 1e-3, device=problem.points.device)
    head = schur_bucketed._cg_head(problem, act, mu, plan, cam, delta, 1e-2)
    s = schur_bucketed._pcg_run(
        lambda st, k: schur_bucketed._pcg_chunk(head.ctx, head.Mp, problem.obs_cam,
                                                problem.pose_fixed, plan, st, k),
        head.pcg, 100, schur_bucketed.PCG_CHECK_EVERY)
    return dict(lm_iterations=iters, a_ms_per_lm_iteration=float(np.median(times["a"])),
                b_ms_per_lm_iteration=float(np.median(times["b"])), a_ms_turns=times["a"],
                b_ms_turns=times["b"], a_host_reads=reads["a"], b_host_reads=reads["b"],
                pcg_iterations_first_lm_iteration=int(utils.to_host(s.n)),
                bitwise_equal=same_bits(outs["a"], outs["b"]),
                a_graph_memory_mb=a_graph_memory_mb)


def init_and_ba_graph_calls(cam, scan) -> list:
    """(row name, graphed function, args, kwargs) of the flat engine's and
    the cg backend's local-BA graphs and the flat global loop on the bench
    problem (96, 8192, 5; `eval/graph_calls.py`, 5 LM iterations a loop),
    of distributed BA's graphs on it over 4 shards (the whole LM loop of 3
    iterations, the bucketed and flat steps, and the segments a process
    group replays), and of the calibration with and without plane terms on
    4096 points of `scan` (sensor frame) from T_CAM_VELO perturbed."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import graph_calls, synthetic
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed

    dev = torch.device("cuda", 0)
    flat, _ = synthetic.make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6,
                                        obs_per_landmark=5)
    problem = schur_bucketed.from_flat(flat, 5, device=dev)
    calls = graph_calls.ba_calls(problem, cam)
    calls.update(graph_calls.dist_calls(problem, cam))
    calls.update(calibration_graph_calls(scan, dev)[0])
    return [(name, fn, a, k) for name, (fn, a, k) in calls.items()]


def calibration_graph_calls(scan, dev):
    """(`eval/graph_calls.py`'s calibration calls on 4096 points of `scan`
    (sensor frame) from T_CAM_VELO perturbed, T_CAM_VELO as an SE3)."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import graph_calls, planeworld
    from sqrtlm_slam_tpu_torch.geometry import se3

    pts = np.asarray(scan, np.float32)[:, :3]
    pts = pts[np.random.RandomState(0).choice(len(pts), 4096, replace=False)]
    T_cv = planeworld.T_CAM_VELO
    T_true = se3.SE3(torch.as_tensor(T_cv[:3, :3], dtype=torch.float32, device=dev),
                     torch.as_tensor(T_cv[:3, 3], dtype=torch.float32, device=dev))
    return graph_calls.calibration_calls(torch.as_tensor(pts, device=dev), T_true), T_true


def graphs_phase(kitti=None, street=None, rgbd_system=None, loop_inputs=None,
                 verification_calls=None, device: str = "cuda") -> dict:
    """18. The captured CUDA graphs of the entry points (`utils.cache`), also
    callable alone. `kitti` is phase 4's (frames, poses), `street` phase
    10's (frames (image, scan), T_cam_lidar, right images), `rgbd_system`
    phase 4's graphed system; each is made here when absent.
    (b) per path (RGB-D, stereo, monocular, fusion: frames 0-15; LiDAR
    odometry: scans 0-15), a system run graphed and one eagerly
    (`disable_graphs`; stereo, fusion and odometry eagerly over frames
    0-9 only): ms per frame (median of frames 4 to the third last), then
    the last 2 frames under torch.profiler (CUDA launches = kernel launches
    plus `cudaGraphLaunch`, device ms, idle share) with graph captures,
    replays and host reads per frame;
    (a) every captured function replayed against its eager run on the
    inputs of its last call in (b)'s graphed runs (KITTI size: 1226x370,
    2000 features, 64 x 1800-ray scans, phase 4's local-BA problem, the
    keyframes' triangulation and fuse): every output bitwise equal
    (max_abs_err 0), eager and replay ms per call, the memory a fresh
    capture keeps;
    (c) the graphed and the eager RGB-D runs over phase 4's 16 frames (and
    phase 4's own system): trajectories, keyframe poses and landmarks
    bitwise equal;
    (d) the tracking step's stage A, two designs on (b)'s last RGB-D step:
    three graphs with the inlier read between them (sync mode) and one
    graph that runs stage A at both radii and selects by `torch.where` (no
    read; pipelined mode): wall and CUDA-event ms per step, with and
    without the retry, both bitwise equal to the eager step;
    (e) the loop correction's graphs (`loop_inputs`: phase 8's 600-keyframe
    problem and essential graph, the ring's at its loop, phase 14's chain;
    `make_loop_inputs` when absent) and relocalisation's and the Sim3
    verification's (`verification_calls`: the last calls of phases 9 and
    11; `make_verification_calls` when absent), and the flat engine's,
    the cg backend's local BA's and the calibration's
    (`init_and_ba_graph_calls`: the bench problem, phase 10's first scan):
    each replayed against its eager run as in (a), the verification's with
    their CUDA launches per call replayed and eager (torch.profiler), and
    global BA's two PCG designs timed on the two problems (`pcg_designs`).
    (c) also compares (b)'s graphed and eager monocular runs.
    Returns K1 / K2 launches of (b)'s graphed runs."""
    import contextlib

    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import planeworld, synthetic
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
    from sqrtlm_slam_tpu_torch.lidar import odometry as odometry_mod
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly
    from sqrtlm_slam_tpu_torch.pipeline import initializer, local_mapping, tracking, triangulation
    from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig
    from sqrtlm_slam_tpu_torch.utils import cache

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    kcam = Camera(**KITTI_INTRINSICS)
    n_frames, n_warm, n_timed_from = 16, 14, 4
    if kitti is None:
        world = synthetic.SyntheticWorld(seed=1, n_points=3000)
        poses = synthetic.forward_trajectory(16, step=0.3)
        kitti = ([world.render(T, kcam, H=KITTI_H, W=KITTI_W) for T in poses], poses)
    frames, poses = kitti
    if street is None:
        world_s = planeworld.street_circuit_world(seed=0)
        f_poses, _ = planeworld.circuit_trajectory(n_frames, step=0.8, start_s=FUSION_START_S)
        f_frames, rights = [], []
        for i, T in enumerate(f_poses):
            img = world_s.render(T, kcam, H=KITTI_H, W=KITTI_W, noise_seed=i)[0]
            scan = world_s.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
            pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
            f_frames.append((img, pts))
            T_r = synthetic.Pose(T.R, T.t - np.array([kcam.bf / kcam.fx, 0, 0], np.float32))
            rights.append(world_s.render(T_r, kcam, H=KITTI_H, W=KITTI_W,
                                         noise_seed=100 + i)[0])
        T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
        street = (f_frames, T_cl, rights)
    f_frames, T_cl, rights = street
    cfg = SystemConfig(orb=ORBConfig(max_features=2000))
    f_cfg = cfg._replace(lidar=lidar_features.LidarConfig())
    mono_cfg = cfg._replace(tracking=TrackingConfig(min_inliers_local=15))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # The last call of every captured function (and of the step), recorded
    # in the graphed runs of (b).
    calls, current_path = {}, [None]
    recorded = [(system_mod, "build_frame_jit"), (system_mod, "build_frame_stereo_jit"),
                (lidar_features, "extract_features_jit"), (tracking, "_stage_a_jit"),
                (tracking, "_stages_bc_jit"), (local_mapping, "_bucketed_local_ba_jit"),
                (odometry_mod, "align_scan"), (odometry_mod, "_retract_jit"),
                (odometry_mod, "_local_delta_jit"), (triangulation, "match_and_triangulate"),
                (local_mapping, "_project_and_match"),
                (local_mapping, "_project_and_match_many"), (tracking, "track_frame_step"),
                (initializer, "_initialize_jit")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr in recorded]

    def recorder(key, fn):
        def call(*a, **k):
            if not getattr(cache._local, "busy", False):  # not a call inside a capture
                calls[key(a, k)] = (fn, a, k)
            return fn(*a, **k)
        return call

    def key_of(attr):
        def key(a, k):
            if attr == "build_frame_jit":
                return ("build_frame_fusion" if k.get("cloud_lidar") is not None else
                        "build_frame_rgbd" if k.get("depth_img") is not None else
                        "build_frame_mono")
            if attr == "_stages_bc_jit":
                fused = (len(a) > 8 and a[8] is not None) or k.get("lidar_map") is not None
                return "stages_bc_fused" if fused else "stages_bc"
            if attr == "track_frame_step":
                return f"step_{current_path[0]}"
            return attr.replace("_jit", "").lstrip("_")
        return key

    paths = {
        "rgbd": (lambda: SlamSystem(kcam, cfg, device=dev),
                 lambda s, i: s.track_depth(*frames[i])),
        "stereo": (lambda: SlamSystem(kcam, cfg, device=dev),
                   lambda s, i: s.track_stereo(f_frames[i][0], rights[i])),
        "mono": (lambda: SlamSystem(kcam, mono_cfg, device=dev),
                 lambda s, i: s.track_monocular(frames[i][0])),
        "fusion": (lambda: SlamSystem(kcam, f_cfg, device=dev),
                   lambda s, i: s.track_fusion(*f_frames[i], T_cam_lidar=T_cl)),
        "lidar_odometry": (lambda: odometry_mod.LidarOdometry(feat_cfg=f_cfg.lidar, device=dev),
                           lambda s, i: s.process(f_frames[i][1])),
    }

    def run_path(name, eager: bool):
        # The eager stereo, fusion and odometry runs stop at 10 frames (timed
        # 4-7, profiled 8-9): only (c)'s RGB-D and monocular runs are compared
        # frame for frame, and an eager frame takes ~1 s.
        make, step = paths[name]
        n_run = n_frames if not eager or name in ("rgbd", "mono") else 10
        n_prof = n_frames - n_warm
        secs = []
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            system = make()
            for i in range(n_run - n_prof):
                t = time.perf_counter()
                step(system, i)
                sync()
                secs.append(time.perf_counter() - t)
            utils.graph_captures = utils.graph_replays = utils.host_reads = 0
            w = profile_window(lambda: [step(system, i) for i in range(n_run - n_prof, n_run)])
        rec = dict(frames=n_run, ms_per_frame=1e3 * float(np.median(secs[n_timed_from:])),
                   first_frame_ms=1e3 * secs[0],
                   **{k: w[k] / n_prof for k in ("kernel_launches", "graph_launches",
                                                 "cuda_launches")},
                   device_ms_per_frame=w["device_ms"] / n_prof,
                   device_idle_share=1.0 - w["device_ms"] / 1e3 / w["wall_s"],
                   profiled_ms_per_frame=1e3 * w["wall_s"] / n_prof,
                   graph_captures_per_frame=utils.graph_captures / n_prof,
                   graph_replays_per_frame=utils.graph_replays / n_prof,
                   host_reads_per_frame=utils.host_reads / n_prof)
        if not (w["cuda_launches"] > 0 and w["device_ms"] > 0):
            raise AssertionError(f"{name}: the profiler saw no launch or no device time: {rec}")
        return system, rec

    # (b) graphed and eager, per path ---------------------------------------
    per_path, systems = {}, {}
    k1 = k2 = 0
    for name in paths:
        hamming.launch_count = assembly.launch_count = 0
        current_path[0] = name
        for mod, attr, fn in originals:
            setattr(mod, attr, recorder(key_of(attr), fn))
        try:
            systems[(name, "graphed")], graphed = run_path(name, eager=False)
        finally:
            for mod, attr, fn in originals:
                setattr(mod, attr, fn)
        k1, k2 = k1 + hamming.launch_count, k2 + assembly.launch_count
        systems[(name, "eager")], eager = run_path(name, eager=True)
        per_path[name] = dict(graphed=graphed, eager=eager)
        emit("graphs_path", path=name, timed_from=n_timed_from, profiled_frames=n_frames - n_warm,
             graphed=graphed, eager=eager,
             launches_ratio=eager["cuda_launches"] / max(graphed["cuda_launches"], 1e-9),
             ms_ratio=eager["ms_per_frame"] / graphed["ms_per_frame"])
        if not graphed["graph_replays_per_frame"] > 0:
            raise AssertionError(f"the graphed {name} run replayed no graph: {graphed}")
        if eager["graph_replays_per_frame"] or eager["graph_captures_per_frame"]:
            raise AssertionError(f"the eager {name} run used graphs: {eager}")

    # (a) every captured function against its eager run ---------------------
    # Pipelined mode's stage A at both radii, on the last stage-A call's
    # inputs (the runs of (b) are sync).
    if "stage_a" in calls:
        _, a, k = calls["stage_a"]
        calls["stage_a_both"] = (tracking._stage_a_both_jit, a[:6] + (10,) + a[6:], k)

    replay = {}
    for name in ("build_frame_rgbd", "build_frame_mono", "build_frame_fusion",
                 "build_frame_stereo", "extract_features", "stage_a", "stages_bc",
                 "stages_bc_fused", "bucketed_local_ba", "stage_a_both", "align_scan",
                 "retract", "local_delta", "match_and_triangulate", "project_and_match",
                 "project_and_match_many", "initialize"):
        if name not in calls:
            raise AssertionError(f"{name} was never called in the graphed runs: {sorted(calls)}")
        fn, a, k = calls[name]
        with cache.disable_graphs():
            want = fn(*a, **k)
            eager_ms = wall_ms(lambda: fn(*a, **k), n=3)
        r0 = utils.graph_replays
        got = fn(*a, **k)
        sync()
        if utils.graph_replays != r0 + 1:
            raise AssertionError(f"{name}: the graphed call did not replay a graph")
        replay_ms = wall_ms(lambda: fn(*a, **k), n=10)
        err = max_abs_diff(got, want)
        replay[name] = dict(bitwise_equal=same_bits(got, want), max_abs_err=err,
                            eager_ms=eager_ms, replay_ms=replay_ms,
                            graph_memory_mb=capture_mb(fn, a, k))
        emit("graphs_replay_vs_eager", function=name, **replay[name])
        if not replay[name]["bitwise_equal"]:
            raise AssertionError(f"{name}: the replay differs from the eager run (max |d| {err})")
    # The fuse's reverse direction: one graph of B unrolled matches against B
    # replays of the single match (the alternative to unrolling).
    many = replay["project_and_match_many"]["replay_ms"]
    emit("graphs_fuse_batch", batch=local_mapping.FUSE_BATCH, many_replay_ms=many,
         single_replay_ms=replay["project_and_match"]["replay_ms"],
         many_over_batch_singles=many / (local_mapping.FUSE_BATCH
                                         * replay["project_and_match"]["replay_ms"]))

    # (c) phase 4's frames graphed and eager ----------------------------------
    def state(s):
        return (s.get_trajectory(), s.store.kf_R, s.store.kf_t, s.store.lm_pos)

    pairs = [(systems[("rgbd", "graphed")], systems[("rgbd", "eager")])]
    if rgbd_system is not None:
        pairs.append((rgbd_system, systems[("rgbd", "eager")]))
    rgbd_equal = all(np.array_equal(x, y) for g, e in pairs
                     for x, y in zip(state(g), state(e)))
    emit("graphs_rgbd_graphed_vs_eager", frames=n_frames, compared=len(pairs),
         bitwise_equal=rgbd_equal,
         keyframes=systems[("rgbd", "graphed")].num_keyframes(),
         local_ba=systems[("rgbd", "graphed")].local_mapper.num_local_ba)
    if not rgbd_equal:
        raise AssertionError("the graphed and the eager RGB-D runs differ")
    mono_g, mono_e = systems[("mono", "graphed")], systems[("mono", "eager")]
    mono_equal = all(np.array_equal(x, y) for x, y in zip(state(mono_g), state(mono_e)))
    emit("graphs_mono_graphed_vs_eager", frames=n_frames, bitwise_equal=mono_equal,
         keyframes=mono_g.num_keyframes(), landmarks=mono_g.num_landmarks(),
         local_ba=mono_g.local_mapper.num_local_ba)
    if not mono_equal:
        raise AssertionError("the graphed and the eager monocular runs differ")

    # (d) stage A: three graphs and a read (sync mode), or stage A at both
    # radii in one graph and no read (pipelined mode) ----------------------
    design_b = tracking._track_frame_step_no_read
    step_fn, a, k = calls["step_rgbd"]
    a = (a[0], a[1], a[2]._replace(ids=None)) + tuple(a[3:])
    designs = {}
    for retry in (False, True):
        args = a[:7] + ((10**6,) if retry else a[7:8]) + a[8:]
        with cache.disable_graphs():
            want = step_fn(*args, **k)
        rec = {}
        for label, fn in (("a_three_graphs_and_a_read", step_fn),
                          ("b_one_graph_both_radii", design_b)):
            got = fn(*args, **k)
            sync()
            rec[label] = dict(ms=wall_ms(lambda: fn(*args, **k), n=20),
                              event_ms=cuda_ms(lambda: fn(*args, **k), n=20),
                              bitwise_equal_to_eager=same_bits(got, want))
            if not rec[label]["bitwise_equal_to_eager"]:
                raise AssertionError(f"stage-A design {label} differs from the eager step")
        designs["retry" if retry else "no_retry"] = rec
        emit("graphs_stage_a_designs", case="retry" if retry else "no_retry", **rec,
             note="sync mode runs design a, pipelined mode design b; ms = wall per step to a "
                  "synchronize; event_ms = CUDA events around the step (device time plus, "
                  "for a, the read's gap); 'retry' forces the widened second stage A")

    # (e) the loop correction's graphs and global BA's two PCG designs -------
    if dev.type == "cuda":
        from sqrtlm_slam_tpu_torch.optim import schur_bucketed

        if loop_inputs is None:
            loop_inputs = make_loop_inputs()
        bench_cam = synthetic.DEFAULT_CAM
        if verification_calls is None:
            verification_calls = make_verification_calls(frames, kcam)
        verification = [(VERIFICATION_ROWS[attr], fn, a, k)
                        for attr, (fn, a, k) in verification_calls.items()]
        for name, fn, a, k in (loop_graph_calls(loop_inputs, bench_cam) + verification
                               + init_and_ba_graph_calls(bench_cam, f_frames[0][1])):
            with cache.disable_graphs():
                want = fn(*a, **k)
                eager_ms = wall_ms(lambda: fn(*a, **k), n=3)
            r0 = utils.graph_replays
            got = fn(*a, **k)
            sync()
            if utils.graph_replays != r0 + 1:
                raise AssertionError(f"{name}: the graphed call did not replay a graph")
            replay_ms = wall_ms(lambda: fn(*a, **k), n=10)
            err = max_abs_diff(got, want)
            replay[name] = dict(bitwise_equal=same_bits(got, want), max_abs_err=err,
                                eager_ms=eager_ms, replay_ms=replay_ms,
                                graph_memory_mb=capture_mb(fn, a, k))
            if name in VERIFICATION_ROWS.values():
                with cache.disable_graphs():
                    w_eager = profile_window(lambda: fn(*a, **k))
                w_replay = profile_window(lambda: fn(*a, **k))
                replay[name].update(
                    launches_replay=w_replay["cuda_launches"],
                    launches_eager=w_eager["cuda_launches"],
                    device_ms_replay=w_replay["device_ms"], device_ms_eager=w_eager["device_ms"])
            emit("graphs_replay_vs_eager", function=name, **replay[name])
            if not replay[name]["bitwise_equal"]:
                raise AssertionError(f"{name}: the replay differs from the eager run "
                                     f"(max |d| {err})")
        for tag in ("ring", "600kf"):
            rec = pcg_designs(loop_inputs[f"p_{tag}"], bench_cam)
            emit("graphs_pcg_designs", problem=tag,
                 shape=list(loop_inputs[f"p_{tag}"].obs_cam.shape), **rec,
                 note="a: one graph an LM iteration, all 100 PCG iterations under the done "
                      "mask, no read (built by the smoke); b: the port's three graphs, the "
                      f"done flag read every {schur_bucketed.PCG_CHECK_EVERY} PCG "
                      "iterations; turns a, b, b, a")
            if not rec["bitwise_equal"]:
                raise AssertionError(f"PCG designs differ on the {tag} problem")
    return dict(hamming=k1, ba_assembly=k2)


def main() -> None:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store, store_ate
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.geometry import se3 as se3_mod
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig, essential_graph
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.ops import build, hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.utils import cache

    CARD = card_line()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Build -----------------------------------------------------------
    built = {}
    t_build = time.perf_counter()
    build.load_all(("hamming", "ba_assembly"))
    for name in ("hamming", "ba_assembly"):
        info = build.build_info(name)
        built[name] = info["build_s"]
        lines = info["ptxas"].splitlines()
        ptxas = [ln.strip() for ln in lines
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        instances = [ln.split("'")[1] for ln in lines if "Compiling entry" in ln and "'" in ln]
        emit("build", kernel=name, build_s=info["build_s"], instances=instances, ptxas=ptxas)
    emit("build_wall", seconds=time.perf_counter() - t_build)

    rng = np.random.RandomState(0)

    def words(n):
        w = rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        return utils.desc_to_torch(w, dev)

    # 2. K1 vs plain ------------------------------------------------------
    k1 = {}
    main_shapes = ((2048, 2000), (4096, 2000), (2000, 2000))
    for Q, T in main_shapes + ((1, 1), (37, 5), (129, 2047), (2047, 129)):
        q, t = words(Q), words(T)
        got = hamming.hamming_matrix(q, t)
        want = hamming.hamming_matrix_plain(q, t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at {(Q, T)}")
        kt = timed_ms(lambda: hamming.hamming_matrix(q, t))
        plain_ms = device_ms(lambda: hamming.hamming_matrix_plain(q, t), n=5)
        lib = {}
        if (Q, T) in main_shapes:
            # The yardstick: 128 - dot / 2 of the +-1 operands, exact in
            # float16 (integers <= 256) with float32 accumulation.
            A, B = pm1_half(q), pm1_half(t)
            c128 = torch.tensor(128.0, dtype=torch.float16, device=dev)
            ref = torch.addmm(c128, A, B.T, alpha=-0.5)
            torch.cuda.synchronize()
            if not torch.equal(ref.to(torch.int32), got):
                raise AssertionError(f"the addmm yardstick differs from K1 at {(Q, T)}")
            lib = dict(library_ms=device_ms(lambda: torch.addmm(c128, A, B.T, alpha=-0.5)),
                       library_unpack_ms=device_ms(lambda: (pm1_half(q), pm1_half(t))))
        k1[(Q, T)] = dict(**kt, plain_ms=plain_ms, **k1_bound(Q, T), **lib)
        emit("k1_vs_plain", shape=[Q, T], exact=True, **k1[(Q, T)])

    # 3. K2 vs plain ------------------------------------------------------
    cam_bench = synthetic.DEFAULT_CAM
    k2 = {}
    k2_err = 0.0
    for P, L, K in ((32, 4096, 8), (96, 8192, 5), (1400, 60000, 7)) + WIDE_K_SHAPES:
        # (1400, 60000, 7): KITTI 00's keyframe count on the bench problem's
        # 14.4 m track, observations nearer than 1 m to a camera dropped.
        big = dict(spacing=96 * 0.15 / P, min_depth=1.0) if P > 96 else {}
        flat, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6,
                                            obs_per_landmark=0 if K == P else K, **big)
        prob = schur_bucketed.from_flat(flat, K, device=dev)
        w = prob.obs_inv_sigma2 * prob.obs_valid.float()
        # The camera pass's slot table, as the LM loops build it once.
        groups = schur_bucketed.camera_groups(prob, prob.obs_valid)
        n_active = int(groups.offsets[-1])
        max_group = int((groups.offsets[1:] - groups.offsets[:-1]).max())
        for delta in (None, 2.447):
            args = (prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points,
                    prob.obs_cam, prob.obs_uvr, w, cam_bench, delta)
            got = assembly.assemble(*args)
            again = assembly.assemble(*args, groups=groups)
            plain32 = assembly.assemble_plain(*args)
            torch.cuda.synchronize()
            for name, g, a in zip(assembly.AssemblyOut._fields, got, again):
                if not torch.equal(g, a):
                    raise AssertionError(f"K2 {name} not repeatable at {(P, L, K, delta)}")
            # Against the plain version evaluated in float64 on the same inputs
            # (see assembly.excess_over_plain for the rule). With hundreds of
            # slots per camera the rule admits the float32 summation bound for
            # Hpp and bp too; the strict rule's excess of K2 and of the
            # float32 plain version is printed beside it. Past 16 slots per
            # landmark a camera holds thousands of slots.
            big_sums = P > 96 or K > 16
            excess = assembly.excess_over_plain(got, *args, rtol=K2_RTOL, atol=K2_ATOL,
                                                camera_sums=big_sums)
            bad = {n: e for n, (e, _) in excess.items() if e > 0}
            if bad:
                raise AssertionError(f"K2 off its plain version at {(P, L, K, delta)}: {bad}")
            strict = {}
            if big_sums:
                strict = {f"strict_excess_{who}": {
                    n: e for n, (e, _) in assembly.excess_over_plain(
                        res, *args, rtol=K2_RTOL, atol=K2_ATOL).items()}
                    for who, res in (("k2", got), ("plain_f32", plain32))}
            args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                      for a in args]
            errs = {n: float((g.double() - p).abs().max()) for n, g, p in
                    zip(assembly.AssemblyOut._fields, got, assembly.assemble_plain(*args64))}
            vs32 = {n: float((g - p).abs().max())
                    for n, g, p in zip(assembly.AssemblyOut._fields, got, plain32)}
            k2_err = max(k2_err, max(errs.values()))
            kt = timed_ms(lambda: assembly.assemble(*args, groups=groups))
            plain_ms = device_ms(lambda: assembly.assemble_plain(*args), n=5)
            k2[(P, L, K, delta)] = dict(**kt, plain_ms=plain_ms,
                                        **k2_bound(P, L, K, n_active))
            emit("k2_vs_plain", shape=[P, L, K], robust_delta=delta, rtol=K2_RTOL,
                 atol=K2_ATOL, max_abs_err_vs_plain_f64=errs,
                 beyond_rtol_atol={n: c for n, (_, c) in excess.items()},
                 max_abs_diff_vs_plain_f32=vs32, repeatable=True,
                 camera_sum_bound=big_sums, **strict,
                 active_slots=n_active, max_slots_per_camera=max_group,
                 u_chunks_per_block=lm_chunks(K), **k2[(P, L, K, delta)])
        del prob, groups, got, again, plain32

    # 4. Main path at KITTI size ------------------------------------------
    kcam = Camera(**KITTI_INTRINSICS)
    world = synthetic.SyntheticWorld(seed=1, n_points=3000)
    poses = synthetic.forward_trajectory(16, step=0.3)
    frames = [world.render(T, kcam, H=KITTI_H, W=KITTI_W) for T in poses]
    cfg = SystemConfig(orb=ORBConfig(max_features=2000))
    hamming.launch_count = 0
    assembly.launch_count = 0
    utils.host_reads = utils.graph_captures = utils.graph_replays = 0
    t0 = time.perf_counter()
    system, secs, tracked = run_sequence(SlamSystem, cfg, kcam, frames, dev, time_from=0)
    first_frames_ms = [1e3 * x for x in secs[:5]]  # the graphs' captures fall here
    secs = secs[5:]
    wall = time.perf_counter() - t0
    launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count}
    reads = utils.host_reads
    ate, _ = ate_rmse(system.get_trajectory(), gt_cam_to_world(poses), align_scale=False)
    main = dict(frames=len(frames), tracked=tracked, keyframes=system.num_keyframes(),
                landmarks=system.num_landmarks(), local_ba=system.local_mapper.num_local_ba,
                launches=launches, ate_m=ate,
                tracked_frames_per_s=1.0 / float(np.median(secs)),
                median_ms=1e3 * float(np.median(secs)), max_ms=1e3 * float(np.max(secs)),
                slowest_over_median=float(np.max(secs) / np.median(secs)),
                first_frames_ms=first_frames_ms, host_reads_per_frame=reads / len(frames),
                graph_captures=utils.graph_captures,
                graph_replays_per_frame=utils.graph_replays / len(frames), wall_s=wall)
    emit("main_path_kitti", **main)
    if tracked != len(frames):
        raise AssertionError(f"tracked {tracked}/{len(frames)} frames")
    if main["keyframes"] < 3 or main["local_ba"] < 1:
        raise AssertionError(f"{main['keyframes']} keyframes, {main['local_ba']} local BAs")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not ate < 0.05:
        raise AssertionError(f"ATE {ate} m >= 0.05 m")

    # 5. bench.py tracking shape ------------------------------------------
    world_b = synthetic.SyntheticWorld(seed=1, n_points=1200)
    poses_b = synthetic.forward_trajectory(16, step=0.3)
    frames_b = [world_b.render(T, cam_bench) for T in poses_b]
    utils.host_reads = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            system_b, secs_b, tracked_b = run_sequence(
                SlamSystem, SystemConfig(orb=ORBConfig(max_features=1000)), cam_bench,
                frames_b, dev, time_from=5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    emit("tracking_bench_shape", frames=len(frames_b), tracked=tracked_b,
         keyframes=system_b.num_keyframes(),
         tracked_frames_per_s=1.0 / float(np.median(secs_b)),
         median_ms=1e3 * float(np.median(secs_b)),
         host_reads_per_frame=utils.host_reads / len(frames_b),
         synchronizing_ops_per_frame=syncs / len(frames_b),
         note="timed under torch.cuda.set_sync_debug_mode('warn')")
    if tracked_b != len(frames_b):
        raise AssertionError(f"bench shape tracked {tracked_b}/{len(frames_b)}")

    # 6. local_ba_lm_iters_per_s ------------------------------------------
    flat, _ = synthetic.make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6,
                                        obs_per_landmark=5)
    prob0 = schur_bucketed.from_flat(flat, 5, device=dev)
    iters, calls = 15, 5

    def ba_call(p):
        out, chi2, _ = schur_bucketed.ba_iterate(p, cam_bench, p.obs_valid, iters,
                                                 robust_delta=2.447)
        return out, chi2

    chi2_0 = float(schur_bucketed.assemble(prob0, cam_bench, prob0.obs_valid, 2.447).chi2)
    out, chi2 = ba_call(prob0)  # warm-up
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = prob0
        for _ in range(calls):
            out, chi2 = ba_call(out)
        chi2_end = float(chi2)
        best = min(best, time.perf_counter() - t0)
    emit("local_ba_lm", shape=[96, 8192, 5], iters_per_call=iters, calls=calls,
         chi2_start=chi2_0, chi2_end=chi2_end,
         local_ba_lm_iters_per_s=calls * iters / best)
    if not chi2_end < chi2_0:
        raise AssertionError(f"chi2 did not fall: {chi2_0} -> {chi2_end}")

    # 7. K3 vs plain ------------------------------------------------------
    # (600, 120000, 7) is global BA's problem at scale: the phase-8 store.
    t0 = time.perf_counter()
    store, true_R, true_t = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5,
                                             drift=4e-4)
    build_store_s = time.perf_counter() - t0
    # Phase 16's map-scale problem: the drifted store, kept on the host.
    scale_problem = gather_global_problem_bucketed(store, "cpu")[0]
    k3 = {}
    k3_err = 0.0
    for P, L, K in ((96, 8192, 5), (600, 120000, 7), (1400, 60000, 7),
                    (6000, 60000, 7)) + WIDE_K_SHAPES:
        if P == 600:
            prob = gather_global_problem_bucketed(store, dev)[0]
        else:
            big = dict(spacing=96 * 0.15 / P, min_depth=1.0) if P > 96 else {}
            flat, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6,
                                                obs_per_landmark=0 if K == P else K, **big)
            prob = schur_bucketed.from_flat(flat, K, device=dev)
        if tuple(prob.obs_cam.shape) != (L, K) or prob.num_poses != P:
            raise AssertionError(f"K3 problem shape {prob.num_poses, *prob.obs_cam.shape}")
        w = prob.obs_inv_sigma2 * prob.obs_valid.float()
        for delta in (None, 2.447):
            args = (prob.pose_R, prob.pose_t, prob.points, prob.obs_cam, prob.obs_uvr, w,
                    cam_bench, delta)
            got = assembly.chi2_sum(*args)
            again = assembly.chi2_sum(*args)
            k2_args = (prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points,
                       prob.obs_cam, prob.obs_uvr, w, cam_bench, delta)
            k2_chi2 = assembly.assemble(*k2_args).chi2
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K3 not repeatable at {(P, L, K, delta)}")
            args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                      for a in args]
            want = float(assembly.chi2_plain(*args64))
            rel = abs(float(got) - want) / abs(want)
            if not rel <= K3_RTOL:
                raise AssertionError(f"K3 off its plain version at {(P, L, K, delta)}: "
                                     f"{float(got)} vs {want} (rel {rel})")
            k3_err = max(k3_err, abs(float(got) - want))
            equal_k2 = bool(torch.equal(got, k2_chi2))
            if not equal_k2:
                raise AssertionError(f"K3 differs from K2's chi2 at {(P, L, K, delta)}: "
                                     f"{float(got)} vs {float(k2_chi2)}")
            kt = timed_ms(lambda: assembly.chi2_sum(*args))
            plain_ms = device_ms(lambda: assembly.chi2_plain(*args), n=10)
            k3[(P, L, K, delta)] = dict(**kt, plain_ms=plain_ms, **k3_bound(P, L, K))
            k2_here = {}
            if delta is not None:
                # K2 at the same shape, as an LM loop calls it: its landmark
                # pass makes the same tile partials as K3. (The plain K2's
                # one-hot camera sum needs L K P floats: timed at P=600 only.)
                groups = schur_bucketed.camera_groups(prob, prob.obs_valid)
                n_active = int(groups.offsets[-1])
                k2_t = timed_ms(lambda: assembly.assemble(*k2_args, groups=groups))
                k2_here = dict(k2_at_this_shape=dict(
                    **k2_t, landmark_pass_ms=sum(
                        v for n, v in k2_t["per_kernel_ms"].items() if "ba_landmark_kernel" in n)
                    if k2_t["per_kernel_ms"] else None,
                    max_slots_per_camera=int((groups.offsets[1:] - groups.offsets[:-1]).max()),
                    **k2_bound(P, L, K, n_active)))
                if P == 600:
                    k2_here["k2_at_this_shape"]["plain_ms"] = device_ms(
                        lambda: assembly.assemble_plain(*k2_args), n=3)
            emit("k3_vs_plain", shape=[P, L, K], robust_delta=delta, rtol=K3_RTOL,
                 chi2=float(got), plain_f64=want, rel_err=rel, repeatable=True,
                 equal_to_k2_chi2=equal_k2, k3_chunks_per_block=chi2_chunks(K),
                 **k3[(P, L, K, delta)], **k2_here)
        if K > 16:
            # Ragged tiles at this K: K3's chi2 bitwise equal to K2's.
            for Lr in (1, 127, 129):
                sub = {f: getattr(prob, f)[:Lr] for f in (
                    "points", "obs_cam", "obs_uvr", "obs_inv_sigma2", "obs_valid")}
                w_r = sub["obs_inv_sigma2"] * sub["obs_valid"].float()
                for delta in (None, 2.447):
                    c3 = assembly.chi2_sum(prob.pose_R, prob.pose_t, sub["points"],
                                           sub["obs_cam"], sub["obs_uvr"], w_r, cam_bench,
                                           delta)
                    c2 = assembly.assemble(prob.pose_R, prob.pose_t,
                                           (~prob.pose_fixed).float(), sub["points"],
                                           sub["obs_cam"], sub["obs_uvr"], w_r, cam_bench,
                                           delta).chi2
                    if not torch.equal(c3, c2):
                        raise AssertionError(f"K3 differs from K2's chi2 at {(P, Lr, K, delta)}")
            emit("k3_equals_k2_ragged", shape=[P, K], landmarks=[1, 127, 129], equal=True)
        del prob

    # 8. Global BA at scale ----------------------------------------------
    ate_drift = store_ate(store, true_R, true_t)
    gba_cfg = LoopClosingConfig(edge_cap=16384, gba_iters=10, gba_chunk=10)
    lc = LoopCloser(store, cam_bench, cfg=gba_cfg, device=dev)
    Kf = store.num_kf
    R_cl = true_R[Kf - 1] @ true_R[0].T
    t_cl = true_t[Kf - 1] - R_cl @ true_t[0]
    S12 = sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R_cl), torch.as_tensor(t_cl))
    ones = np.ones(Kf, np.float32)
    t0 = time.perf_counter()
    pg = lc._build_pose_graph(Kf - 1, 0, S12, ones, store.kf_R[:Kf].copy(),
                              store.kf_t[:Kf].copy(), ones.copy(), store.kf_R[:Kf].copy(),
                              store.kf_t[:Kf].copy())
    eg_build_s = time.perf_counter() - t0
    # The essential graph graphed (the first call captures the step), again
    # (replays only) and eagerly (`disable_graphs`): bitwise equal.
    mem0 = kept_bytes()
    (pg_out, eg_chi2), eg_graphed = run_counted(
        lambda: essential_graph.optimize_pose_graph(pg, num_iters=30))
    eg_memory_mb = (kept_bytes() - mem0) / 2**20
    eg_again_out, eg_again = run_counted(
        lambda: essential_graph.optimize_pose_graph(pg, num_iters=30))
    with cache.disable_graphs():
        eg_eager_out, eg_eager = run_counted(
            lambda: essential_graph.optimize_pose_graph(pg, num_iters=30))

    def eg_bits(out):
        return (out[0].s, out[0].R, out[0].t, out[1])

    eg_equal = (same_bits(eg_bits((pg_out, eg_chi2)), eg_bits(eg_eager_out))
                and same_bits(eg_bits(eg_again_out), eg_bits(eg_eager_out)))
    eg_opt_s = eg_graphed["s"]
    lc._apply_pose_graph(pg_out, Kf)
    ate_eg = store_ate(store, true_R, true_t)
    p0, _ = gather_global_problem_bucketed(store, dev)
    chi2_before = float(schur_bucketed.chi2_only(p0, cam_bench, p0.obs_valid, None))
    n_edges = int(p0.obs_valid.sum())
    loop_inputs = dict(p_600kf=p0, pg_600kf=pg)  # phase 18's inputs at this size
    snapshot = copy.deepcopy(store)
    snapshot_eager = copy.deepcopy(store)
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    mem0 = kept_bytes()
    gba_ok, gba_graphed = run_counted(lc.run_global_ba)
    gba_memory_mb = (kept_bytes() - mem0) / 2**20
    gba_launches = {"ba_assembly": assembly.launch_count,
                    "ba_chi2": assembly.chi2_launch_count}
    gba_s, gba_reads = gba_graphed["s"], gba_graphed["host_reads"]
    ate_gba = store_ate(store, true_R, true_t)
    p1, _ = gather_global_problem_bucketed(store, dev)
    chi2_after = float(schur_bucketed.chi2_only(p1, cam_bench, p1.obs_valid, None))
    del p1
    lc2 = LoopCloser(snapshot, cam_bench, cfg=gba_cfg, device=dev)
    gba2_ok, gba_again = run_counted(lc2.run_global_ba)
    lc3 = LoopCloser(snapshot_eager, cam_bench, cfg=gba_cfg, device=dev)
    with cache.disable_graphs():
        gba3_ok, gba_eager = run_counted(lc3.run_global_ba)
    store_fields = ("kf_R", "kf_t", "lm_pos", "lm_obs_kf")
    repeat_equal = all(np.array_equal(getattr(store, f), getattr(snapshot, f))
                       for f in store_fields)
    gba_eager_equal = all(np.array_equal(getattr(store, f), getattr(snapshot_eager, f))
                          for f in store_fields)
    emit("gba_at_scale", kfs=600, landmarks=120_000, edges=n_edges, gba_iters=10,
         store_build_s=build_store_s, essential_graph_build_s=eg_build_s,
         essential_graph_opt_s=eg_opt_s, essential_graph_edges=int(pg.e_valid.sum()),
         essential_graph_chi2=float(eg_chi2), gba_s=gba_s, gba_repeat_s=gba_again["s"],
         gba_completed=bool(gba_ok), ate_drift_m=ate_drift, ate_after_loop_m=ate_eg,
         ate_after_gba_m=ate_gba, chi2_before=chi2_before, chi2_after=chi2_after,
         launches=gba_launches, host_reads=gba_reads, repeat_bitwise_equal=repeat_equal,
         essential_graph=dict(graphed=eg_graphed, graphed_again=eg_again, eager=eg_eager,
                              graph_memory_mb=eg_memory_mb, bitwise_equal=eg_equal),
         gba=dict(graphed=gba_graphed, graphed_again=gba_again, eager=gba_eager,
                  graph_memory_mb=gba_memory_mb, bitwise_equal=gba_eager_equal),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         note="graphed: the first call (it captures), graphed_again: the same call "
              "replaying only, eager: under disable_graphs; s to a synchronize; "
              "graph_memory_mb: memory_reserved after empty_cache, before and after the "
              "first call; gba_s is graphed.s, host_reads graphed.host_reads")
    if not (gba_ok and gba2_ok and gba3_ok):
        raise AssertionError("global BA at scale did not complete")
    stages = (ate_drift, ate_eg, ate_gba)
    if not all(abs(a - b) <= GBA_ATE_TOL for a, b in zip(stages, GBA_ATE_STAGES)):
        raise AssertionError(f"ATE stages {stages} m not within {GBA_ATE_TOL} m of "
                             f"{GBA_ATE_STAGES}")
    if not chi2_after < chi2_before:
        raise AssertionError(f"GBA chi2 did not fall: {chi2_before} -> {chi2_after}")
    if min(gba_launches.values()) <= 0:
        raise AssertionError(f"a kernel of global BA never launched: {gba_launches}")
    if not repeat_equal:
        raise AssertionError("a second GBA from the same store gave different results")
    if not (eg_equal and gba_eager_equal):
        raise AssertionError(f"graphed and eager differ: essential graph {eg_equal}, "
                             f"global BA {gba_eager_equal}")
    if not (eg_graphed["graph_captures"] >= 1 and gba_graphed["graph_captures"] >= 1
            and eg_again["graph_captures"] == 0 and gba_again["graph_captures"] == 0):
        raise AssertionError(f"captures: essential graph {eg_graphed}, {eg_again}; "
                             f"GBA {gba_graphed}, {gba_again}")
    del store, snapshot, snapshot_eager, lc, lc2, lc3, pg_out

    # 9. The loop path end to end -----------------------------------------
    ring = synthetic.ring_world(seed=7, n_points=2500)
    # The first 148 frames of the 160-frame ring: the loop closes near frame
    # 132-136 (the smoke's time, PERF.md section 4).
    ring_poses = synthetic.ring_trajectory(160, frac=1.3)[:148]
    ring_frames = [ring.render(T, cam_bench) for T in ring_poses]

    def ring_run(eager: bool):
        """The ring through `track_depth` (graphed), its loop corrector graphed
        or, with `eager`, under `disable_graphs`: (system, seconds per frame,
        GBA runs, the loop corrector's calls bracketed by synchronizes:
        (frame, name, ms, result))."""
        loop_sys = SlamSystem(cam_bench, SystemConfig(orb=ORBConfig(max_features=600),
                                                      loop_detection=True),
                              device=dev, loop_cfg=LoopClosingConfig())
        lc = loop_sys.loop_closer
        gba_runs, calls, frame = [], [], [0]
        harness_s = {}  # frame -> seconds of the smoke's own work inside it
        sim3_counts = {}  # frame -> the Sim3 verification's captures, replays, reads
        run_gba = lc.run_global_ba

        def counted_gba(generation=None):
            if "p_ring" not in loop_inputs:  # phase 18's GBA problem at this size
                t = time.perf_counter()
                loop_inputs["p_ring"] = gather_global_problem_bucketed(lc.store, dev)[0]
                torch.cuda.synchronize()
                harness_s[frame[0]] = (harness_s.get(frame[0], 0.0)
                                       + time.perf_counter() - t)
            c2, c3 = assembly.launch_count, assembly.chi2_launch_count
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = run_gba(generation)
            torch.cuda.synchronize()
            s = time.perf_counter() - t
            calls.append((frame[0], "run_global_ba", 1e3 * s, ok))
            gba_runs.append(dict(ok=ok, s=s, kfs=loop_sys.num_keyframes(),
                                 ba_assembly=assembly.launch_count - c2,
                                 ba_chi2=assembly.chi2_launch_count - c3))
            return ok

        def bracket(obj, attr, name):
            fn = getattr(obj, attr)

            def call(*a, **k):
                if name == "essential_graph":
                    loop_inputs.setdefault("pg_ring", a[0])
                torch.cuda.synchronize()
                h0 = harness_s.get(frame[0], 0.0)
                c0 = (utils.graph_captures, utils.graph_replays, utils.host_reads)
                t = time.perf_counter()
                with cache.disable_graphs() if eager else contextlib.nullcontext():
                    out = fn(*a, **k)
                torch.cuda.synchronize()
                s = time.perf_counter() - t - (harness_s.get(frame[0], 0.0) - h0)
                calls.append((frame[0], name, 1e3 * s, out))
                if name == "compute_sim3":
                    acc = sim3_counts.setdefault(frame[0], dict(
                        calls=0, graph_captures=0, graph_replays=0, host_reads=0, args=[]))
                    acc["calls"] += 1
                    acc["args"].append(a)
                    for key, n0 in zip(("graph_captures", "graph_replays", "host_reads"), c0):
                        acc[key] += getattr(utils, key) - n0
                return out
            setattr(obj, attr, call)
            return fn

        lc.run_global_ba = counted_gba
        for attr in ("detect_loop", "compute_sim3", "correct_loop"):
            bracket(lc, attr, attr)
        optimize = bracket(essential_graph, "optimize_pose_graph", "essential_graph")
        secs = []
        try:
            for i, (img, depth) in enumerate(ring_frames):
                frame[0] = i
                t = time.perf_counter()
                pose = loop_sys.track_depth(img, depth)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t - harness_s.get(i, 0.0))
                if pose is None:
                    secs[-1] = -secs[-1]  # untracked: kept apart below
            loop_sys.shutdown()
        finally:
            essential_graph.optimize_pose_graph = optimize
        return loop_sys, secs, gba_runs, calls, sim3_counts

    def loop_frames(secs, calls, sim3_counts):
        """Per frame that committed a loop: its ms and the split, with the
        Sim3 verification's graph captures, replays and host reads."""
        out = []
        for f in sorted({f for f, n, _, ok in calls if n == "correct_loop" and ok is True}):
            ms = {n: 0.0 for n in ("detect_loop", "compute_sim3", "correct_loop",
                                   "essential_graph", "run_global_ba")}
            for fi, n, t, _ in calls:
                if fi == f:
                    ms[n] += t
            total = 1e3 * abs(secs[f])
            out.append(dict(frame=f, total_ms=total, detect_loop_ms=ms["detect_loop"],
                            compute_sim3_ms=ms["compute_sim3"],
                            correct_loop_ms=ms["correct_loop"],
                            essential_graph_ms=ms["essential_graph"],
                            gba_ms=ms["run_global_ba"],
                            fuse_and_rest_of_correct_loop_ms=(
                                ms["correct_loop"] - ms["essential_graph"]
                                - ms["run_global_ba"]),
                            tracking_and_mapping_ms=(total - ms["detect_loop"]
                                                     - ms["compute_sim3"]
                                                     - ms["correct_loop"]),
                            compute_sim3={k: v for k, v in sim3_counts.get(f, {}).items()
                                          if k != "args"}))
        return out

    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = 0
    t0 = time.perf_counter()
    verification_calls = {}  # phase 18's inputs: the last calls of phases 9 and 11
    with recording_last_calls(VERIFICATION_GRAPHS, verification_calls):
        loop_sys, ring_secs, gba_runs, ring_calls, ring_sim3 = ring_run(eager=False)
    ring_wall = time.perf_counter() - t0
    ring_reads = utils.host_reads
    loop_launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                     "ba_chi2": assembly.chi2_launch_count}
    lc = loop_sys.loop_closer
    ring_tracked = sum(t > 0 for t in ring_secs)
    ring_secs = [abs(t) for t in ring_secs]
    est = loop_sys.get_trajectory()
    ring_ate, _ = ate_rmse(est, gt_cam_to_world(ring_poses[: len(est)]))
    k3_in_gba = sum(r["ba_chi2"] for r in gba_runs)
    emit("loop_path_ring", frames=len(ring_frames), tracked=ring_tracked,
         keyframes=loop_sys.num_keyframes(), landmarks=loop_sys.num_landmarks(),
         loops_closed=lc.num_loops_closed, loops_rejected=lc.num_loops_rejected,
         last_fused=lc.last_fused, gba_completed=lc.num_gba_completed, gba_runs=gba_runs,
         launches=loop_launches, ate_m=ring_ate,
         median_ms=1e3 * float(np.median(ring_secs)), max_ms=1e3 * float(np.max(ring_secs)),
         loop_frames=loop_frames(ring_secs, ring_calls, ring_sim3),
         host_reads_per_frame=ring_reads / len(ring_frames), wall_s=ring_wall,
         note="graphed (the entry point's default); loop_frames: the frames that committed "
              "a loop, split by the loop corrector's calls bracketed by synchronizes "
              "(correct_loop holds the essential graph and, in sync mode, the GBA); the "
              "smoke's own gather of phase 18's problem is left out of every time")
    if ring_tracked < len(ring_frames) - 2:
        raise AssertionError(f"ring: tracked {ring_tracked}/{len(ring_frames)}")
    if lc.num_loops_closed < 1 or lc.last_fused < 20:
        raise AssertionError(f"ring: {lc.num_loops_closed} loops, {lc.last_fused} fused")
    if not ring_ate < 0.3:
        raise AssertionError(f"ring ATE {ring_ate} m >= 0.3 m")
    if k3_in_gba <= 0 or min(loop_launches.values()) <= 0:
        raise AssertionError(f"ring: a kernel never launched: {loop_launches}, {gba_runs}")
    # The same ring with its loop corrector eager (`disable_graphs` around
    # detection, Sim3 and the correction), for its loop frame's split.
    t0 = time.perf_counter()
    eager_sys, eager_secs, eager_gba, eager_calls, eager_sim3 = ring_run(eager=True)
    eager_wall = time.perf_counter() - t0

    def ring_state(s):
        st = s.store
        return (s.get_trajectory(), st.kf_R[:st.num_kf], st.kf_t[:st.num_kf],
                st.lm_pos[:st.num_lm], st.lm_valid[:st.num_lm])

    ring_equal = [same_bytes(a, b) for a, b in zip(ring_state(loop_sys), ring_state(eager_sys))]
    # The loop frame's Sim3 verification again on its store, graphed (replays
    # only) and eagerly, under the profiler: CUDA launches and device ms.
    loop_f = max((f for f, n, _, ok in ring_calls if n == "correct_loop" and ok is True),
                 default=None)
    sim3_profile = {}
    if loop_f is not None:
        a = ring_sim3[loop_f]["args"][-1]
        for label, ctx in (("graphed", contextlib.nullcontext), ("eager", cache.disable_graphs)):
            with ctx():
                warm = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    lc.compute_sim3(*a)
                    torch.cuda.synchronize()
                    warm.append(1e3 * (time.perf_counter() - t))
            utils.graph_captures = utils.graph_replays = utils.host_reads = 0
            with ctx():
                w = profile_window(lambda: lc.compute_sim3(*a))
            sim3_profile[label] = dict(
                ms=1e3 * w["wall_s"], cuda_launches=w["cuda_launches"],
                kernel_launches=w["kernel_launches"], graph_launches=w["graph_launches"],
                device_ms=w["device_ms"], graph_captures=utils.graph_captures,
                graph_replays=utils.graph_replays, host_reads=utils.host_reads,
                accepted=bool(w["out"][0]), unprofiled_ms=warm)
        # compute_sim3 over the whole ring: its captures against what a
        # replay saves.
        sim3_totals = [sum(t for _, n, t, _ in c if n == "compute_sim3")
                       for c in (ring_calls, eager_calls)]
        sim3_profile["ring_compute_sim3_ms"] = dict(zip(("graphed", "eager"), sim3_totals))
        sim3_profile["calls_to_repay_the_captures"] = calls_to_repay(
            *sim3_totals, float(np.median(sim3_profile["graphed"]["unprofiled_ms"])),
            float(np.median(sim3_profile["eager"]["unprofiled_ms"])))
    emit("loop_path_ring_eager", frames=len(ring_frames),
         tracked=sum(t > 0 for t in eager_secs), keyframes=eager_sys.num_keyframes(),
         loops_closed=eager_sys.loop_closer.num_loops_closed, gba_runs=eager_gba,
         median_ms=1e3 * float(np.median(np.abs(eager_secs))),
         max_ms=1e3 * float(np.max(np.abs(eager_secs))),
         loop_frames=loop_frames(eager_secs, eager_calls, eager_sim3), wall_s=eager_wall,
         bitwise_equal_to_graphed=dict(zip(("trajectory", "kf_R", "kf_t", "lm_pos", "lm_valid"),
                                           ring_equal)),
         sim3_at_the_loop_frame=dict(frame=loop_f, **sim3_profile),
         note="tracking and mapping graphed; detect_loop, compute_sim3 and correct_loop "
              "(with the essential graph and the GBA) under disable_graphs; "
              "sim3_at_the_loop_frame: the loop frame's last compute_sim3 call again on the "
              "final store, graphed and eager, 3 times each (unprofiled_ms), then under "
              "torch.profiler; calls_to_repay_the_captures: further compute_sim3 calls "
              "after which the graphed ring's compute_sim3 total drops to the eager ring's, "
              "at the median unprofiled ms")
    if not all(ring_equal):
        raise AssertionError(f"the graphed ring and the ring with its loop corrector eager "
                             f"differ: {ring_equal}")
    del loop_sys, eager_sys

    # 10. Camera+LiDAR fusion at KITTI size --------------------------------
    from sqrtlm_slam_tpu_torch.eval import planeworld
    from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
    from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod
    from sqrtlm_slam_tpu_torch.pipeline import local_mapping, tracking
    from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
    from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackState

    n_fusion, n_extra = 28, 4  # the extra frames serve the relocalisation phase
    t0 = time.perf_counter()
    street = planeworld.street_circuit_world(seed=0)
    world_s = time.perf_counter() - t0
    f_poses, _ = planeworld.circuit_trajectory(n_fusion + n_extra, step=0.8,
                                               start_s=FUSION_START_S)
    yaw_turned = yaw_deg(f_poses[n_fusion - 1]) - yaw_deg(f_poses[0])
    t0 = time.perf_counter()
    f_frames = []
    for i, T in enumerate(f_poses):
        blank = n_fusion <= i < n_fusion + 2  # the occluded frames: no image needed
        img = (np.full((KITTI_H, KITTI_W), 16.0, np.float32) if blank else
               street.render(T, kcam, H=KITTI_H, W=KITTI_W, noise_seed=i)[0])
        scan = street.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
        f_frames.append((img, pts))
    render_s = time.perf_counter() - t0
    T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
    f_cfg = SystemConfig(orb=ORBConfig(max_features=2000),
                         lidar=lidar_features.LidarConfig())
    f_gt = gt_cam_to_world(f_poses)
    # The map's frame is the first camera's: ground truth relative to frame 0.
    f_gt_rel = np.linalg.inv(f_gt[0]) @ f_gt

    def fusion_run():
        """One pass over the fusion frames: (system, seconds per frame, tracked,
        LiDAR associations per frame, the frames that inserted a keyframe)."""
        sysf = SlamSystem(kcam, f_cfg, device=dev)
        secs, hits, tracked, kf_frames = [], [], 0, []
        for i, (img, pts) in enumerate(f_frames[:n_fusion]):
            n_kf = sysf.num_keyframes()
            t = time.perf_counter()
            pose = sysf.track_fusion(img, pts, T_cam_lidar=T_cl)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            tracked += pose is not None
            hits.append(sysf.tracker.last_lidar_matches)
            if sysf.num_keyframes() > n_kf:
                kf_frames.append(i)
        return sysf, secs, tracked, hits, kf_frames

    # Local mapping's split: its steps are called outside every captured
    # graph, so they can be bracketed in a graphed run too.
    mapper_steps = [(local_mapping.LocalMapper, "process_keyframe", "process_keyframe"),
                    (local_mapping.LocalMapper, "create_new_map_points", "triangulation"),
                    (local_mapping.LocalMapper, "search_in_neighbors", "fuse"),
                    (local_mapping.LocalMapper, "local_ba", "local_ba"),
                    (local_mapping.LocalMapper, "_lidar_stage", "lidar_stage")]

    def bracketed(patches, record, fn):
        """fn() with each (object, attribute) of `patches` timed into `record`."""
        kept = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
        for obj, attr, name in patches:
            setattr(obj, attr, staged_into(record, name, getattr(obj, attr)))
        try:
            return fn()
        finally:
            for obj, attr, f in kept:
                setattr(obj, attr, f)

    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = utils.graph_captures = utils.graph_replays = 0
    t0 = time.perf_counter()
    fus, f_secs, f_tracked, f_hits, f_kf_frames = fusion_run()
    fusion_wall = time.perf_counter() - t0
    fusion_launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count}
    f_reads = utils.host_reads
    f_graphs = dict(graph_captures=utils.graph_captures,
                    graph_replays_per_frame=utils.graph_replays / n_fusion)
    f_est = fus.get_trajectory()
    f_ate, _ = ate_rmse(f_est, f_gt[: len(f_est)], align_scale=False)
    # Graphed again, local mapping's steps bracketed by synchronizes.
    mapper_s = {}
    fus_b, fb_secs, _, _, _ = bracketed(mapper_steps, mapper_s, fusion_run)
    fus_b_equal = all(np.array_equal(a, b) for a, b in (
        (f_est, fus_b.get_trajectory()), (fus.store.lm_pos, fus_b.store.lm_pos)))
    del fus_b

    # The same frames again, eagerly (`disable_graphs`: a synchronize cannot
    # stand inside a captured graph), every stage bracketed by synchronizes.
    stage_s = {}

    patched = [
        (system_mod, "build_frame_jit", "build_frame"),
        (frame_mod.orb, "extract", "orb_extract"),
        (lidar_features, "extract_features", "lidar_extract_features"),
        (frame_mod, "project_cloud_to_depth_image", "project_cloud_to_depth_image"),
        (frame_mod, "associate_depth", "associate_depth"),
        (tracking, "track_frame_step", "track_frame_step"),
        *mapper_steps,
        (tracking.Tracker, "_store_kf_lidar", "store_kf_lidar"),
    ]
    def eager_fusion():
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with cache.disable_graphs():
                return fusion_run()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fus2, _, f_tracked2, f_hits2, _ = bracketed(patched, stage_s, eager_fusion)
    f_syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_calls = {k: len(v) for k, v in stage_s.items()}
    stage_ms = {k: 1e3 * float(np.median(v)) for k, v in stage_s.items()}
    fusion_equal = all(np.array_equal(a, b) for a, b in (
        (f_est, fus2.get_trajectory()), (fus.store.kf_R, fus2.store.kf_R),
        (fus.store.kf_t, fus2.store.kf_t), (fus.store.lm_pos, fus2.store.lm_pos),
        (fus.store.kf_flat_normal, fus2.store.kf_flat_normal)))
    steady_hits = f_hits[2:]
    steady = np.asarray(f_secs[5:])
    fusion = dict(
        frames=n_fusion, tracked=f_tracked, tracked_rerun=f_tracked2,
        points_per_scan=int(np.mean([len(p) for _, p in f_frames])),
        padded_scan_rows=sorted({len(lidar_features.pad_cloud(p)) for _, p in f_frames}),
        keyframes=fus.num_keyframes(), landmarks=fus.num_landmarks(),
        local_ba=fus.local_mapper.num_local_ba, lidar_stages=fus.local_mapper.num_lidar_stages,
        lidar_matches_min=int(min(steady_hits)), lidar_matches_median=float(np.median(steady_hits)),
        launches=fusion_launches, ate_m=f_ate,
        tracked_frames_per_s=1.0 / float(np.median(f_secs[5:])),
        median_ms=1e3 * float(np.median(f_secs[5:])), max_ms=1e3 * float(np.max(f_secs[5:])),
        slowest_frame=5 + int(np.argmax(steady)),
        slowest_over_median=float(np.max(steady) / np.median(steady)),
        keyframe_frames=f_kf_frames,
        keyframe_frames_ms=[1e3 * f_secs[i] for i in f_kf_frames if i >= 5],
        graphed_stage_ms_median={k: 1e3 * float(np.median(v)) for k, v in mapper_s.items()},
        graphed_stage_ms_max={k: 1e3 * float(np.max(v)) for k, v in mapper_s.items()},
        graphed_stage_calls={k: len(v) for k, v in mapper_s.items()},
        graphed_bracketed_median_ms=1e3 * float(np.median(fb_secs[5:])),
        graphed_bracketed_rerun_bitwise_equal=fus_b_equal,
        host_reads_per_frame=f_reads / n_fusion, **f_graphs,
        synchronizing_ops_per_frame=f_syncs / n_fusion,
        stage_ms_median=stage_ms, stage_calls=n_calls,
        rerun_bitwise_equal=fusion_equal, start_s=FUSION_START_S,
        yaw_turned_deg=yaw_turned, world_s=world_s,
        render_s_per_frame=render_s / len(f_frames), wall_s=fusion_wall,
        note="the first run graphed (the entry point's default), the second graphed with "
             "local mapping's steps bracketed (graphed_stage_*), the third eager; stage "
             "times and synchronizing operations from the third "
             "(torch.cuda.set_sync_debug_mode('warn'), stages bracketed by synchronizes); "
             "rerun_bitwise_equal compares the two; launches, device ms and idle share "
             "graphed and eager: phase 18")
    emit("fusion_kitti", **fusion)
    if abs(yaw_turned) < 30.0:
        raise AssertionError(f"the fusion window turns {yaw_turned} degrees, not >= 30")
    if f_tracked != n_fusion or f_tracked2 != n_fusion:
        raise AssertionError(f"fusion tracked {f_tracked} and {f_tracked2} of {n_fusion}")
    if fusion["keyframes"] < 2 or fusion["lidar_stages"] < 1:
        raise AssertionError(f"fusion: {fusion['keyframes']} keyframes, "
                             f"{fusion['lidar_stages']} LiDAR stages")
    if not f_ate < 0.5:
        raise AssertionError(f"fusion ATE {f_ate} m >= 0.5 m")
    if min(steady_hits) <= 20:
        raise AssertionError(f"fusion: LiDAR associations per frame {f_hits}")
    if min(fusion_launches.values()) <= 0:
        raise AssertionError(f"fusion: a kernel never launched: {fusion_launches}")
    if not fusion_equal or f_hits != f_hits2 or not fus_b_equal:
        raise AssertionError("the graphed and the eager fusion runs on the card differ")
    del fus2

    # 11. Relocalisation and map resume ------------------------------------
    hamming.launch_count = 0
    utils.host_reads = 0
    img_r, pts_r = f_frames[20]
    frame_r = frame_mod.build_frame(
        torch.as_tensor(img_r, device=dev), kcam, f_cfg.orb,
        cloud_lidar=torch.as_tensor(pts_r, device=dev), T_cam_lidar=T_cl, lidar_cfg=f_cfg.lidar)
    buf_r = fus.tracker._gather_local_map()

    def recoveries(eager: bool):
        """Six recoveries drawing from one generator (seed 0), each timed to
        its read of the pose and the inlier count (one read): ms, the host
        arrays, and graph captures, replays and host reads."""
        gen = torch.Generator(device=dev).manual_seed(0)
        ms, outs = [], []
        c0 = (utils.graph_captures, utils.graph_replays, utils.host_reads)
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            for _ in range(6):
                torch.cuda.synchronize()
                t = time.perf_counter()
                pose, n = tracking.recover_pose_no_prior(buf_r, frame_r, kcam, generator=gen)
                outs.append(utils.to_host(pose.R, pose.t, n))
                ms.append(1e3 * (time.perf_counter() - t))
        counts = {k: (getattr(utils, k) - n0) / 6 for k, n0 in zip(
            ("graph_captures", "graph_replays", "host_reads"), c0)}
        return ms, outs, counts

    with recording_last_calls(VERIFICATION_GRAPHS[-1:], verification_calls):
        recover_ms, rec_out, rec_counts = recoveries(eager=False)
    # The eager and the profiled recoveries are comparisons, not the path:
    # K1's launches and the host reads are put back after them.
    path_counts = (hamming.launch_count, utils.host_reads)
    eager_ms, eager_out, eager_counts = recoveries(eager=True)
    recover_equal = all(same_bytes(a, b) for x, y in zip(rec_out, eager_out)
                        for a, b in zip(x, y))
    gen_p = torch.Generator(device=dev).manual_seed(0)
    rec_prof = {}
    for label, ctx in (("graphed", contextlib.nullcontext), ("eager", cache.disable_graphs)):
        with ctx():
            w = profile_window(lambda: utils.to_host(*tracking.recover_pose_no_prior(
                buf_r, frame_r, kcam, generator=gen_p)[1:]))
        rec_prof[label] = dict(cuda_launches=w["cuda_launches"], device_ms=w["device_ms"],
                               ms=1e3 * w["wall_s"])
    hamming.launch_count, utils.host_reads = path_counts
    R_r, t_r, n_r = rec_out[-1]
    n_r = int(n_r)
    recover_err = float(np.linalg.norm(camera_center(synthetic.Pose(R_r, t_r))
                                       - f_gt_rel[20][:3, 3]))

    map_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                            "chip_smoke_map.npz")
    os.makedirs(os.path.dirname(map_path), exist_ok=True)
    fus.save(map_path)
    resumed = SlamSystem.load(map_path, kcam, f_cfg, device=dev)
    os.remove(map_path)
    kfs_loaded = resumed.num_keyframes()
    start_state = resumed.state
    resumed.activate_localization_mode()
    t = time.perf_counter()
    pose_l = resumed.track_fusion(img_r, pts_r, T_cam_lidar=T_cl)
    torch.cuda.synchronize()
    resume_ms = 1e3 * (time.perf_counter() - t)
    resume_err = (float(np.linalg.norm(camera_center(pose_l) - f_gt_rel[20][:3, 3]))
                  if pose_l is not None else float("inf"))
    resume = dict(start_state=start_state, state=resumed.state, err_m=resume_err,
                  candidates_tried=resumed.tracker.reloc_candidates_tried,
                  keyframes_loaded=kfs_loaded, keyframes_after=resumed.num_keyframes(),
                  lidar_matches=resumed.tracker.last_lidar_matches, ms=resume_ms)

    # The running system: two frames with a blank image, then vision returns.
    kfs_before = fus.num_keyframes()
    occl = []
    for img, pts in f_frames[n_fusion:]:
        pose = fus.track_fusion(img, pts, T_cam_lidar=T_cl)
        occl.append(dict(tracked=pose is not None, state=fus.state,
                         candidates_tried=fus.tracker.reloc_candidates_tried))
    last_err = float(np.linalg.norm(camera_center(fus.tracker.pose) - f_gt_rel[-1][:3, 3]))
    emit("relocalisation", recover_pose_no_prior_ms_cold=recover_ms[0],
         recover_pose_no_prior_ms_warm=float(np.median(recover_ms[1:])),
         recover_eager_ms_cold=eager_ms[0], recover_eager_ms_warm=float(np.median(eager_ms[1:])),
         recover_per_call=dict(graphed=dict(rec_counts, **rec_prof["graphed"]),
                               eager=dict(eager_counts, **rec_prof["eager"])),
         recover_bitwise_equal_to_eager=recover_equal,
         recover_calls_to_repay_the_capture=calls_to_repay(
             sum(recover_ms), sum(eager_ms), float(np.median(recover_ms[1:])),
             float(np.median(eager_ms[1:]))),
         recover_inliers=n_r, recover_err_m=recover_err, resume=resume,
         keyframes_before_occlusion=kfs_before, occlusion=occl,
         pose_err_after_recovery_m=last_err, hamming_launches=hamming.launch_count,
         host_reads=utils.host_reads)
    if n_r < 30 or not recover_err < 0.5:
        raise AssertionError(f"recover_pose_no_prior: {n_r} inliers, {recover_err} m off")
    if not recover_equal:
        raise AssertionError("recover_pose_no_prior: the graphed poses differ from the eager")
    if rec_counts["graph_replays"] != 1 or rec_counts["graph_captures"] > 1 / 6 \
            or eager_counts["graph_replays"]:
        raise AssertionError(f"recover_pose_no_prior: graphed {rec_counts}, eager {eager_counts}")
    if start_state != TrackState.LOST or resume["state"] != TrackState.OK \
            or not resume_err < 0.5 or resume["keyframes_after"] != kfs_loaded:
        raise AssertionError(f"resume from the saved map failed: {resume}")
    if kfs_before <= 5:
        raise AssertionError(f"only {kfs_before} keyframes before the occlusion")
    if occl[0]["tracked"] or occl[1]["tracked"] or occl[1]["state"] != TrackState.LOST:
        raise AssertionError(f"blank frames were not lost: {occl}")
    if not (occl[2]["tracked"] or occl[3]["tracked"]) or fus.state != TrackState.OK \
            or not last_err < 0.5:
        raise AssertionError(f"no recovery after the occlusion: {occl}, {last_err} m off")
    if hamming.launch_count <= 0:
        raise AssertionError("relocalisation never launched K1")
    reloc_launches = hamming.launch_count

    # 12. Stereo at KITTI size ---------------------------------------------
    # On the street of phase 10 (its first 16 frames): on phase 4's world of
    # random binary patches a third of the nearest stereo points are
    # mismatches at this width, and the first frame after initialization
    # stalls in both packages (PERF.md section 6).
    n_stereo = 16
    baseline = kcam.bf / kcam.fx
    lefts = [img for img, _ in f_frames[:n_stereo]]
    rights = [street.render(synthetic.Pose(T.R, T.t - np.array([baseline, 0.0, 0.0], np.float32)),
                            kcam, H=KITTI_H, W=KITTI_W, noise_seed=100 + i)[0]
              for i, T in enumerate(f_poses[:n_stereo])]
    depth0 = street.render(f_poses[0], kcam, H=KITTI_H, W=KITTI_W, noise_seed=0)[1]
    # Frame 0's stereo depth against the rendered depth, at the keypoints.
    fr0 = frame_mod.build_frame_stereo(torch.as_tensor(lefts[0], device=dev),
                                       torch.as_tensor(rights[0], device=dev), kcam, cfg.orb)
    d0, xy0 = utils.to_host(fr0.depth, fr0.kp.xy)
    ok0 = d0 > 0
    gt0 = depth0[np.clip(xy0[ok0, 1].astype(int), 0, KITTI_H - 1),
                 np.clip(xy0[ok0, 0].astype(int), 0, KITTI_W - 1)]
    sel0 = gt0 > 0
    stereo_depth_err = float(np.median(np.abs(d0[ok0][sel0] - gt0[sel0]) / gt0[sel0]))
    hamming.launch_count = assembly.launch_count = 0
    utils.host_reads = utils.graph_captures = utils.graph_replays = 0
    st = SlamSystem(kcam, cfg, device=dev)
    st_secs, st_tracked, st_kf_frames = [], 0, set()
    for i, (img_l, img_r) in enumerate(zip(lefts, rights)):
        n_kf = st.num_keyframes()
        t = time.perf_counter()
        pose = st.track_stereo(img_l, img_r)
        torch.cuda.synchronize()
        st_secs.append(time.perf_counter() - t)
        st_tracked += pose is not None
        if st.num_keyframes() > n_kf:
            st_kf_frames.add(i)
    stereo_launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count}
    st_reads = utils.host_reads
    st_graphs = dict(graph_captures=utils.graph_captures,
                     graph_replays_per_frame=utils.graph_replays / len(lefts))
    st_est = st.get_trajectory()
    st_ate, _ = ate_rmse(st_est, f_gt_rel[: len(st_est)], align_scale=False)
    # All CUDA launches of two steady stereo frames.
    st_prof = profile_window(lambda: [st.track_stereo(lefts[k], rights[k]) for k in (14, 15)])
    emit("stereo_kitti", scene="street_circuit_world(seed=0), fusion frames 0-15",
         frames=len(lefts), tracked=st_tracked, keyframes=st.num_keyframes(),
         landmarks=st.num_landmarks(), local_ba=st.local_mapper.num_local_ba,
         stereo_matches_frame0=int(ok0.sum()), depth_median_rel_err_frame0=stereo_depth_err,
         ate_m=st_ate, median_ms=1e3 * float(np.median(st_secs[5:])),
         max_ms=1e3 * float(np.max(st_secs[5:])), slowest_frame=5 + int(np.argmax(st_secs[5:])),
         slowest_over_median=float(np.max(st_secs[5:]) / np.median(st_secs[5:])),
         keyframe_frames_ms=[1e3 * st_secs[i] for i in range(5, len(st_secs))
                             if i in st_kf_frames],
         launches=stereo_launches,
         kernel_launches_per_frame={k: v / len(lefts) for k, v in stereo_launches.items()},
         cuda_launches_per_frame=st_prof["cuda_launches"] / 2,
         device_ms_per_frame=st_prof["device_ms"] / 2,
         device_idle_share=1.0 - st_prof["device_ms"] / 1e3 / st_prof["wall_s"],
         host_reads_per_frame=st_reads / len(lefts), **st_graphs,
         note="cuda launches (kernels and graph launches), device ms and idle share from "
              "torch.profiler over frames 14-15 tracked again after the run")
    if st_tracked < 13:
        raise AssertionError(f"stereo tracked {st_tracked}/{len(lefts)}")
    if not stereo_depth_err < 0.06:
        raise AssertionError(f"stereo depth median relative error {stereo_depth_err}")
    if not st_ate < 0.1:
        raise AssertionError(f"stereo ATE {st_ate} m >= 0.1 m")
    if stereo_launches["hamming"] <= len(lefts):
        raise AssertionError(f"stereo: K1 launched {stereo_launches['hamming']} times")
    del st, fr0

    # 13. Monocular at KITTI size ------------------------------------------
    from sqrtlm_slam_tpu_torch.pipeline import initializer
    from sqrtlm_slam_tpu_torch.pipeline.tracking import TrackingConfig

    init_calls = []
    two_view = initializer.initialize_two_view

    def timed_two_view(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = two_view(*a, **k)
        torch.cuda.synchronize()
        init_calls.append(dict(ms=1e3 * (time.perf_counter() - t), args=a, kwargs=k,
                               frame=len(mono_secs), success=bool(out.success),
                               used_homography=bool(out.used_homography)))
        return out

    mono_cfg = SystemConfig(orb=ORBConfig(max_features=2000),
                            tracking=TrackingConfig(min_inliers_local=15))
    hamming.launch_count = assembly.launch_count = 0
    utils.host_reads = utils.graph_captures = utils.graph_replays = 0
    mono = SlamSystem(kcam, mono_cfg, device=dev)
    mono_secs, mono_tracked = [], 0
    tracking.initializer.initialize_two_view = timed_two_view
    try:
        for img, _ in frames:
            t = time.perf_counter()
            pose = mono.track_monocular(img)
            torch.cuda.synchronize()
            mono_secs.append(time.perf_counter() - t)
            mono_tracked += pose is not None
    finally:
        tracking.initializer.initialize_two_view = two_view
    mono_launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count}
    mono_reads = utils.host_reads
    mono_graphs = dict(graph_captures=utils.graph_captures,
                       graph_replays_per_frame=utils.graph_replays / len(frames))
    mono_est = mono.get_trajectory()
    mono_ate, _ = ate_rmse(mono_est, gt_cam_to_world(poses[-len(mono_est):]), align_scale=True)
    inits = [c for c in init_calls if c["success"]]
    warm_ms = []
    if inits:
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            two_view(*inits[0]["args"], **dict(inits[0]["kwargs"], generator=gen))
            torch.cuda.synchronize()
            warm_ms.append(1e3 * (time.perf_counter() - t))
    # The initializer graphed (its capture made by the run's first call)
    # against its eager body on the same inputs and draws; one call of each
    # under torch.profiler; a fresh process that runs only the monocular
    # path up to the initialization.
    init_cmp, init_frame = {}, inits[0]["frame"] if inits else None
    if inits:
        a0, k0 = inits[0]["args"], inits[0]["kwargs"]

        def init_call(seed=0):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return two_view(*a0, **dict(k0, generator=gen))

        g_out, g_cnt = run_counted(init_call)
        w_g = profile_window(init_call)
        with cache.disable_graphs():
            e_out, e_cnt = run_counted(init_call)
            e_ms = wall_ms(init_call, n=5)
            w_e = profile_window(init_call)
        solver = sorted(n for n in w_g["kernel_names"] | w_e["kernel_names"]
                        if any(t in n.lower() for t in ("svd", "gesdd", "syevj", "cusolver",
                                                        "getrf", "potrf", "magma")))
        init_cmp = dict(
            bitwise_equal_to_eager=same_bits(g_out, e_out), replayed_call=g_cnt,
            eager_call=e_cnt, eager_ms_warm=e_ms,
            cuda_launches=dict(replay=w_g["cuda_launches"], eager=w_e["cuda_launches"]),
            device_ms=dict(replay=w_g["device_ms"], eager=w_e["device_ms"]),
            solver_kernels=solver,
            init_frame_ms=1e3 * mono_secs[init_frame],
            fresh_process=mono_fresh_subprocess([img for img, _ in frames[:init_frame + 1]]))
    emit("mono_kitti", frames=len(frames), tracked=mono_tracked, keyframes=mono.num_keyframes(),
         landmarks=mono.num_landmarks(), local_ba=mono.local_mapper.num_local_ba,
         init_attempts=[{k: c[k] for k in ("frame", "success", "used_homography", "ms")}
                        for c in init_calls],
         init_frame=init_frame,
         used_homography=inits[0]["used_homography"] if inits else None,
         initialize_two_view_ms_cold=init_calls[0]["ms"] if init_calls else None,
         initialize_two_view_ms_warm=float(np.median(warm_ms)) if warm_ms else None,
         initializer_graph=init_cmp,
         ate_sim3_m=mono_ate, median_ms=1e3 * float(np.median(mono_secs[5:])),
         max_ms=1e3 * float(np.max(mono_secs[5:])), launches=mono_launches,
         kernel_launches_per_frame={k: v / len(frames) for k, v in mono_launches.items()},
         host_reads_per_frame=mono_reads / len(frames), **mono_graphs)
    if mono.num_keyframes() < 2 or mono.num_landmarks() <= 80:
        raise AssertionError(f"mono: {mono.num_keyframes()} keyframes, "
                             f"{mono.num_landmarks()} landmarks")
    if mono_tracked < 12:
        raise AssertionError(f"mono tracked {mono_tracked}/{len(frames)}")
    if not mono_ate < 0.4:
        raise AssertionError(f"mono Sim3-aligned ATE {mono_ate} m >= 0.4 m")
    if mono_launches["hamming"] <= 0:
        raise AssertionError("mono: K1 never launched")
    if not init_cmp.get("bitwise_equal_to_eager"):
        raise AssertionError(f"mono: the initializer's replay differs from its eager body: "
                             f"{init_cmp}")
    if init_cmp["replayed_call"]["graph_replays"] != 1 or init_cmp["replayed_call"]["host_reads"]:
        raise AssertionError(f"mono: the initializer did not replay one graph without a read: "
                             f"{init_cmp}")
    if any("svd" in n.lower() or "gesdd" in n.lower() for n in init_cmp["solver_kernels"]):
        raise AssertionError(f"mono: the initializer ran an SVD kernel: {init_cmp}")
    if not init_cmp["fresh_process"]["initialized"]:
        raise AssertionError(f"mono: the fresh process did not initialize: {init_cmp}")
    del mono, init_calls

    # 14. Standalone LiDAR odometry on the fusion scans --------------------
    from sqrtlm_slam_tpu_torch.lidar import odometry as odometry_mod

    scans = [pts for _, pts in f_frames[:n_fusion]]
    # Ground truth: LiDAR -> world of each scan, relative to the first scan.
    T_wl = [M @ T_cv for M in gt_cam_to_world(f_poses[:n_fusion])]
    l_gt = np.stack([np.linalg.inv(T_wl[0]) @ M for M in T_wl])

    def odometry_run(profiled: int = 0):
        """One pass over the scans: (odometry, seconds per scan, stats); the
        last `profiled` scans each under torch.profiler, their counts and
        whether they inserted a keyframe in `scan_windows`."""
        odo = odometry_mod.LidarOdometry(feat_cfg=f_cfg.lidar, device=dev)
        secs, stats = [], []
        for i, pts in enumerate(scans):
            n_kf = odo.num_keyframes
            span = ProfiledSpan() if i >= len(scans) - profiled else None
            if span:
                span.start()
            t = time.perf_counter()
            odo.process(pts)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            if span:
                span.stop()
                scan_windows.append(dict(span.read(), keyframe=odo.num_keyframes > n_kf))
            odo.record_pose()
            stats.append(odo.last_stats)
        return odo, secs, stats

    scan_windows = []

    utils.host_reads = utils.graph_captures = utils.graph_replays = 0
    align_entries = odometry_mod.align_scan.num_entries()
    t0 = time.perf_counter()
    odo, l_secs, l_stats = odometry_run()
    odo_wall = time.perf_counter() - t0
    l_reads = utils.host_reads
    l_graphs = dict(graph_captures=utils.graph_captures,
                    align_scan_captures=odometry_mod.align_scan.num_entries() - align_entries,
                    graph_replays_per_scan=utils.graph_replays / len(scans))
    l_matches = [int(s["matches"]) for s in l_stats[1:]]
    # The graphed launches of the last 3 scans, processed again.
    l_prof_g = profile_window(lambda: [odo.process(p) for p in scans[-3:]])

    def sensor_to_world(chain):  # T_lw poses -> (N, 4, 4) LiDAR -> world
        return gt_cam_to_world([synthetic.Pose(*utils.to_host(p.R, p.t)) for p in chain])

    l_est = sensor_to_world(odo._chain)
    l_ate, _ = ate_rmse(l_est, l_gt, align_scale=False)
    # Graphed again and eagerly (`disable_graphs`), the feature extraction
    # and the alignment bracketed by synchronizes; the eager run's last
    # scans under the profiler.
    l_patched = [(lidar_features, "extract_features_jit", "features"),
                 (odometry_mod, "align_scan", "align_scan")]
    stage_g, stage_l = {}, {}
    odo_g, lg_secs, _ = bracketed(l_patched, stage_g, lambda: odometry_run(profiled=8))
    kf_launches = [w["cuda_launches"] for w in scan_windows if w["keyframe"]]
    other_launches = [w["cuda_launches"] for w in scan_windows if not w["keyframe"]]

    def eager_odometry():
        with cache.disable_graphs():
            run = odometry_run()
            return run, profile_window(lambda: [run[0].process(p) for p in scans[-3:]])

    (odo2, l2_secs, _), l_prof = bracketed(l_patched, stage_l, eager_odometry)
    l_equal = all(torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
                  for a, b in zip(odo._chain, odo2._chain))
    l_rerun_equal = all(torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
                        for a, b in zip(odo._chain, odo_g._chain))
    # Backend: the true relative pose of the last scan w.r.t. the first.
    K = len(odo._chain)
    T_last_first = np.linalg.inv(l_gt[-1])  # world (first scan) -> last scan
    drift_before = float(np.linalg.norm(l_est[-1][:3, 3] - l_gt[-1][:3, 3]))
    T_ji = se3_mod.SE3(torch.as_tensor(T_last_first[:3, :3], dtype=torch.float32, device=dev),
                       torch.as_tensor(T_last_first[:3, 3], dtype=torch.float32, device=dev))
    # The backend graphed (the first call captures the step), again
    # (replays only) and eagerly, each from the same recorded chain.
    from sqrtlm_slam_tpu_torch.lidar import backend as backend_mod

    recorded = list(odo._chain)
    loop_inputs["chain"] = backend_mod.build_chain_graph(recorded, [(0, K - 1, T_ji)])
    mem0 = kept_bytes()
    chain, backend_graphed = run_counted(lambda: odo.backend_for_loop(0, K - 1, T_ji))
    backend_memory_mb = (kept_bytes() - mem0) / 2**20
    backend_ms = 1e3 * backend_graphed["s"]
    odo._chain = list(recorded)
    chain_again, backend_again = run_counted(lambda: odo.backend_for_loop(0, K - 1, T_ji))
    odo._chain = list(recorded)
    with cache.disable_graphs():
        chain_eager, backend_eager = run_counted(lambda: odo.backend_for_loop(0, K - 1, T_ji))
    backend_equal = all(same_bits((a.R, a.t), (b.R, b.t)) and same_bits((a.R, a.t), (c.R, c.t))
                        for a, b, c in zip(chain, chain_again, chain_eager))
    c_last = sensor_to_world(chain[-1:])[0]
    drift_after = float(np.linalg.norm(c_last[:3, 3] - l_gt[-1][:3, 3]))
    emit("lidar_odometry", scans=len(scans), points_per_scan=int(np.mean([len(p) for p in scans])),
         padded_scan_rows=sorted({len(lidar_features.pad_cloud(p)) for p in scans}),
         keyframes=odo.num_keyframes, ate_m=l_ate, matches_min=int(min(l_matches)),
         matches_median=float(np.median(l_matches)),
         median_ms=1e3 * float(np.median(l_secs[1:])), max_ms=1e3 * float(np.max(l_secs[1:])),
         eager_median_ms=1e3 * float(np.median(l2_secs[1:])),
         stage_ms_median={k: 1e3 * float(np.median(v)) for k, v in stage_g.items()},
         eager_stage_ms_median={k: 1e3 * float(np.median(v)) for k, v in stage_l.items()},
         cuda_launches_per_scan=l_prof_g["cuda_launches"] / 3,
         cuda_launches_per_scan_without_keyframe=other_launches,
         cuda_launches_per_keyframe_scan=kf_launches,
         graph_launches_per_scan=l_prof_g["graph_launches"] / 3,
         device_ms_per_scan=l_prof_g["device_ms"] / 3,
         device_idle_share=1.0 - l_prof_g["device_ms"] / 1e3 / l_prof_g["wall_s"],
         eager_cuda_launches_per_scan=l_prof["cuda_launches"] / 3,
         eager_device_ms_per_scan=l_prof["device_ms"] / 3,
         eager_device_idle_share=1.0 - l_prof["device_ms"] / 1e3 / l_prof["wall_s"],
         host_reads_per_scan=l_reads / len(scans), **l_graphs,
         graphed_rerun_bitwise_equal=l_rerun_equal, rerun_bitwise_equal=l_equal,
         yaw_turned_deg=yaw_turned, end_drift_before_m=drift_before,
         end_drift_after_backend_m=drift_after, backend_ms=backend_ms,
         backend=dict(graphed=backend_graphed, graphed_again=backend_again,
                      eager=backend_eager, graph_memory_mb=backend_memory_mb,
                      bitwise_equal=backend_equal),
         wall_s=odo_wall,
         note="the first run graphed (ms per scan, captures, reads), the second graphed with "
              "the stages bracketed by synchronizes (stage_ms_median), the third eager and "
              "bracketed (eager_*); launches, device ms and idle share from torch.profiler "
              "over the last 3 scans processed again after the first and the third run, "
              "and per scan over the second run's last 8 (cuda_launches_per_*: a keyframe "
              "scan rebuilds the local map eagerly); graphed_rerun_bitwise_equal compares "
              "the first two, rerun_bitwise_equal the first and the eager run")
    if not l_ate < 0.5:
        raise AssertionError(f"LiDAR odometry ATE {l_ate} m >= 0.5 m")
    if min(l_matches) <= 100:
        raise AssertionError(f"LiDAR odometry associations per scan {l_matches}")
    if not (l_equal and l_rerun_equal):
        raise AssertionError("the graphed and the eager LiDAR odometry runs on the card differ")
    if l_graphs["align_scan_captures"] > 1:
        raise AssertionError(f"align_scan captured {l_graphs['align_scan_captures']} graphs")
    if not drift_after < 0.3 * drift_before:
        raise AssertionError(f"backend_for_loop: end drift {drift_before} -> {drift_after} m")
    if not backend_equal:
        raise AssertionError("backend_for_loop: graphed and eager chains differ")
    del odo, odo2, odo_g

    # 15. The KITTI runner ------------------------------------------------
    runner = kitti_runner_phase(street=street)
    runner_launches = runner["sync"]["launches"]

    # 16. The flat engine and distributed BA --------------------------------
    backend_poses = synthetic.forward_trajectory(BACKEND_FRAMES, step=0.3)  # phase 4's, on
    backend_frames = list(zip(frames, poses)) + [
        (world.render(T, kcam, H=KITTI_H, W=KITTI_W), T) for T in backend_poses[len(poses):]]
    dist_launches = flat_and_distributed_phase(
        kitti_frames=backend_frames, scale_problem=scale_problem,
        ring_problem=loop_inputs.get("p_ring"), scan=f_frames[0][1])
    del scale_problem

    # 17. More than 16 slots per landmark: local BA and global BA ----------
    wide_launches = wide_k_phase(kitti_frames=list(zip(frames[:10], poses[:10])))

    # 18. The captured CUDA graphs against the eager port --------------------
    graph_launches = graphs_phase(kitti=(frames, poses), street=(f_frames[:16], T_cl, rights),
                                  rgbd_system=system, loop_inputs=loop_inputs,
                                  verification_calls=verification_calls)

    # Summary -------------------------------------------------------------
    def timed(rec, *keys):  # the keys of the summary line
        return {k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by") + keys}

    kernels = [
        dict(name="hamming", route="cuda", source="sqrtlm_slam_tpu_torch/csrc/hamming.cu",
             replaces="sqrtlm_slam_tpu/ops/hamming.py:45",
             launches=fusion_launches["hamming"],
             launches_by_path=dict(kitti_rgbd=launches["hamming"],
                                   fusion=fusion_launches["hamming"],
                                   relocalisation=reloc_launches,
                                   ring_loop=loop_launches["hamming"],
                                   stereo=stereo_launches["hamming"],
                                   mono=mono_launches["hamming"],
                                   kitti_runner=runner_launches["hamming"],
                                   cg_local_ba=dist_launches["cg_local_ba"]["hamming"],
                                   local_ba_obs_cap_24=wide_launches["local_ba"]["hamming"],
                                   graphs_paths=graph_launches["hamming"]),
             max_abs_err=0.0, **timed(k1[(2048, 2000)], "library_ms")),
        dict(name="ba_assembly", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:342",
             launches=fusion_launches["ba_assembly"],
             launches_by_path=dict(kitti_rgbd=launches["ba_assembly"],
                                   fusion=fusion_launches["ba_assembly"],
                                   gba_at_scale=gba_launches["ba_assembly"],
                                   ring_loop=loop_launches["ba_assembly"],
                                   stereo=stereo_launches["ba_assembly"],
                                   mono=mono_launches["ba_assembly"],
                                   kitti_runner=runner_launches["ba_assembly"],
                                   dist_ba=dist_launches["ba_assembly"],
                                   cg_local_ba=dist_launches["cg_local_ba"]["ba_assembly"],
                                   local_ba_obs_cap_24=wide_launches["local_ba"]["ba_assembly"],
                                   gba_obs_per_landmark_32=wide_launches["gba"]["ba_assembly"],
                                   graphs_paths=graph_launches["ba_assembly"]),
             max_abs_err=k2_err,
             **timed(k2[(32, 4096, 8, 2.447)]), library_ms=None),
        dict(name="ba_chi2", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:508",
             launches=loop_launches["ba_chi2"],
             launches_by_path=dict(gba_at_scale=gba_launches["ba_chi2"],
                                   ring_loop=loop_launches["ba_chi2"],
                                   kitti_runner=runner_launches["ba_chi2"],
                                   dist_ba=dist_launches["ba_chi2"],
                                   cg_local_ba=dist_launches["cg_local_ba"]["ba_chi2"],
                                   gba_obs_per_landmark_32=wide_launches["gba"]["ba_chi2"]),
             max_abs_err=k3_err,
             **timed(k3[(600, 120000, 7, 2.447)]), library_ms=None),
    ]
    emit("done", total_s=time.perf_counter() - t_start, build_s=built)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
