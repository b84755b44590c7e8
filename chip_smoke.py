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
     problem), (600, 120000, 7) (phase 8's global-BA problem), (1400,
     280000, 7) (phase 22's, with K2 against its plain version in float64
     there too, at phase 3's rule with the camera-sum bound wherever the
     plain version in float32 keeps it, and the plain K2 timed), and
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
     from its start) in a directory under build/, with `centred=True`:
     64 x 1800-ray scans centred on the columns (and Tr with them; the
     generator's 1440-ray scans give no LiDAR feature). The zlib
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
 19. the long run (`long_run_phase`, also callable alone): `eval/longrun.py`'s
     `run_long` at its defaults (1,000 frames of the 42 m ring over 2.3
     revolutions, 12,000 points, 2,000 features, loop detection on, a
     1,200 x 400,000 store) through its own entry, memory and captures read
     at every progress line and after every loop, every frame and loop
     frame split by stage, each capture timed and placed, launch counters
     zeroed just before and read just after; gates on the outcome against
     the JAX package's CPU run (tracked frames, keyframes and landmarks
     created, the ATE of the first 100-300 frames) and the rest in its
     docstring;
 20. the fusion soak (`kitti_soak_phase`, also callable alone): the KITTI
     runner, `--mode fusion --loop`, over the first KITTI_SOAK_SMOKE_FRAMES
     = 600 frames of `eval/kitti_synth`'s sequence (1226x370, 2.09 laps of
     the 383 m street circuit; the first loop of the second lap on the card
     at frame 593) written first on half the host's cores, at the runner's defaults;
     every 100 frames frames/s, keyframe frames by stage, LiDAR
     associations, captures, replays, memory and RSS; each loop frame
     split; gates on the outcome against the JAX package's CPU run of the
     same files (counts and loops at the deepest frame of its record the
     run reaches, 600 here; the prefix ATEs at frame 500, before either
     run's first loop), on captures after the first loop and on memory
     (its docstring). Alone, `kitti_soak_phase(n_frames=1000, production=True)`
     runs the whole sequence (its counts gated at frame 700, where the
     JAX record ends) and then `--pipelined --async-mapping` over it. Phases 19 and
     20 read their runs through one `RunProbe`, phase 21 through its
     runner-independent half, `GraphProbe`.
     In the whole smoke phases 19 and 20 each run in a child process
     started after phase 8, beside phases 9-18 (their lines are printed
     after phase 18's), so that they fit the smoke's time; alone they run
     undisturbed. The lines of phases 9-21 in a whole smoke carry
     `shared_with`: their times were taken on a card and host the three
     processes shared.
 21. the LiDAR soak (`lidar_soak_phase`, also callable alone): the
     `lidar_slam` node's operating point over `kitti_synth`'s 1,000 scans
     (64 x 1800 rays, scans only; the whole smoke links phase 20's 600
     and writes the rest): (a) `run_kitti --mode lidar` in process, (c)
     `backend_for_loop` / `backend_for_gnss` over (a)'s 1,000-pose chain
     graphed, replayed and eager, (b) mapping mode over the first lap,
     then localization over every scan against its keyframes' map; every
     100 scans scans/s, ms by stage, associations, occupied voxels,
     captures, replays, host reads, memory as held and RSS; gates against
     the JAX package's CPU record (`eval/lidar_soak.py`), on captures and
     on memory (its docstring). In the whole smoke it runs in the main
     process after phase 18, while phases 19 and 20 finish.
 22. the loop correction at KITTI 00's scale (`kitti00_scale_phase`, also
     callable alone): phase 8's flow (benchmarks/bench_scale.py's) at 1,400
     keyframes x 280,000 landmarks, `eval/scale_kitti00.py`'s FLOW: (a) the
     essential graph and the GBA (10 LM iterations in one chunk) each
     graphed, replayed and eager, bitwise equal, with seconds, captures,
     replays, host reads, the memory the captures keep, the peak allocated,
     K2's and K3's launches and the PCG iterations of each LM iteration,
     and the essential graph in float64 against the JAX package's float64
     answer;
     (b) a GBA superseded after its first chunk of 5 (`gba_generation`
     bumped from `_gba_tick`): False, the store untouched, the memory given
     back; then the flow's GBA on that copy gives (a)'s bits. Gated against
     the JAX package's CPU record (`eval/scale_kitti00_jax.json`,
     `scale_kitti00.gates`: the float32 stages within the spread of both
     packages' float32 runs, the CPU's and the card's). In the whole smoke
     it runs in the main process after phase 21, while phase 19's child
     finishes.
 23. distributed BA and the flat engine's global BA at KITTI 00's scale
     (`kitti00_dist_phase`, also callable alone): on phase 22's store after
     the essential graph (alone it builds and corrects it),
     `dist_ba.make_bucketed_lm_iterate` at 4, 2 and 1 shards on the card
     (10 LM iterations, the GBA's robust delta) graphed, replayed and eager,
     bitwise equal, with the memory read before each shard count and after
     its graph is dropped, and 1 shard on the store rescaled by 1 + k
     2^-23 (k = -1, 1); (b) each shard's S_half and rhs_corr at 4 shards
     against the dense one-hot formula; (c) `schur.global_ba_cg` on the
     flat layout, three ways and its draws. Gated by
     `scale_kitti00.dist_gates` against the card's record
     (`eval/scale_kitti00_dist.json`). In the whole smoke it runs in the
     main process right after phase 22.
Then the kernel summary line (each kernel's launches on the main path (K1
and K2: the fusion run; K3: the ring loop; `launches_by_path` has every
path's count, the runner's from run (a), `dist_ba` from phase 16 (b)'s
replayed 4-shard call, `cg_local_ba` from phase 16 (a)'s KITTI-size run with
the cg backend, `graphs_paths` from phase 18 (b)'s graphed runs, `long_run`
from phase 19, `kitti_soak` from phase 20's sync run, `lidar_soak` from
phase 21 (none: LiDAR-only odometry matches no descriptor and runs no
BA), `kitti00_loop_correction` from phase 22 (a)'s graphed GBA,
`kitti00_dist_ba` from phase 23 (a)'s graphed calls at 4, 2 and 1 shards; a
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
import inspect
import json
import os
import subprocess
import sys
import time
import warnings
from typing import Optional

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
# Global BA's problem at KITTI 00's scale (phase 22's; phase 7 checks K2 and
# K3 there): 1,400 keyframes, 280,000 landmarks, 7 slots.
KITTI00_SHAPE = (1400, 280000, 7)


T_START = time.perf_counter()
# Set while the whole smoke runs phase 19 in a child process beside phases
# 9-18: every line emitted meanwhile, in either process, names what shared
# the card and the host with it (`shared_with`), since its times were taken
# under that load. Phases 1-8 run before the child starts and are not
# shared; phase 19 run alone is not either.
SHARED_WITH = None


def emit(phase: str, **fields) -> None:
    shared = {"shared_with": SHARED_WITH} if SHARED_WITH else {}
    print(json.dumps({"phase": phase, "card": CARD, **fields, **shared,
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
    # The generator's 1440-ray scans give no LiDAR feature under the default
    # LidarConfig (a fault of the reference): the writer's centred 64 x
    # 1800-ray scans instead, with the Tr that goes with them.
    t0 = time.perf_counter()
    street = street if street is not None else planeworld.street_circuit_world(seed=0)
    kitti_synth.generate(root, seq="00", n_frames=n_frames, seed=0, step=0.8, centred=True,
                         world=street, log=lambda *a: None)
    generate_s = time.perf_counter() - t0

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
    emit("kitti_runner_setup", frames=n_frames, generate_s=generate_s,
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


# The long run (phase 19): `eval/longrun.py`'s `run_long` at its defaults.
# Its gates on the outcome come from the JAX package's own run of the same
# configuration on the CPU (`scripts/longrun_reference.py --package jax
# --max-landmarks 600000`: at the default 400,000 its store asserts at
# frame 855; PERF.md, "Long run"). It tracked 1,000 of 1,000 frames,
# created 980 keyframes and 468,250 landmarks, closed no loop, and its
# trajectory's ATE over the first 100 / 200 / 300 frames (each prefix
# aligned alone, Sim3) was 9.617 / 12.988 / 18.648 m. The card must track
# at least 0.9 x as many frames, create keyframes within 2 % and landmarks
# within 3 % of its counts, and keep each prefix's ATE within 1.25 x its
# (ORB on the card differs from ORB on the CPU in ~3 % of descriptors, so
# keyframe and loop decisions differ a little). A trajectory collapsed to
# a point reads 16.9 / 30.5 / 38.8 m over those prefixes. The whole run's
# ATE cannot serve: aligned with scale on the 42 m ring, a collapsed
# trajectory reads 41.7 m and a straight line 41.5 m against the JAX
# run's 30.7 m, so no gate on it tells a right map from a wrong one. Nor
# can the prefixes catch every fault: a straight line at the ring's speed
# reads 3.2 / 11.6 / 22.5 m, within the gate (the trajectory at this
# operating point drifts in both packages).
LONG_RUN_JAX_TRACKED = 1000
LONG_RUN_JAX_KEYFRAMES = 980
LONG_RUN_JAX_LANDMARKS = 468250
LONG_RUN_JAX_PREFIX_ATE_M = {100: 9.617, 200: 12.988, 300: 18.648}
LONG_RUN_TRACKED_FRAC = 0.9
LONG_RUN_KEYFRAMES_TOL = 0.02
LONG_RUN_LANDMARKS_TOL = 0.03
LONG_RUN_PREFIX_ATE_FACTOR = 1.25
# End-of-run memory_reserved (after empty_cache) may exceed its reading
# after the first loop by at most this much.
LONG_RUN_MEMORY_MARGIN_MB = 512.0


def rss_mb() -> float:
    """This process's resident host memory now, MB (/proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def percentiles(ms) -> dict:
    ms = np.asarray(ms, float)
    if not len(ms):
        return dict(n=0)
    return dict(n=int(len(ms)), p50_ms=float(np.percentile(ms, 50)),
                p95_ms=float(np.percentile(ms, 95)), max_ms=float(ms.max()))


LOOP_CALLS = ("detect_loop", "compute_sim3", "correct_loop", "run_global_ba")
MAPPING_STAGES = ("map_point_culling", "create_new_map_points", "search_in_neighbors",
                  "local_ba", "keyframe_culling")


class GraphProbe:
    """The captured graphs and the bracketed calls of a run on the card,
    while the `with` block runs (phases 19-21). Each capture is timed and
    placed (`frame`, function, ms, `marked`, a hash of its inputs' shapes);
    each replay is counted by function (`replay_counts`); each call of
    `brackets` ((owner, attribute, stage)) runs between synchronizes, its
    ms added to `stages[stage]` and its calls to `counts[stage]` (the
    caller clears both between items), then `on_call(stage, args, ms,
    out)`. `frame` is the index of the item being run (-1 before the
    first); `marked` is held up while a call of `marking` (a stage) runs.
    `patch(owner, attr, make)` replaces any other attribute for the block
    (`eval/soak.py`'s `Patches`)."""

    marking = None

    def __init__(self, brackets=()):
        from sqrtlm_slam_tpu_torch.eval import soak

        self._patches = soak.Patches()
        self.patch = self._patches.patch
        self.brackets = tuple(brackets)
        self.frame = -1
        self.marked = False
        self.captures, self.replay_counts, self.stages, self.counts = [], {}, {}, {}
        self._names = {}

    def name_of(self, g) -> str:
        from sqrtlm_slam_tpu_torch.utils import cache

        if id(g) not in self._names:
            self._names.update({id(v): k for k, v in cache.graphed_functions().items()})
        return self._names.get(id(g), g.__name__)

    def memory(self, empty: bool = True, **fields) -> dict:
        """Host RSS, the captures so far, the device memory reserved as the
        run holds it and, with `empty`, after `empty_cache` (reserved,
        allocated, the peak allocated)."""
        import torch
        from sqrtlm_slam_tpu_torch import utils
        from sqrtlm_slam_tpu_torch.utils import cache

        torch.cuda.synchronize()
        mb = 1.0 / 2**20
        rec = dict(frame=self.frame + 1, **fields, rss_mb=rss_mb(),
                   graph_captures=utils.graph_captures,
                   captures={k: g.captures for k, g in cache.graphed_functions().items()
                             if g.captures},
                   reserved_as_held_mb=torch.cuda.memory_reserved() * mb)
        if empty:
            torch.cuda.empty_cache()
            rec.update(reserved_mb=torch.cuda.memory_reserved() * mb,
                       allocated_mb=torch.cuda.memory_allocated() * mb,
                       max_allocated_mb=torch.cuda.max_memory_allocated() * mb)
        return rec

    # -- the wrapped methods -----------------------------------------------

    def _capture(self, fn):
        import torch

        probe = self

        def _capture(g, key, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(g, key, *a, **k)
            torch.cuda.synchronize()
            # key = (statics, argument nesting, shapes / strides / dtypes, TF32)
            probe.captures.append((probe.frame, probe.name_of(g),
                                   1e3 * (time.perf_counter() - t), probe.marked,
                                   hash(key[1:3])))
            return out
        return _capture

    def _replay(self, fn):
        probe = self

        def _replay(g, *a, **k):
            name = probe.name_of(g)
            probe.replay_counts[name] = probe.replay_counts.get(name, 0) + 1
            return fn(g, *a, **k)
        return _replay

    def on_call(self, stage: str, args, ms: float, out):
        """After each bracketed call: nothing here."""

    def bracketed(self, stage: str):
        """`make(fn)`: `fn` between synchronizes, its ms added to the item's
        `stages[stage]`."""
        import torch

        probe = self

        def make(fn):
            def call(*a, **k):
                marks = stage == probe.marking
                if marks:
                    probe.marked = True
                torch.cuda.synchronize()
                t = time.perf_counter()
                try:
                    out = fn(*a, **k)
                finally:
                    if marks:
                        probe.marked = False
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                probe.stages[stage] = probe.stages.get(stage, 0.0) + ms
                probe.counts[stage] = probe.counts.get(stage, 0) + 1
                probe.on_call(stage, a, ms, out)
                return out
            return call
        return make

    def __enter__(self):
        from sqrtlm_slam_tpu_torch.utils import cache

        self.patch(cache.Graphed, "_capture", self._capture)
        self.patch(cache.Graphed, "_replay", self._replay)
        for owner, attr, stage in self.brackets:
            self.patch(owner, attr, self.bracketed(stage))
        return self

    def __exit__(self, *exc):
        self._patches.restore()
        return False


class RunProbe(GraphProbe):
    """What phases 19 and 20 read of a long run, while the `with` block runs.

    The system's `track_attr` (`track_depth`, `track_fusion`) is timed
    between synchronizes, a frame at a time: ms, tracked, keyframe
    inserted, loop closed, captures, each bracketed call's ms (`stages`) and
    calls, and `extra(system)`. Bracketed by synchronizes (`GraphProbe`):
    the loop corrector's calls (also kept in `loop_calls`), its keyframe
    insertion (`loop_closer`), the frame build, the landmark reclaim, the
    tracker's keyframe insertion, local mapping's `process_keyframe` and
    `mapping_stages`, the essential graph, and `more` ((owner, attribute,
    stage)). SearchAndFuse's host work inside a correction (`fuse`) is timed
    on the host clock. Each capture is timed and placed (frame, function,
    ms, inside a correction, its inputs' shapes); each replay is counted,
    a per-loop program's (`max_entries=1`) also timed. Every correction is
    kept (frame, committed, ms, the veto), and after a committed one a
    `memory()` reading is kept and emitted as `<name>_loop`. `frame` is
    the index of the frame being tracked (-1 before the first)."""

    marking = "correct_loop"

    def __init__(self, name: str, track_attr: str, mapping_stages=MAPPING_STAGES, more=(),
                 extra=None):
        super().__init__()
        self.name, self.track_attr, self.extra = name, track_attr, extra
        self.mapping_stages, self.more = tuple(mapping_stages), tuple(more)
        self.frames, self.loop_calls, self.corrections = [], [], []
        self.replays, self.after_loop = {}, []
        self._fuse_ms = 0.0

    # -- the wrapped methods -----------------------------------------------

    def _track(self, fn):
        import torch
        from sqrtlm_slam_tpu_torch import utils

        probe = self

        def call(system, *a, **k):
            probe.frame += 1
            lc = system.loop_closer
            kf0, loops0, c0 = system.store.num_kf, lc.num_loops_closed, utils.graph_captures
            probe.stages.clear()
            probe.counts.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(system, *a, **k)
            torch.cuda.synchronize()
            rec = dict(ms=1e3 * (time.perf_counter() - t), tracked=out is not None,
                       keyframe=system.store.num_kf > kf0,
                       loop=lc.num_loops_closed > loops0,
                       captures=utils.graph_captures - c0, stages=dict(probe.stages),
                       calls=dict(probe.counts))
            if probe.extra is not None:
                rec.update(probe.extra(system))
            probe.frames.append(rec)
            return out
        return call

    def _replay(self, fn):
        import torch

        count = super()._replay(fn)
        probe = self

        def _replay(g, *a, **k):
            if g.max_entries != 1:
                return count(g, *a, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = count(g, *a, **k)
            torch.cuda.synchronize()
            probe.replays.setdefault(probe.name_of(g), []).append(
                1e3 * (time.perf_counter() - t))
            return out
        return _replay

    def on_call(self, stage: str, args, ms: float, out):
        if stage in LOOP_CALLS + ("essential_graph",):
            self.loop_calls.append((self.frame, stage, ms, out))
        if stage == "correct_loop":
            self.loop_calls.append((self.frame, "fuse", self._fuse_ms, None))
            self._fuse_ms = 0.0
            self.corrections.append(dict(
                frame=self.frame, committed=bool(out), ms=ms,
                veto=None if out else repr(args[0].last_loop_veto)))
            if out:
                self.after_loop.append(self.memory(at="loop"))
                emit(f"{self.name}_loop", **self.after_loop[-1])

    def _fuse_timed(self, fn):  # SearchAndFuse's host work inside correct_loop
        probe = self

        def call(*a, **k):
            if not probe.marked:
                return fn(*a, **k)
            t = time.perf_counter()
            out = fn(*a, **k)
            probe._fuse_ms += 1e3 * (time.perf_counter() - t)
            return out
        return call

    def __enter__(self):
        from sqrtlm_slam_tpu_torch.loop import closing, essential_graph
        from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
        from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMapper
        from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem
        from sqrtlm_slam_tpu_torch.pipeline.tracking import Tracker

        LC = closing.LoopCloser
        self.patch(SlamSystem, self.track_attr, self._track)
        self.brackets = tuple((LC, attr, attr) for attr in LOOP_CALLS) + (
            (LC, "insert_keyframe", "loop_closer"),
            (system_mod, "build_frame_jit", "frame_build"),
            (SlamSystem, "_reclaim_landmarks", "reclaim_landmarks"),
            (Tracker, "_insert_keyframe_locked", "insert_keyframe"),
            (essential_graph, "optimize_pose_graph", "essential_graph")) + tuple(
            (LocalMapper, a, a) for a in ("process_keyframe",) + self.mapping_stages) + self.more
        super().__enter__()
        for attr in ("_project_loop_points", "_fuse_point"):
            self.patch(LC, attr, self._fuse_timed)
        return self

    # -- the run, read after it ---------------------------------------------

    def loop_frames(self) -> list:
        """Each frame that committed a loop, split by the loop corrector's
        calls (fuse: SearchAndFuse's host work inside `correct_loop`)."""
        out = []
        for f in sorted({f for f, n, _, ok in self.loop_calls
                         if n == "correct_loop" and ok is True}):
            ms = {}
            for fi, n, t, _ in self.loop_calls:
                if fi == f:
                    ms[n] = ms.get(n, 0.0) + t
            total = self.frames[f]["ms"]
            corr = ms.get("correct_loop", 0.0)
            eg, fuse, gba = (ms.get(n, 0.0) for n in ("essential_graph", "fuse",
                                                      "run_global_ba"))
            out.append(dict(
                frame=f, total_ms=total, detect_loop_ms=ms.get("detect_loop", 0.0),
                compute_sim3_ms=ms.get("compute_sim3", 0.0), essential_graph_ms=eg,
                fuse_ms=fuse, gba_ms=gba, rest_of_correct_loop_ms=corr - eg - fuse - gba,
                tracking_and_mapping_ms=(total - ms.get("detect_loop", 0.0)
                                         - ms.get("compute_sim3", 0.0) - corr),
                captures=[(n, c) for fc, n, c, _, _ in self.captures if fc == f]))
        return out

    def captures_after(self, first_loop) -> tuple:
        """(new shapes, other captures) after the first loop: a function
        capturing inputs of a shape it has not captured before, but a
        per-loop program inside a correction (a shape that follows the map
        would); apart, a capture of known shapes under another static
        argument (the widened stage A's radius) or a function's first (a
        path first taken then: a relocalisation)."""
        from sqrtlm_slam_tpu_torch.utils import cache

        if first_loop is None:
            return [], []
        per_loop = {n for n, g in cache.graphed_functions().items() if g.max_entries == 1}
        seen = {(c[1], c[4]) for c in self.captures if c[0] <= first_loop}
        after = [c for c in self.captures if c[0] > first_loop]
        late = [c[:4] for c in after if (c[1], c[4]) not in seen
                and any(n == c[1] for n, _ in seen) and not (c[1] in per_loop and c[3])]
        apart = [c[:4] for c in after if (c[1], c[4]) in seen
                 or not any(n == c[1] for n, _ in seen)]
        return late, apart

    def capture_events(self) -> dict:
        events = {}
        for f, n, ms, inside, _ in self.captures:
            events.setdefault(n, []).append(dict(frame=f, ms=ms, in_correction=inside))
        return events

    def per_loop_programs(self) -> dict:
        """Each per-loop program's captures (warm-up and capture) against
        its replays."""
        events = self.capture_events()
        return {n: dict(captures=len(events.get(n, [])),
                        capture_ms=percentiles([e["ms"] for e in events.get(n, [])]),
                        replays=len(r), replay_ms=percentiles(r))
                for n, r in sorted(self.replays.items())}

    def gba_runs(self) -> list:
        return [dict(frame=f, ms=ms, written_back=bool(ok))
                for f, n, ms, ok in self.loop_calls if n == "run_global_ba"]


def long_run_phase() -> dict:
    """19. The long run, also callable alone: `eval.longrun.run_long` at its
    defaults on the card (1,000 frames of the 42 m ring over 2.3
    revolutions, 12,000 points, 2,000 features, loop detection on, a
    1,200 x 400,000 store) through its own entry, read by a `RunProbe`
    (`track_depth`): every frame timed (a keyframe frame is one that
    inserted a keyframe), the render apart, every loop frame split into
    detection, Sim3, the essential graph, the fuse (SearchAndFuse's
    projections and merges) and global BA, each capture timed and placed,
    each replay of the per-loop programs (`max_entries=1`: the essential
    graph's step, global BA's three graphs) timed, so a recapture's cost
    stands beside a replay's; its `log` hook reads device memory (after
    `empty_cache`), host RSS and each graphed function's captures at every
    progress line (every 50 frames), and the probe the same after every
    committed loop. Launch counters are zeroed just before the run and read
    just after. Then the place-recognition precision / recall of the run's
    store. Gates: every frame processed, >= 1 loop closed and >= 1 GBA
    written back, K1, K2 and K3 launched, after the first loop no graphed
    function captures inputs of a shape it has not captured before but the
    per-loop programs inside a loop's correction (a function's first
    capture, or one of known shapes under another static argument, is
    listed apart), memory_reserved at the end within
    LONG_RUN_MEMORY_MARGIN_MB of the first loop's, and the outcome against
    the JAX package's CPU run: tracked frames, keyframes and landmarks
    created, and the ATE of the first 100, 200 and 300 frames (the
    constants above say how, and why the whole run's ATE is not gated).
    Returns the launch counts."""
    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import longrun, synthetic
    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse, rpe
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly

    defaults = {k: v.default for k, v in inspect.signature(longrun.run_long).parameters.items()}
    n_frames = defaults["n_frames"]
    probe = RunProbe("long_run", "track_depth")
    render_ms = []
    progress = []

    def log(msg: str):
        progress.append(dict(line=msg, **probe.memory(at="progress")))
        emit("long_run_progress", **progress[-1])

    def timed_render(fn):
        def render(self, *a, **k):
            t = time.perf_counter()
            out = fn(self, *a, **k)
            render_ms.append(1e3 * (time.perf_counter() - t))
            return out
        return render

    probe.patch(synthetic.SyntheticWorld, "render", timed_render)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = probe.memory(at="start")
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = 0
    t0 = time.perf_counter()
    with probe:
        summary, system = longrun.run_long(log=log)
    wall = time.perf_counter() - t0
    launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                "ba_chi2": assembly.chi2_launch_count}
    reads = utils.host_reads
    end = probe.memory(at="end")
    lc = system.loop_closer
    frames = probe.frames

    # Frames: the first and the last 100, keyframe frames apart from the rest.
    def exclusive(f) -> dict:
        """A frame's ms by stage, each without the stages inside it."""
        st = f["stages"]
        get = lambda n: st.get(n, 0.0)  # noqa: E731
        parts = {n: get(n) for n in MAPPING_STAGES}
        out = dict(frame_build=get("frame_build"), reclaim_landmarks=get("reclaim_landmarks"),
                   tracking=(f["ms"] - get("frame_build") - get("reclaim_landmarks")
                             - get("insert_keyframe")),
                   insert_keyframe=(get("insert_keyframe") - get("process_keyframe")
                                    - get("loop_closer")),
                   **parts, rest_of_mapping=get("process_keyframe") - sum(parts.values()),
                   loop_closer=get("loop_closer"), detect_loop=get("detect_loop"),
                   compute_sim3=get("compute_sim3"),
                   correct_loop=get("correct_loop"),
                   compute_sim3_calls=f["calls"].get("compute_sim3", 0),
                   correct_loop_calls=f["calls"].get("correct_loop", 0))
        return out

    def split(part):
        kf = [f for f in part if f["keyframe"] and not f["loop"]]
        rest = [f["ms"] for f in part if not f["keyframe"]]
        by_stage = [exclusive(f) for f in kf]
        return dict(keyframe_frames=percentiles([f["ms"] for f in kf]),
                    other_frames=percentiles(rest),
                    keyframe_frame_stage_p50_ms={
                        n: float(np.median([e[n] for e in by_stage])) for n in by_stage[0]}
                    if by_stage else {})

    steady = [f for f in frames[100:] if not f["loop"] and not f["captures"]]
    frame_split = dict(first_100=split(frames[:100]), last_100=split(frames[-100:]),
                       all=split(frames),
                       keyframe_frame_p50_ms_by_100=[
                           percentiles([f["ms"] for f in frames[i:i + 100]
                                        if f["keyframe"] and not f["loop"]]).get("p50_ms")
                           for i in range(0, len(frames), 100)],
                       steady_frames_per_s=(len(steady) / (1e-3 * sum(f["ms"] for f in steady))
                                            if steady else None),
                       steady_note="frames 100 on, without a loop or a capture")
    loop_frames = probe.loop_frames()
    first_loop = loop_frames[0]["frame"] if loop_frames else None
    late, apart = probe.captures_after(first_loop)
    poses = synthetic.ring_trajectory(n_frames, radius=defaults["radius"],
                                      frac=defaults["revolutions"])
    pr = longrun.evaluate_place_recognition(system, poses, log=lambda m: None)
    # The trajectory's error along the run: aligned once (as run_long's
    # ATE), RMS per 100 frames; the ATE of prefixes, each aligned alone.
    est = system.get_trajectory()
    ids = np.asarray(system.trajectory_frame_ids()[: len(est)])
    gt = gt_cam_to_world([poses[int(i)] for i in ids])
    _, aligned = ate_rmse(est, gt)
    err = np.linalg.norm(aligned - gt[:, :3, 3], axis=-1)
    rpe_t, rpe_r = rpe(est, gt)
    trajectory = dict(
        error_rms_m_by_100=[float(np.sqrt(np.mean(err[(ids >= i) & (ids < i + 100)] ** 2)))
                            if ((ids >= i) & (ids < i + 100)).any() else None
                            for i in range(0, n_frames, 100)],
        ate_m_of_first={int(k): ate_rmse(est[ids < k], gt[ids < k])[0]
                        for k in range(100, n_frames + 1, 100) if (ids < k).sum() > 2},
        rpe_1_frame=dict(t_m=rpe_t, r_deg=rpe_r))
    after_loop = probe.after_loop
    mem_first = after_loop[0]["reserved_mb"] if after_loop else None
    out = dict(summary=summary, loops_closed=lc.num_loops_closed,
               loops_rejected=lc.num_loops_rejected, corrections=probe.corrections,
               gba_runs=probe.gba_runs(), gba_completed=lc.num_gba_completed,
               gba_aborted=lc.num_gba_aborted, launches=launches,
               host_reads_per_frame=reads / max(len(frames), 1),
               place_recognition=pr, trajectory=trajectory, frames=frame_split,
               render=percentiles(render_ms),
               loop_frames=loop_frames, captures_by_function=end["captures"],
               replays_by_function=dict(sorted(probe.replay_counts.items())),
               capture_events=probe.capture_events(),
               per_loop_programs=probe.per_loop_programs(),
               new_shapes_after_first_loop=late,
               other_captures_after_first_loop=apart,
               memory=dict(start=at_start, after_each_loop=after_loop, end=end,
                           reserved_end_minus_first_loop_mb=(
                               end["reserved_mb"] - mem_first if mem_first is not None
                               else None)),
               wall_s=wall)
    emit("long_run", **out,
         note="run_long at its defaults through its own entry; frames: track_depth bracketed "
              "by synchronizes (keyframe frames without a loop apart from the rest); "
              "loop_frames: the frames that committed a loop, split by the loop corrector's "
              "calls bracketed by synchronizes (fuse: SearchAndFuse's projections and merges "
              "inside correct_loop, host clock); memory after torch.cuda.empty_cache; "
              "per_loop_programs: each max_entries=1 program's captures (warm-up and "
              "capture) against its replays")
    prefix_ate = trajectory["ate_m_of_first"]
    bad = []
    if len(frames) != n_frames:
        bad.append(f"{len(frames)} of {n_frames} frames processed")
    if lc.num_loops_closed < 1 or lc.num_gba_completed < 1:
        bad.append(f"{lc.num_loops_closed} loops closed, {lc.num_gba_completed} GBAs")
    if min(launches.values()) <= 0:
        bad.append(f"a kernel never launched: {launches}")
    if late:
        bad.append(f"new input shapes captured after the first loop: {late}")
    if mem_first is not None and not (
            end["reserved_mb"] <= mem_first + LONG_RUN_MEMORY_MARGIN_MB):
        bad.append(f"memory_reserved {end['reserved_mb']} MB at the end against "
                   f"{mem_first} MB after the first loop")
    if summary["tracked"] < LONG_RUN_TRACKED_FRAC * LONG_RUN_JAX_TRACKED:
        bad.append(f"tracked {summary['tracked']} < {LONG_RUN_TRACKED_FRAC} x "
                   f"{LONG_RUN_JAX_TRACKED}")
    for key, jax, tol in (("keyframes_created", LONG_RUN_JAX_KEYFRAMES, LONG_RUN_KEYFRAMES_TOL),
                          ("landmarks_created", LONG_RUN_JAX_LANDMARKS, LONG_RUN_LANDMARKS_TOL)):
        if not abs(summary[key] - jax) <= tol * jax:
            bad.append(f"{key} {summary[key]} not within {tol:.0%} of the JAX run's {jax}")
    for k, jax in LONG_RUN_JAX_PREFIX_ATE_M.items():
        if not prefix_ate.get(k, float("inf")) <= LONG_RUN_PREFIX_ATE_FACTOR * jax:
            bad.append(f"ATE of the first {k} frames {prefix_ate.get(k)} m > "
                       f"{LONG_RUN_PREFIX_ATE_FACTOR} x the JAX run's {jax} m")
    if bad:
        raise AssertionError("long run: " + "; ".join(bad))
    return launches


CHILD_PHASES = {  # name -> (the call a child process makes, its niceness)
    "long_run": ("long_run_phase()", 0),
    # Phase 20 and its writer's processes yield the host's cores to phases
    # 9-19, which end later.
    "kitti_soak": ("kitti_soak_phase()", 5),
}


def start_child_phases() -> dict:
    """Phases 19 (at its full depth) and 20 (at KITTI_SOAK_SMOKE_FRAMES),
    each in a child process of its own, their
    output to build/chip_smoke_<name>.log: the whole smoke starts them
    after phase 8 (the kernel and BA timings) and reads them after phase
    18, so that their mostly host work fits the smoke's time beside phases
    9-18 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). The card and
    the host are shared meanwhile: each phase run alone gives its
    undisturbed times, and every line the three processes emit meanwhile
    says what it shared with (`SHARED_WITH`); phase 20's child runs at
    niceness 5. The children are killed if the smoke exits or dies first."""
    global SHARED_WITH
    import atexit
    import ctypes
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)

    def die_with_parent():  # PR_SET_PDEATHSIG: SIGKILL when the smoke dies
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)

    children = {}
    for name, (call, niceness) in CHILD_PHASES.items():
        path = os.path.join(here, "build", f"chip_smoke_{name}.log")
        code = ("import json, torch, chip_smoke as c; "
                "torch.backends.cuda.matmul.allow_tf32 = False; c.CARD = c.card_line(); "
                "c.SHARED_WITH = 'phases 9-18 and the other of 19-20 (processes of "
                "their own), while they run'; "
                f"print(json.dumps({{'launches': c.{call}}}), flush=True)")
        with open(path, "w") as log:
            child = subprocess.Popen([sys.executable, "-c", code], cwd=here, stdout=log,
                                     stderr=subprocess.STDOUT,
                                     preexec_fn=lambda n=niceness: (die_with_parent(),
                                                                    os.nice(n)))
        atexit.register(lambda c=child: c.poll() is None and c.kill())
        children[name] = (child, path)
    SHARED_WITH = "phases 19 and 20 (child processes)"
    return children


def finish_child_phases(children: dict) -> dict:
    """Wait for phases 19 and 20's children, print their lines and return
    their launch counts by name; raise with a failed child's last lines."""
    global SHARED_WITH
    launches, failed = {}, []
    for name, (child, path) in children.items():
        rc = child.wait()
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines:
            if line.startswith('{"launches"'):
                launches[name] = json.loads(line)["launches"]
            elif line.startswith('{"phase"'):
                print(line, flush=True)
        if rc != 0 or name not in launches:
            failed.append(f"{name} (a child process) failed, rc {rc}:\n"
                          + "\n".join(lines[-40:]))
    SHARED_WITH = None
    if failed:
        raise AssertionError("\n".join(failed))
    return launches

# 20. The fusion soak. The JAX package's record of the same files (its
# runner on the CPU through `scripts/kitti_soak_reference.py --package jax`;
# PERF.md section 5), read at the depths a run is gated at: the counts and
# the ATE of each prefix as they stood after that frame (its progress
# lines; the run reached frame 700 of 1,000). Its first loop committed at
# frame 592 (the card's at 593), so the whole smoke's depth, 600, takes
# both runs through their first loop and its GBA. A run's counts and loops
# are gated at the deepest of these frames it reaches, its prefix ATEs at
# frame 500, the last reading before either run's first loop (a loop
# correction re-draws them); a run shorter than 500 frames is not run.
# The margins are `kitti_soak.GATES` (why: its comment).
KITTI_SOAK_SMOKE_FRAMES = 600  # the whole smoke's depth (see KITTI_SOAK_JAX)
KITTI_SOAK_ATE_DEPTH = 500
KITTI_SOAK_JAX = {
    500: dict(frames=500, tracked=500, keyframes_created=372, landmarks_created=225936,
              loops_closed=0, ate_m_of_first={100: 0.1072, 200: 0.2643, 300: 0.3896,
                                              500: 0.7603}),
    600: dict(frames=600, tracked=599, keyframes_created=451, landmarks_created=274191,
              loops_closed=1, ate_m_of_first={100: 0.1367, 200: 0.7349, 300: 1.6839,
                                              500: 2.2556}),
    700: dict(frames=700, tracked=699, keyframes_created=542, landmarks_created=332529,
              loops_closed=3, ate_m_of_first={100: 0.0857, 200: 0.487, 300: 1.0735,
                                              500: 1.6002}),
}
# sha256 of the sequence the JAX run read (`kitti_soak.digest`) over its
# first N frames: the card's equal means the runs read the same bytes.
KITTI_SOAK_DIGEST = {
    600: "6da1e11687acae20c48c095303db50e993b7e491f465d4e4fe6c1b39e226b220",
    1000: "b00d98db4b828b5d9bed822104d888bd60a6e5eb62da6d3f1615d358ad2a1d9a",
}
# End-of-run memory_reserved (after empty_cache) may exceed its reading
# after the first loop by at most this much.
KITTI_SOAK_MEMORY_MARGIN_MB = 512.0
# `--pipelined --async-mapping` is gated against collapse only.
KITTI_SOAK_PRODUCTION_TRACKED_FRAC = 0.9
SOAK_MAPPING_STAGES = ("map_point_culling", "create_new_map_points", "search_in_neighbors",
                       "local_ba", "_lidar_stage", "keyframe_culling")


def write_kitti_soak(n_frames: int) -> dict:
    """The soak's sequence under build/chip_smoke_soak: `eval/kitti_synth` at
    its defaults (seed 0, 0.8 m a frame, 1226x370) with the centred 64 x
    1800-ray scans, `n_frames` frames in processes on half the cores."""
    from sqrtlm_slam_tpu_torch.eval import kitti_soak, kitti_synth

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_soak")
    workers = max(2, (os.cpu_count() or 2) // 2)  # half the cores: the smoke shares them
    t0 = time.perf_counter()
    kitti_synth.generate(root, n_frames=n_frames, workers=workers, centred=True,
                         log=lambda *a: None)
    rec = dict(root=root, frames=n_frames, workers=workers,
               write_s=time.perf_counter() - t0, digest=kitti_soak.digest(root, "00", n_frames))
    rec["digest_equals_reference"] = (rec["digest"] == KITTI_SOAK_DIGEST[n_frames]
                                    if n_frames in KITTI_SOAK_DIGEST else None)
    emit("kitti_soak_setup", **rec)
    return rec


def kitti_soak_phase(n_frames: int = KITTI_SOAK_SMOKE_FRAMES, production: bool = False) -> dict:
    """20. The fusion soak, also callable alone: `python -m
    sqrtlm_slam_tpu_torch.run_kitti --mode fusion --loop` in process over
    the first `n_frames` frames of the `kitti_synth` sequence (written
    first, `write_kitti_soak`) at the runner's defaults: 1226x370, the
    KITTI 00-02 intrinsics, 2,000 ORB features, 64-ring scans,
    min_inliers_local 30, a 1,200 x 400,000 store, default
    LoopClosingConfig. Sync mode first, read by a `RunProbe`
    (`track_fusion`; also bracketed: the tracker's LiDAR map and the
    keyframe's LiDAR clouds, local mapping's LiDAR stage): every frame
    timed, the keyframe frames split by stage (tracking, keyframe
    insertion, the tracker's LiDAR map and the keyframe's LiDAR clouds,
    triangulation, fuse, local BA, the LiDAR stage, the loop closer) and
    every committed loop's frame by the loop corrector's calls (detection,
    Sim3, essential graph, fuse, GBA; the LiDAR pose-graph backend is not
    on this path in either package); each capture timed and placed; every
    100 frames a line with frames/s, keyframe frames' p50 / p95 by stage,
    LiDAR associations a frame, captures and replays per graphed function,
    memory_reserved as held and after empty_cache, and host RSS. Launch
    counters zeroed just before the run and read just after (K1, K2 and K3
    must launch). Gates: `kitti_soak.gates` against the JAX package's
    record (KITTI_SOAK_JAX): the counts and loops at the deepest frame
    both runs reached (`n_frames`, or the record's last depth below it; a
    depth short of the record's first raises before the run), the prefix
    ATEs at KITTI_SOAK_ATE_DEPTH, before either run's first loop; after
    the first loop no graphed
    function captures an input shape it had not captured before but the
    per-loop programs inside a correction, memory_reserved (after
    empty_cache) at the end within KITTI_SOAK_MEMORY_MARGIN_MB of the first
    loop's. With `production`, then `--pipelined --async-mapping` over the
    same frames, unbracketed, its memory read as the run holds it every 100
    frames: it must complete, track >= 0.9 of the sync run's frames, and
    end holding within KITTI_SOAK_MEMORY_MARGIN_MB of its first reading
    after a loop. Returns the sync run's launch counts."""
    import torch
    from sqrtlm_slam_tpu_torch import run_kitti, utils
    from sqrtlm_slam_tpu_torch.eval import kitti_soak
    from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
    from sqrtlm_slam_tpu_torch.loop import closing
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly
    from sqrtlm_slam_tpu_torch.pipeline.local_mapping import LocalMapper
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem
    from sqrtlm_slam_tpu_torch.pipeline.tracking import Tracker

    depths = [d for d in sorted(KITTI_SOAK_JAX) if d <= n_frames]
    if not depths:
        raise ValueError(f"fusion soak: {n_frames} frames end before the JAX record's first "
                         f"reading ({min(KITTI_SOAK_JAX)}): no gate could hold the run")
    depth = depths[-1]  # the gates' depth
    setup = write_kitti_soak(n_frames)
    root = setup["root"]
    gt = kitti_soak.read_gt(root)

    def runner_argv(name, extra):
        return ["--root", root, "--seq", "00", "--mode", "fusion", "--loop", "--frames",
                str(n_frames), "--out", os.path.join(root, f"traj_{name}.txt")] + extra

    probe = RunProbe(
        "kitti_soak", "track_fusion", SOAK_MAPPING_STAGES,
        more=((Tracker, "_gather_lidar_local_map", "tracker_lidar_map"),
              (Tracker, "_store_kf_lidar", "store_kf_lidar")),
        extra=lambda system: dict(lidar_matches=int(system.tracker.last_lidar_matches)))

    def exclusive(f) -> dict:
        """A keyframe frame's ms by stage, each without the stages inside it."""
        get = lambda n: f["stages"].get(n, 0.0)  # noqa: E731
        lba = get("local_ba") - get("_lidar_stage")
        return dict(
            frame_build=get("frame_build"),
            tracking=(f["ms"] - get("frame_build") - get("insert_keyframe")
                      - get("reclaim_landmarks")),
            insert_keyframe=(get("insert_keyframe") - get("process_keyframe")
                             - get("loop_closer") - get("store_kf_lidar")),
            store_kf_lidar=get("store_kf_lidar"), tracker_lidar_map=get("tracker_lidar_map"),
            map_point_culling=get("map_point_culling"),
            triangulation=get("create_new_map_points"), fuse=get("search_in_neighbors"),
            local_ba=lba, lidar_stage=get("_lidar_stage"),
            keyframe_culling=get("keyframe_culling"), loop_closer=get("loop_closer"),
            compute_sim3_calls=f["calls"].get("compute_sim3", 0))

    def split(part) -> dict:
        kf = [f for f in part if f["keyframe"] and not f["loop"]]
        by_stage = [exclusive(f) for f in kf]
        return dict(
            frames_per_s=len(part) / (1e-3 * sum(f["ms"] for f in part)) if part else None,
            keyframe_frames=percentiles([f["ms"] for f in kf]),
            other_frames=percentiles([f["ms"] for f in part if not f["keyframe"]]),
            keyframe_frame_stage_ms={
                n: dict(p50=float(np.percentile([e[n] for e in by_stage], 50)),
                        p95=float(np.percentile([e[n] for e in by_stage], 95)))
                for n in by_stage[0]} if by_stage else {},
            lidar_associations_per_frame=float(np.mean([f["lidar_matches"] for f in part]))
            if part else None)

    def every_100(line: str):
        """The recorder's progress line (every 100 frames) with the card's
        readings; its loop lines as they come."""
        if not line.startswith("PROGRESS"):
            emit("kitti_soak_event", line=line)
            return
        emit("kitti_soak_progress", line=line, **split(probe.frames[-100:]),
             replays=dict(sorted(probe.replay_counts.items())),
             **probe.memory(at="progress"))

    # -- sync mode, bracketed ------------------------------------------------
    LC = closing.LoopCloser
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = probe.memory(at="start")
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = 0
    with probe, kitti_soak.Recorder(SlamSystem, Tracker, LC, gt, ate_rmse, every=100,
                                    log=every_100) as rec:
        summary = run_kitti.main(runner_argv("sync", []))
    torch.cuda.synchronize()
    launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                "ba_chi2": assembly.chi2_launch_count}
    reads = utils.host_reads
    end = probe.memory(at="end")
    result = rec.result()
    frames = probe.frames
    loop_frames = [dict(f, lidar_backend_ms=0.0) for f in probe.loop_frames()]
    first_loop = loop_frames[0]["frame"] if loop_frames else None
    late, apart = probe.captures_after(first_loop)
    mem_first = probe.after_loop[0]["reserved_mb"] if probe.after_loop else None
    ref = KITTI_SOAK_JAX[depth]
    gated = kitti_soak.at_depth(result, depth)
    ates_at = (kitti_soak.at_depth(result, KITTI_SOAK_ATE_DEPTH),
               KITTI_SOAK_JAX[KITTI_SOAK_ATE_DEPTH])
    out = dict(
        frames=n_frames, runner=summary, outcome={k: v for k, v in result.items()
                                                  if k != "progress"},
        gate_depth=depth, at_gate_depth=gated, jax_at_gate_depth=ref,
        ate_depth=KITTI_SOAK_ATE_DEPTH, at_ate_depth=ates_at[0], jax_at_ate_depth=ates_at[1],
        margins=kitti_soak.GATES,
        launches=launches, host_reads_per_frame=reads / max(len(frames), 1),
        whole_run=split(frames), first_100=split(frames[:100]), last_100=split(frames[-100:]),
        loop_frames=loop_frames, corrections=probe.corrections, gba_runs=probe.gba_runs(),
        per_loop_programs=probe.per_loop_programs(), captures_by_function=end["captures"],
        replays_by_function=dict(sorted(probe.replay_counts.items())),
        capture_events=probe.capture_events(), new_shapes_after_first_loop=late,
        other_captures_after_first_loop=apart,
        memory=dict(start=at_start, after_each_loop=probe.after_loop, end=end,
                    reserved_end_minus_first_loop_mb=(end["reserved_mb"] - mem_first
                                                      if mem_first is not None else None)))
    emit("kitti_soak", mode="sync", **out,
         note="run_kitti --mode fusion --loop in process; frames: track_fusion between "
              "synchronizes (keyframe frames without a loop apart); stage ms exclusive; "
              "memory after torch.cuda.empty_cache; the gates read both runs at gate_depth")

    bad = kitti_soak.gates(gated, ref, loops_explained=ref.get("loops_explained", ""),
                           ates_at=ates_at)
    if result["frames"] != n_frames:
        bad.append(f"{result['frames']} of {n_frames} frames processed")
    if (launches["hamming"] <= 0 or launches["ba_assembly"] <= 0
            or (result["gba"]["runs"] and launches["ba_chi2"] <= 0)):
        bad.append(f"a kernel never launched: {launches}")
    if late:
        bad.append(f"new input shapes captured after the first loop: {late}")
    if mem_first is not None and not end["reserved_mb"] <= mem_first + KITTI_SOAK_MEMORY_MARGIN_MB:
        bad.append(f"memory_reserved {end['reserved_mb']} MB at the end against {mem_first} MB "
                   "after the first loop")

    # -- the production combination ----------------------------------------
    if production:
        held = []  # (frame, loops closed, reserved as held, MB) every 100 frames

        def production_line(line: str):
            torch.cuda.synchronize()
            mb = torch.cuda.memory_reserved() / 2**20
            if line.startswith("PROGRESS"):
                held.append((prod.progress[-1]["frame"], prod.progress[-1]["loops_closed"], mb))
            emit("kitti_soak_event", mode="production", line=line, rss_mb=rss_mb(),
                 reserved_as_held_mb=mb)

        with kitti_soak.Recorder(SlamSystem, Tracker, LC, gt, ate_rmse, every=100,
                                 log=production_line) as prod:
            p_summary = run_kitti.main(runner_argv("production",
                                                   ["--pipelined", "--async-mapping"]))
        p_result = prod.result()
        first_held = next((mb for _, loops, mb in held if loops >= 1), None)
        emit("kitti_soak", mode="pipelined_async", frames=n_frames, runner=p_summary,
             outcome={k: v for k, v in p_result.items() if k != "progress"},
             reserved_as_held_mb_by_100=held, memory_end=probe.memory(at="end"),
             note="memory as the run held it (no empty_cache until its end)",
             tracked_against_sync=p_result["tracked"] / max(result["tracked"], 1))
        if p_result["frames"] != n_frames:
            bad.append(f"production: {p_result['frames']} of {n_frames} frames processed")
        if p_result["tracked"] < KITTI_SOAK_PRODUCTION_TRACKED_FRAC * result["tracked"]:
            bad.append(f"production: tracked {p_result['tracked']} < "
                       f"{KITTI_SOAK_PRODUCTION_TRACKED_FRAC} x sync's {result['tracked']}")
        if first_held is not None and not held[-1][2] <= first_held + KITTI_SOAK_MEMORY_MARGIN_MB:
            bad.append(f"production: memory_reserved as held {held[-1][2]} MB at the end "
                       f"against {first_held} MB at the first reading after a loop")
    if bad:
        raise AssertionError("fusion soak: " + "; ".join(bad))
    return launches


# 21. The LiDAR soak: the `lidar_slam` node's operating point. The JAX
# package's record of the same scans is `eval/lidar_soak.py`'s JAX_RECORD
# (its runs on the CPU through `scripts/lidar_soak_reference.py --package
# jax`; PERF.md section 5) with the margins of `lidar_soak.GATES`. The scans
# are `kitti_synth`'s at its defaults, scans only (`scans_only=True`); the
# sha256 of the first N (`lidar_soak.scan_digest`) as this phase's writer
# and the one of a whole 1,000-frame write (images too) give them: a
# scan's bytes do not depend on the sequence's length, so the whole smoke
# links phase 20's 600 scans and writes the rest.
LIDAR_SOAK_DIGEST = {
    1000: "f2ea99b9c7096422cbb9fc2bb6e9b387853268a7ba00dcffd58b01c6fdf21156",
    600: "649c6e50e7b9a8cdcc80aa5b03a4485ade7f25fec1aef044efdd7ed8137039b4",
}
LIDAR_SOAK_SCANS = 1000
LIDAR_SOAK_MEMORY_MARGIN_MB = 256.0
LIDAR_SOAK_STAGES = ("extraction", "alignment", "keyframe_test", "keyframe_insertion")
LIDAR_SOAK_FUNCTIONS = ("lidar.features.extract_features_jit", "lidar.odometry.align_scan",
                        "lidar.odometry._retract_jit", "lidar.odometry._local_delta_jit",
                        "lidar.backend._gn_step_jit")


def write_lidar_soak(n_scans: int, reuse: str | None = None) -> dict:
    """The LiDAR soak's scans under build/chip_smoke_lidar: `eval/kitti_synth`
    at its defaults with the centred 64 x 1800-ray scans, scans only, in
    processes on half the cores. `reuse`: a root of the same sequence
    (phase 20's) whose scans are linked in, the rest written."""
    import shutil

    from sqrtlm_slam_tpu_torch.eval import kitti_synth, lidar_soak

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_lidar")
    shutil.rmtree(root, ignore_errors=True)
    velo = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(velo)
    first = 0
    if reuse and os.path.exists(os.path.join(reuse, "poses", "00.txt")):  # written last
        src = os.path.join(reuse, "sequences", "00", "velodyne")
        first = min(len(os.listdir(src)), n_scans)
        for i in range(first):
            os.link(os.path.join(src, f"{i:06d}.bin"), os.path.join(velo, f"{i:06d}.bin"))
    workers = max(2, (os.cpu_count() or 2) // 2)
    t0 = time.perf_counter()
    kitti_synth.generate(root, n_frames=n_scans, workers=workers, centred=True,
                         scans_only=True, first_frame=first, log=lambda *a: None)
    rec = dict(root=root, scans=n_scans, linked=first, workers=workers,
               write_s=time.perf_counter() - t0, digest=lidar_soak.scan_digest(root, n_scans))
    rec["digest_equals_reference"] = (rec["digest"] == LIDAR_SOAK_DIGEST[n_scans]
                                      if n_scans in LIDAR_SOAK_DIGEST else None)
    emit("lidar_soak_setup", **rec)
    if rec["digest_equals_reference"] is False:
        raise AssertionError(f"LiDAR soak: the scans differ from the reference's: {rec}")
    return rec


def lidar_soak_phase(reuse: str | None = None) -> dict:
    """21. The LiDAR soak on the card over `kitti_synth`'s 1,000 scans, also
    callable alone (`reuse` None: every scan written here). Each run read by
    `eval/lidar_soak.py`'s `Recorder` (every scan's `process` between
    synchronizes) and a `GraphProbe` (feature extraction, alignment, the
    keyframe test and keyframe insertion each bracketed by synchronizes;
    replays counted):
      (a) `run_kitti --mode lidar` in process over every scan at the
          runner's defaults (`OdomConfig()`, the sequence's `LidarConfig`,
          `pad_cloud`'s 16,384-row buckets);
      (c) on (a)'s chain, `backend_for_loop` and `backend_for_gnss` as
          `scripts/lidar_soak_reference.py` calls them, each graphed cold
          (with the capture), again (replays) and eager
          (`disable_graphs`): ms, the memory the capture keeps, the
          three chains bitwise equal; then on the JAX package's own chain
          (`lidar_soak_jax.npz`): the distance to its result and to the
          float64 answer (`scripts/lidar_backend_f64.py`);
      (b) `mode="mapping"` over the first lap, then `set_prior_map` of its
          keyframes' clouds and localization over every scan from scan 0.
    Every 100 scans a line: scans/s, ms a scan p50 / p95 and by stage,
    associations a scan, the window's occupied voxels against the
    capacity, captures and replays of the graphed functions, host reads a
    scan, memory_reserved as held (no `empty_cache`), RSS. Gates against the
    JAX package's record (`lidar_soak.gates`): (a), the mapping run
    (`lidar_soak.MAPPING_GATES`) and the localization run; the prior map's
    kept voxels; (c) the end drift cut at least as far as the JAX run cuts
    it and, on the JAX chain, its result within `lidar_soak.BACKEND_TOL_M`;
    no capture after scan 100 of (a) but at a scan of a new `pad_cloud`
    bucket; memory_reserved as held at the end of (a) within
    LIDAR_SOAK_MEMORY_MARGIN_MB of its reading at scan 100. Launch
    counters zeroed just before and read just after: this path launches
    none of K1-K3 (returned). On the CPU the same runs are
    `tests/test_torch_lidar_soak.py`'s."""
    import torch
    from sqrtlm_slam_tpu_torch import run_kitti, utils
    from sqrtlm_slam_tpu_torch.eval import lidar_soak
    from sqrtlm_slam_tpu_torch.geometry import se3
    from sqrtlm_slam_tpu_torch.lidar import features, odometry
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly
    from sqrtlm_slam_tpu_torch.utils import cache
    from sqrtlm_slam_tpu_torch.utils.config import kitti_sequence_config

    n_scans = LIDAR_SOAK_SCANS
    jax_rec = lidar_soak.JAX_RECORD
    setup = write_lidar_soak(n_scans, reuse)
    root = setup["root"]
    gt_l = lidar_soak.lidar_gt(root)
    mapping_scans = lidar_soak.first_lap(gt_l)
    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize()

    def held_mb() -> float:
        return torch.cuda.memory_reserved() / 2**20

    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else x

    graphs = {n: g for n, g in cache.graphed_functions().items() if n in LIDAR_SOAK_FUNCTIONS}
    rows = [os.path.getsize(os.path.join(root, "sequences", "00", "velodyne", f"{i:06d}.bin"))
            // 16 for i in range(n_scans)]
    buckets = [max(16384, -(-n // 16384) * 16384) for n in rows]
    probe = GraphProbe(brackets=(
        (features, "extract_features_jit", "extraction"),
        (odometry, "align_scan", "alignment"),
        (odometry.LidarOdometry, "_is_keyframe", "keyframe_test"),
        (odometry.LidarOdometry, "_insert_keyframe", "keyframe_insertion")))
    scans = {}  # run -> per scan: ms, stages, keyframe, captures, reads, bucket
    held = {}  # run -> [(scan, memory_reserved as held, MB)] every 100 scans

    def recorder(run: str, **kw):
        per_scan = scans.setdefault(run, [])
        marks = dict(captures=utils.graph_captures, reads=utils.host_reads)
        rec = None

        def on_scan(k):
            per_scan.append(dict(ms=rec.ms[-1], keyframe=rec.keyframe[-1],
                                 stages=dict(probe.stages),
                                 captures=utils.graph_captures - marks["captures"],
                                 reads=utils.host_reads - marks["reads"],
                                 bucket=buckets[k] if k < len(buckets) else None))
            marks.update(captures=utils.graph_captures, reads=utils.host_reads)
            probe.stages.clear()
            probe.counts.clear()
            probe.frame = k + 1

        def every_100(line: str):
            part = per_scan[-100:]
            mb = held_mb()
            held.setdefault(run, []).append((len(per_scan), mb))
            emit("lidar_soak_progress", run=run, line=line, **split(part, rec.matches[-100:]),
                 voxels_last=rec.voxels[-1] if rec.voxels else None,
                 capacity=odometry.OdomConfig().map_capacity,
                 captures={n: g.captures for n, g in graphs.items()},
                 replays=dict(sorted(probe.replay_counts.items())),
                 reserved_as_held_mb=mb, rss_mb=rss_mb())

        probe.frame = 0
        rec = lidar_soak.Recorder(odometry.LidarOdometry, odometry, gt_l, host, every=100,
                                  log=every_100, sync=sync, on_scan=on_scan, **kw)
        return rec

    def split(part, matches) -> dict:
        if not part:
            return {}
        by_stage = {}
        for name in LIDAR_SOAK_STAGES:
            ms = [s["stages"][name] for s in part if name in s["stages"]]
            by_stage[name] = (dict(n=len(ms), p50=float(np.percentile(ms, 50)),
                                   p95=float(np.percentile(ms, 95))) if ms else None)
        m = [x for x in matches if x is not None]
        return dict(scans_per_s=len(part) / (1e-3 * sum(s["ms"] for s in part)),
                    scan_ms=percentiles([s["ms"] for s in part]),
                    keyframe_scan_ms=percentiles([s["ms"] for s in part if s["keyframe"]]),
                    stage_ms=by_stage,
                    associations_per_scan=float(np.mean(m)) if m else None,
                    host_reads_per_scan=sum(s["reads"] for s in part) / len(part))

    def outcome(res: dict) -> dict:
        return {k: v for k, v in res.items() if k not in ("progress", "matches", "ms")}

    bad = []
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    t_phase = time.perf_counter()
    with probe:
        # -- (a) slam, through the runner --------------------------------------
        utils.host_reads = utils.graph_captures = 0
        with recorder("slam", record_chain=True) as rec_a:
            summary = run_kitti.main(["--root", root, "--seq", "00", "--mode", "lidar",
                                      "--frames", str(n_scans), "--device", "cuda",
                                      "--out", os.path.join(root, "traj_lidar.txt")])
        sync()
        held_end = held_mb()
        res_a = rec_a.result()
        per_a = scans["slam"]
        held_100 = held["slam"][0][1]
        seen, late = set(), []
        for k, s in enumerate(per_a):
            if k >= 100 and s["captures"] and s["bucket"] in seen:
                late.append((k, s["captures"], s["bucket"]))
            seen.add(s["bucket"])
        ref_a = lidar_soak.at_depth(jax_rec["slam"], n_scans)
        gate_a = lidar_soak.gates(res_a, ref_a)
        emit("lidar_soak", run="slam", scans=n_scans, runner=summary, outcome=outcome(res_a),
             jax=ref_a, margins=lidar_soak.GATES, failures=gate_a,
             whole_run=split(per_a, res_a["matches"]),
             first_100=split(per_a[:100], res_a["matches"][:100]),
             last_100=split(per_a[-100:], res_a["matches"][-100:]),
             buckets=sorted(set(buckets)), captures_after_scan_100=late,
             captures={n: g.captures for n, g in graphs.items()},
             replays=dict(sorted(probe.replay_counts.items())),
             host_reads_per_scan=sum(s["reads"] for s in per_a) / len(per_a),
             reserved_as_held_mb=dict(by_100=held["slam"], end=held_end),
             note="run_kitti --mode lidar in process; ms: process() between synchronizes; "
                  "stages bracketed by synchronizes; memory as held (no empty_cache)")
        bad += [f"(a) {f}" for f in gate_a]
        if late:
            bad.append(f"(a) captures after scan 100 at a known bucket: {late}")
        if not held_end <= held_100 + LIDAR_SOAK_MEMORY_MARGIN_MB:
            bad.append(f"(a) memory_reserved as held {held_end} MB at the end against "
                       f"{held_100} MB at scan 100")

        # -- (c) the backends on (a)'s chain ------------------------------------
        odo = rec_a.odo
        recorded = list(odo._chain)
        last = len(recorded) - 1
        before = lidar_soak.chain_matrices(recorded, host)
        drift_before = lidar_soak.end_drift(before, gt_l)
        j = lidar_soak.loop_pair(gt_l, last)
        T = lidar_soak.relative(gt_l, j, last)

        def on_device(M):
            return se3.SE3(torch.as_tensor(M[:3, :3], dtype=torch.float32, device=dev),
                           torch.as_tensor(M[:3, 3], dtype=torch.float32, device=dev))

        T_ji = on_device(T)
        anchors = lidar_soak.gnss_anchors(gt_l, len(recorded))
        jax_c = jax_rec["backends"]
        backends = {}
        for name, call in (("loop", lambda: odo.backend_for_loop(j, last, T_ji)),
                           ("gnss", lambda: odo.backend_for_gnss(anchors))):
            odo._chain = list(recorded)
            mem0 = kept_bytes()
            chain_g, cold = run_counted(call)
            kept_mb = (kept_bytes() - mem0) / 2**20
            odo._chain = list(recorded)
            chain_r, again = run_counted(call)
            odo._chain = list(recorded)
            with cache.disable_graphs():
                chain_e, eager = run_counted(call)
            equal = all(same_bits((a.R, a.t), (b.R, b.t)) and same_bits((a.R, a.t), (c.R, c.t))
                        for a, b, c in zip(chain_g, chain_r, chain_e))
            after = lidar_soak.end_drift(lidar_soak.chain_matrices(chain_g, host), gt_l)
            jax_cut = jax_c[name]["end_drift_after_m"] / jax_c["end_drift_before_m"]
            backends[name] = dict(
                end_drift_before_m=drift_before, end_drift_after_m=after,
                cut=after / drift_before, jax_cut=jax_cut,
                cold_ms=1e3 * cold["s"], replayed_ms=1e3 * again["s"],
                eager_ms=1e3 * eager["s"], cold=cold, replayed=again, eager=eager,
                capture_kept_mb=kept_mb, bitwise_equal=equal)
            if not equal:
                bad.append(f"(c) {name}: the graphed, replayed and eager chains differ")
            tol = lidar_soak.CUT_TOL[name]
            if not after / drift_before <= jax_cut + tol:
                bad.append(f"(c) {name}: end drift {drift_before} -> {after} m, a cut of "
                           f"{after / drift_before:.4f} against the JAX run's {jax_cut:.4f}")
        odo._chain = recorded
        # The JAX package's own chain through the card's backend, against its
        # result and against the float64 answer of the same system.
        on_jax = {}
        data = np.load(os.path.join(os.path.dirname(lidar_soak.__file__), "lidar_soak_jax.npz"))
        chain_j = [on_device(M) for M in data["slam"]]
        for name, call in (
                ("loop", lambda: odo.backend_for_loop(jax_c["loop"]["i"], last, T_ji)),
                ("gnss", lambda: odo.backend_for_gnss(anchors))):
            odo._chain = list(chain_j)
            got = lidar_soak.chain_positions(lidar_soak.chain_matrices(call(), host))

            def dist(key):
                return float(np.abs(got - lidar_soak.chain_positions(data[key])).max())

            diff = dist(f"backend_{name}")
            on_jax[name] = dict(max_position_diff_m=diff,
                                tol_m=lidar_soak.BACKEND_TOL_M[name],
                                from_f64_m=dist(f"backend_{name}_f64"))
            if not diff <= lidar_soak.BACKEND_TOL_M[name]:
                bad.append(f"(c) {name} on the JAX chain: {diff} m from the JAX result")
        odo._chain = recorded
        emit("lidar_soak", run="backends", chain_length=len(recorded), loop_pair=[j, last],
             anchors=[k for k, _ in anchors], anchors_used=lidar_soak.A_CAP, **backends,
             on_the_jax_chain=on_jax, jax=jax_c,
             note="cold: the first call (captures); replayed: again; eager: disable_graphs; "
                  "capture_kept_mb: memory_reserved after empty_cache, before and after cold")
        del odo, rec_a, recorded

        # -- (b) mapping over the first lap, then localization -------------------
        feat_cfg = kitti_sequence_config("00").lidar
        odo_m = odometry.LidarOdometry(feat_cfg=feat_cfg, device=dev)
        odo_m.mode = "mapping"
        with recorder("mapping") as rec_m:
            for i in range(mapping_scans):
                odo_m.process(lidar_soak.scan(root, i))
        res_m = rec_m.result()
        prior = lidar_soak.prior_map(odo_m, host)
        del odo_m
        loc = odometry.LidarOdometry(feat_cfg=feat_cfg, device=dev)
        sync()
        t0 = time.perf_counter()
        loc.set_prior_map(**prior)
        sync()
        prior_ms = 1e3 * (time.perf_counter() - t0)
        voxels = lidar_soak.prior_map_voxels(prior, loc._local_map, loc.cfg, host)
        with recorder("localization") as rec_l:
            for i in range(n_scans):
                loc.process(lidar_soak.scan(root, i))
        res_l = rec_l.result()
        jax_m, jax_l = jax_rec["mapping"], jax_rec["localization"]
        ref_m = lidar_soak.at_depth(jax_m, mapping_scans)
        gate_m = lidar_soak.gates(res_m, ref_m, lidar_soak.MAPPING_GATES)
        for cls in ("corner", "flat"):
            got, want = voxels[f"{cls}_kept"], jax_l["prior_map"][f"{cls}_kept"]
            if abs(got - want) > lidar_soak.KEPT_VOXELS_TOL[cls]:
                gate_m.append(f"prior map's kept {cls} voxels {got} against the JAX "
                              f"run's {want}")
        ref_l = lidar_soak.at_depth(jax_l, n_scans)
        gate_l = lidar_soak.gates(res_l, ref_l)
        emit("lidar_soak", run="mapping", scans=mapping_scans, outcome=outcome(res_m),
             jax=ref_m, margins=lidar_soak.MAPPING_GATES, failures=gate_m,
             whole_run=split(scans["mapping"], res_m["matches"]),
             last_100=split(scans["mapping"][-100:], res_m["matches"][-100:]),
             reserved_as_held_mb=held.get("mapping"))
        emit("lidar_soak", run="localization", scans=n_scans, outcome=outcome(res_l),
             prior_map=voxels, set_prior_map_ms=prior_ms, jax=ref_l,
             jax_prior_map=jax_l["prior_map"], failures=gate_l,
             whole_run=split(scans["localization"], res_l["matches"]),
             reserved_as_held_mb=held.get("localization"))
        bad += [f"(b) mapping: {f}" for f in gate_m] + [f"(b) localization: {f}" for f in gate_l]
    sync()
    launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                "ba_chi2": assembly.chi2_launch_count}
    emit("lidar_soak_done", seconds=time.perf_counter() - t_phase, launches=launches,
         failures=bad)
    if bad:
        raise AssertionError("LiDAR soak: " + "; ".join(bad))
    return launches


KITTI00_SUPERSEDED_MARGIN_MB = 64.0
KITTI00_STORE_FIELDS = ("kf_R", "kf_t", "lm_pos", "lm_obs_kf")


def kitti00_scale_store():
    """`eval/scale_kitti00.py`'s store at KITTI 00's 1,400 keyframes and
    280,000 landmarks: (store, true_R, true_t)."""
    from sqrtlm_slam_tpu_torch.eval import scale_kitti00
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store

    flow = scale_kitti00.FLOW
    return make_scale_store(n_kf=flow["kfs"], n_lm=flow["lms"], obs_per_lm=flow["obs_per_lm"],
                            drift=flow["drift"])


def kitti00_scale_phase(keep: Optional[dict] = None) -> dict:
    """22. The loop correction at KITTI 00's scale (`kitti00_scale_phase`,
    also callable alone): `benchmarks/bench_scale.py`'s flow at 1,400
    keyframes x 280,000 landmarks (`eval/scale_kitti00.py`'s FLOW: 5
    observations a landmark in 7 slots, drift 4e-4, the true loop edge
    through the essential graph, `edge_cap` 16384, 30 Gauss-Newton steps,
    then `LoopCloser.run_global_ba`, 10 LM iterations in one chunk) through
    the port's entry points on the card.
      (a) the essential graph and the GBA each graphed (the first call
          captures), graphed again (replays only) and eager
          (`disable_graphs`), the GBAs on copies of the store: seconds to a
          synchronize, captures, replays, host reads, the memory the call
          leaves kept (`memory_reserved` after `empty_cache`, before and
          after: the first call's captures), `max_memory_allocated`, K2's
          and K3's launches, the PCG iterations of each LM iteration; the
          three bitwise equal; then the essential graph in float64 (its own
          capture);
      (b) a superseded GBA on another copy, as the loop closer's production
          mode runs it (`gba_chunk` 5, the generation bumped from the
          `_gba_tick` hook after the first chunk): it returns False, counts
          one abort, leaves `kf_R`, `kf_t` and `lm_pos` bitwise as they
          were and the memory kept within KITTI00_SUPERSEDED_MARGIN_MB of
          its reading before; then one GBA of the flow on that copy gives
          (a)'s bits.
    Gates against the JAX package's CPU record (`scale_kitti00.gates`:
    sizes, the drift ATE to 1e-6 m, the float64 essential graph's ATE
    within `F64_TOL_M` of the JAX package's float64 answer, the float32 ATE
    after the essential graph and after GBA and chi2 after GBA within
    `scale_kitti00.tolerances` (the spread of both packages' float32
    runs), chi2 falls, the GBA completes); K2 and K3 launched. Launch
    counters zeroed just before (a)'s graphed GBA and read just after
    (returned). With `keep` (a dict), it is given what phase 23 starts
    from: `corrected`, a copy of the store after the essential graph,
    `true_R`, `true_t`, `ate_after_loop_m` and `gba` (the ATE and chi2
    after (a)'s GBA)."""
    import gc

    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import scale_kitti00
    from sqrtlm_slam_tpu_torch.eval.scale import store_ate
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig, essential_graph
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
    from sqrtlm_slam_tpu_torch.utils import cache

    flow = scale_kitti00.FLOW
    record = scale_kitti00.load_record()
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    store, true_R, true_t = kitti00_scale_store()
    build_store_s = time.perf_counter() - t0
    ate_drift = store_ate(store, true_R, true_t)
    cfg = LoopClosingConfig(edge_cap=flow["edge_cap"], gba_iters=flow["gba_iters"],
                            gba_chunk=flow["gba_chunk"])
    lc = LoopCloser(store, DEFAULT_CAM, cfg=cfg, device=dev)
    t0 = time.perf_counter()
    pg = scale_kitti00.pose_graph_of_loop(
        lc, true_R, true_t,
        lambda R, t: sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R), torch.as_tensor(t)))
    eg_build_s = time.perf_counter() - t0
    pcg_counts = []  # (LM iteration's PCG count) device tensors of the running call
    pcg_run = schur_bucketed._pcg_run

    def counted_pcg_run(*a, **k):
        s = pcg_run(*a, **k)
        pcg_counts.append(s.n)
        return s

    def held() -> tuple:
        """(memory_reserved after `empty_cache`, memory_allocated), garbage
        collected first."""
        gc.collect()
        return kept_bytes(), torch.cuda.memory_allocated()

    def measured(fn, eager: bool = False):
        """(fn(), its counts): `run_counted`'s, the memory kept after it
        against before (MB; reserved after `empty_cache`, and allocated),
        the peak allocated, the PCG iterations of each LM iteration and K2's
        and K3's launches."""
        pcg_counts.clear()
        mem0, alloc0 = held()
        torch.cuda.reset_peak_memory_stats()
        c2, c3 = assembly.launch_count, assembly.chi2_launch_count
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            out, rec = run_counted(fn)
        mem1, alloc1 = held()
        rec.update(ba_assembly=assembly.launch_count - c2,
                   ba_chi2=assembly.chi2_launch_count - c3,
                   max_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
                   kept_mb=(mem1 - mem0) / 2**20, allocated_mb=(alloc1 - alloc0) / 2**20,
                   cg_n=torch.stack(pcg_counts).tolist() if pcg_counts else [])
        return out, rec

    schur_bucketed._pcg_run = counted_pcg_run
    try:
        # (a) The essential graph, three ways.
        def eg():
            return essential_graph.optimize_pose_graph(pg, num_iters=flow["eg_iters"])

        eg_runs = {}
        (eg_out, eg_chi2), eg_runs["graphed"] = measured(eg)
        eg_again, eg_runs["graphed_again"] = measured(eg)
        eg_eager, eg_runs["eager"] = measured(eg, eager=True)

        def eg_bits(out):
            return (out[0].s, out[0].R, out[0].t, out[1])

        eg_equal = (same_bits(eg_bits((eg_out, eg_chi2)), eg_bits(eg_again))
                    and same_bits(eg_bits(eg_again), eg_bits(eg_eager)))
        del eg_again, eg_eager
        # The same graph in float64 (its own capture): held against the JAX
        # package's float64 answer, where float32 runs of either package
        # part by millimetres (`scale_kitti00.tolerances`).
        pg64 = pg._replace(**{f: getattr(pg, f).double() for f in pg._fields
                              if getattr(pg, f).is_floating_point()})
        (eg64, _), eg_runs["float64"] = measured(
            lambda: essential_graph.optimize_pose_graph(pg64, num_iters=flow["eg_iters"]))
        ate_eg64 = scale_kitti00.poses_ate(*utils.to_host(eg64.s, eg64.R, eg64.t), true_R,
                                           true_t)
        del pg64, eg64
        lc._apply_pose_graph(eg_out, store.num_kf)
        ate_eg = store_ate(store, true_R, true_t)
        p0, _ = gather_global_problem_bucketed(store, dev)
        chi2_before = float(schur_bucketed.chi2_only(p0, DEFAULT_CAM, p0.obs_valid, None))
        n_edges = int(p0.obs_valid.sum())
        del p0
        copies = {k: copy.deepcopy(store) for k in ("again", "eager", "superseded")}
        if keep is not None:
            keep.update(corrected=copy.deepcopy(store), true_R=true_R, true_t=true_t,
                        ate_after_loop_m=ate_eg)

        # (a) The GBA, three ways, each on its own copy of the corrected store.
        gba_runs = {}
        hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
        gba_ok, gba_runs["graphed"] = measured(lc.run_global_ba)
        launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                    "ba_chi2": assembly.chi2_launch_count}
        ate_gba = store_ate(store, true_R, true_t)
        p1, _ = gather_global_problem_bucketed(store, dev)
        chi2_after = float(schur_bucketed.chi2_only(p1, DEFAULT_CAM, p1.obs_valid, None))
        del p1
        if keep is not None:
            keep["gba"] = dict(ate_m=ate_gba, chi2_plain=chi2_after)
        again_ok, gba_runs["graphed_again"] = measured(
            LoopCloser(copies["again"], DEFAULT_CAM, cfg=cfg, device=dev).run_global_ba)
        eager_ok, gba_runs["eager"] = measured(
            LoopCloser(copies["eager"], DEFAULT_CAM, cfg=cfg, device=dev).run_global_ba,
            eager=True)

        def same_store(a, b, fields=KITTI00_STORE_FIELDS) -> bool:
            return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)

        gba_equal = {k: same_store(store, copies[k]) for k in ("again", "eager")}

        # (b) A superseded GBA, then the flow's GBA on the same copy.
        sup = copies["superseded"]
        before = {f: getattr(sup, f).copy() for f in ("kf_R", "kf_t", "lm_pos")}
        lc_b = LoopCloser(sup, DEFAULT_CAM, device=dev, cfg=LoopClosingConfig(
            edge_cap=flow["edge_cap"], gba_iters=flow["gba_iters"], gba_chunk=5))

        def supersede():  # a new loop arrives after the first chunk
            lc_b.gba_generation += 1
            lc_b._gba_tick = lambda: None

        lc_b._gba_tick = supersede
        mem_before = held()[0]
        sup_ok, sup_run = measured(lc_b.run_global_ba)
        mem_after = held()[0]
        sup_unchanged = all(np.array_equal(getattr(sup, f), v) for f, v in before.items())
        final_ok, final_run = measured(
            LoopCloser(sup, DEFAULT_CAM, cfg=cfg, device=dev).run_global_ba)
        final_equal = same_store(store, sup)
    finally:
        schur_bucketed._pcg_run = pcg_run
    run = dict(kfs=store.num_kf, landmarks=store.num_lm, edges=n_edges,
               essential_graph_edges=int(pg.e_valid.sum()), ate_drift_m=ate_drift,
               ate_after_loop_m=ate_eg, ate_after_loop_f64_m=ate_eg64, ate_after_gba_m=ate_gba,
               chi2_before=chi2_before, chi2_after=chi2_after, gba_completed=bool(gba_ok))
    bad = scale_kitti00.gates(run, record)
    superseded = dict(returned=sup_ok, num_gba_aborted=lc_b.num_gba_aborted,
                      store_unchanged=sup_unchanged, kept_mb_before=mem_before / 2**20,
                      kept_mb_after=mem_after / 2**20, run=sup_run,
                      then_flow_gba=dict(completed=final_ok, bitwise_equal_to_a=final_equal,
                                         run=final_run))
    emit("kitti00_scale", **run, gba_iters=flow["gba_iters"], eg_iters=flow["eg_iters"],
         store_build_s=build_store_s, essential_graph_build_s=eg_build_s,
         essential_graph_chi2=float(eg_chi2), launches=launches,
         essential_graph=dict(eg_runs, bitwise_equal=eg_equal),
         gba=dict(gba_runs, bitwise_equal=gba_equal), superseded=superseded,
         jax_record={k: record[k] for k in run if k in record},
         jax_float64=scale_kitti00.float64_answer(record),
         tolerances=dict(scale_kitti00.tolerances(record), f64_m=scale_kitti00.F64_TOL_M),
         failures=bad, seconds=time.perf_counter() - t_phase,
         note="graphed: the first call (it captures), graphed_again: the same call "
              "replaying only, eager: under disable_graphs; s to a synchronize; kept_mb: "
              "memory_reserved after empty_cache, after the call against before; cg_n: the "
              "PCG iterations of each LM iteration (GBA) in order; the GBAs of graphed_again "
              "and eager ran on copies of the store the essential graph corrected")
    if not (again_ok and eager_ok):
        bad.append(f"a GBA of (a) did not complete: again {again_ok}, eager {eager_ok}")
    if not eg_equal:
        bad.append("(a) the essential graph graphed, replayed and eager differ")
    if not all(gba_equal.values()):
        bad.append(f"(a) the GBAs differ from the graphed one: {gba_equal}")
    if not (eg_runs["graphed"]["graph_captures"] >= 1 and gba_runs["graphed"]["graph_captures"] >= 1
            and eg_runs["graphed_again"]["graph_captures"] == 0
            and gba_runs["graphed_again"]["graph_captures"] == 0):
        bad.append(f"(a) captures: essential graph {eg_runs}, GBA {gba_runs}")
    if min(launches["ba_assembly"], launches["ba_chi2"]) <= 0:
        bad.append(f"a kernel of global BA never launched: {launches}")
    if sup_ok is not False or lc_b.num_gba_aborted != 1 or not sup_unchanged:
        bad.append(f"(b) the superseded GBA: {superseded}")
    if not abs(mem_after - mem_before) <= KITTI00_SUPERSEDED_MARGIN_MB * 2**20:
        bad.append(f"(b) memory kept {mem_before / 2**20} -> {mem_after / 2**20} MB")
    if not (final_ok and final_equal):
        bad.append(f"(b) the flow's GBA after the superseded one: {final_ok}, "
                   f"bitwise equal to (a) {final_equal}")
    if bad:
        raise AssertionError("KITTI 00 loop correction: " + "; ".join(bad))
    return launches


def kitti00_dense_pieces(problem, red, mu):
    """(S_half, rhs_corr) of one shard by the JAX package's formula
    (`sqrtlm_slam_tpu/optim/schur_bucketed.py::_pieces_tail`, float32 as on
    its CPU): V scattered into a one-hot (P, L, 6, 3) Y, S = blockdiag(Hpp_d)
    - Y Y^T, rhs_corr = Y (Hll_d^{-1} bl) through the one-hot. Phase 23 (b)'s
    yardstick for the port's slot-pair sums; not on any path of the port."""
    import torch
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed as sb

    Hll, bl, U, Hpp, bp, chi2 = red
    P, L = problem.num_poses, problem.num_points
    dev = bl.device
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_d = torch.where(problem.point_valid[:, None, None],
                        Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3, eye3)
    Minv = sb.trinv_lower3x3(sb.chol3x3(Hll_d))
    V = torch.einsum("lkim,ljm->lkij", U, Minv)
    O = (problem.obs_cam.long()[..., None] == torch.arange(P, device=dev)).to(bl.dtype)
    Y2 = torch.einsum("lkp,lkim->plim", O, V).permute(0, 2, 1, 3).reshape(P * 6, L * 3)
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6
    S = -(Y2 @ Y2.T)
    del Y2
    S = S + torch.einsum("pij,pq->piqj", Hpp_d, torch.eye(P, device=dev)).reshape(P * 6, P * 6)
    y2 = torch.einsum("lmi,lm->li", Minv, torch.einsum("lij,lj->li", Minv, bl))
    Vz = torch.einsum("lkim,lm->lki", U, y2)
    return S, torch.einsum("lkp,lki->pi", O, Vz).reshape(-1)


def kitti00_corrected_store() -> dict:
    """Phase 23's start when it runs alone: phase 22's store corrected by
    the flow's essential graph, and the ATE and chi2 of the flow's GBA (a
    `LoopCloser.run_global_ba` on a copy): the keys `kitti00_scale_phase`
    gives its `keep`."""
    import torch
    from sqrtlm_slam_tpu_torch.eval import scale_kitti00
    from sqrtlm_slam_tpu_torch.eval.scale import store_ate
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig, essential_graph
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed

    flow = scale_kitti00.FLOW
    dev = torch.device("cuda")
    store, true_R, true_t = kitti00_scale_store()
    cfg = LoopClosingConfig(edge_cap=flow["edge_cap"], gba_iters=flow["gba_iters"],
                            gba_chunk=flow["gba_chunk"])
    lc = LoopCloser(store, DEFAULT_CAM, cfg=cfg, device=dev)
    pg = scale_kitti00.pose_graph_of_loop(
        lc, true_R, true_t,
        lambda R, t: sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R), torch.as_tensor(t)))
    out, _ = essential_graph.optimize_pose_graph(pg, num_iters=flow["eg_iters"])
    lc._apply_pose_graph(out, store.num_kf)
    keep = dict(corrected=copy.deepcopy(store), true_R=true_R, true_t=true_t,
                ate_after_loop_m=store_ate(store, true_R, true_t))
    if not lc.run_global_ba():
        raise AssertionError("KITTI 00 distributed BA: the flow's GBA did not complete")
    p, _ = gather_global_problem_bucketed(store, dev)
    keep["gba"] = dict(ate_m=store_ate(store, true_R, true_t), chi2_plain=float(
        schur_bucketed.chi2_only(p, DEFAULT_CAM, p.obs_valid, None)))
    return keep


def kitti00_dist_phase(keep: Optional[dict] = None, write_record: Optional[str] = None) -> dict:
    """23. Distributed BA and the flat engine's global BA at KITTI 00's
    scale (`kitti00_dist_phase`, also callable alone): the problem is
    `gather_global_problem_bucketed` of phase 22's store after the essential
    graph (1,400 keyframes, 280,000 landmarks, 1.4 M observations in 7
    slots; alone it builds and corrects that store, `kitti00_corrected_
    store`), the robust delta and the 10 LM iterations of the flow's GBA.
      (a) `dist_ba.make_bucketed_lm_iterate` (the JAX package's production
          distributed BA) at 4, 2 and 1 shards on the card, in that order,
          the memory read before anything else of each: graphed (the first
          call captures the whole LM loop), replayed and eager
          (`disable_graphs`), bitwise equal; s to a synchronize, captures,
          replays, host reads, K2's and K3's launches, the peak allocated,
          the memory the capture keeps (before against after) and what is
          kept once the graph is dropped, accepted iterations, chi2 before
          and after, the ATE after; 1 shard again on the store rescaled by
          1 + k 2^-23 (k = -1, 1: float32 draws);
      (b) each shard's S_half and rhs_corr of the first LM iteration at 4
          shards against the dense one-hot formula (`kitti00_dense_pieces`);
      (c) the flat engine's matrix-free GBA, `schur.global_ba_cg` on
          `facade.bucketed_to_flat(problem)`, 10 LM iterations, graphed,
          replayed and eager, and its draws at k = -1, 1 (its PCG stops at
          a relative residual of 1e-6, the bucketed GBA's at the forcing
          term 1e-2: not the same iterate).
    Gated by `scale_kitti00.dist_gates` against the card's record
    (`eval/scale_kitti00_dist.json`); (a)'s and (c)'s ATE and chi2 printed
    beside phase 22's GBA. With `write_record` (a path) the draws are
    those of `scale_kitti00.DIST_RECORD_JITTER_ULPS` and the run is written
    there as the record, then gated against itself (the record was made
    so). K2 and K3's launch counters are zeroed just before (a)'s graphed
    calls and read just after (returned, summed over the shard counts)."""
    import gc
    from types import SimpleNamespace

    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import scale_kitti00
    from sqrtlm_slam_tpu_torch.eval.scale import store_ate
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, facade, loss, schur, schur_bucketed
    from sqrtlm_slam_tpu_torch.parallel import dist_ba
    from sqrtlm_slam_tpu_torch.utils import cache

    t_phase = time.perf_counter()
    flow = scale_kitti00.FLOW
    record = None if write_record else scale_kitti00.load_dist_record()
    ulps = (scale_kitti00.DIST_RECORD_JITTER_ULPS if write_record
            else scale_kitti00.DIST_JITTER_ULPS)
    dev = torch.device("cuda")
    delta = float(np.sqrt(loss.CHI2_2DOF))
    iters = flow["gba_iters"]
    alone = keep is None
    if alone:
        t0 = time.perf_counter()
        keep = kitti00_corrected_store()
        alone_s = time.perf_counter() - t0
    true_R, true_t = keep["true_R"], keep["true_t"]
    p0, _ = gather_global_problem_bucketed(keep["corrected"], dev)
    P = p0.num_poses
    mu0 = torch.tensor(1e-3, device=dev)

    def ate_of(pose_R, pose_t) -> float:
        R, t = utils.to_host(pose_R, pose_t)
        return store_ate(SimpleNamespace(num_kf=P, kf_R=R, kf_t=t), true_R, true_t)

    def jittered(k: int):
        f = float(np.float32(1.0 + k * 2.0**-23))
        return p0._replace(pose_t=p0.pose_t * f, points=p0.points * f)

    def held() -> int:
        gc.collect()
        return kept_bytes()

    def measured(fn, eager: bool = False):
        """(fn(), its readings): `run_counted`'s, K2's and K3's launches, the
        peak allocated and the memory kept after it against before."""
        mem0 = held()
        torch.cuda.reset_peak_memory_stats()
        c2, c3 = assembly.launch_count, assembly.chi2_launch_count
        with cache.disable_graphs() if eager else contextlib.nullcontext():
            out, rec = run_counted(fn)
        rec.update(ba_assembly=assembly.launch_count - c2,
                   ba_chi2=assembly.chi2_launch_count - c3,
                   max_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
                   kept_mb=(held() - mem0) / 2**20)
        return out, rec

    chi2_before = float(schur_bucketed.chi2_only(p0, DEFAULT_CAM, p0.obs_valid, delta))
    launches = {"hamming": 0, "ba_assembly": 0, "ba_chi2": 0}

    # (a) Distributed BA at 4, 2 and 1 shards, (b) at 4 after (a)'s runs.
    shards, runs, draws = {}, {}, []
    dense = dict(S_rel=[], rhs_rel=[])
    for D in scale_kitti00.DIST_SHARDS:
        mem0 = held()
        mesh = dist_ba.make_mesh(D, "cuda")
        iterate = dist_ba.make_bucketed_lm_iterate(mesh, DEFAULT_CAM, num_iters=iters,
                                                   robust_delta=delta)

        def shard(problem):  # host partition and copy to the card, outside the timing
            return dist_ba.to_shards(dist_ba.partition_bucketed(problem, D)[0], mesh)

        def call(sp):
            out, chi2, n_acc = iterate(sp)
            return out.pose_R, out.pose_t, torch.cat(out.points), chi2, n_acc

        sp0 = shard(p0)
        rec = {}
        hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
        graphed, rec["graphed"] = measured(lambda: call(sp0))
        counts = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                  "ba_chi2": assembly.chi2_launch_count}
        launches = {k: launches[k] + n for k, n in counts.items()}
        again, rec["graphed_again"] = measured(lambda: call(sp0))
        eager, rec["eager"] = measured(lambda: call(sp0), eager=True)
        pose_R, pose_t, _, chi2, n_acc = graphed
        ate = ate_of(pose_R, pose_t)
        if D == 1:
            draws.append(dict(k=0, ate_m=ate, chi2=float(chi2)))
            for k in ulps:
                sp_k = shard(jittered(k))
                out, r = measured(lambda: call(sp_k))
                draws.append(dict(k=k, ate_m=ate_of(out[0], out[1]), chi2=float(out[3]),
                                  s=r["s"], graph_captures=r["graph_captures"]))
                del out, sp_k
        kept_mb = (held() - mem0) / 2**20
        dist_ba._lm_loop_jit.clear()
        equal = same_bits(graphed, again) and same_bits(again, eager)
        del graphed, again, eager, pose_R, pose_t, sp0
        shards[str(D)] = dict(completed=True, ate_m=ate, chi2=float(chi2), accepted=int(n_acc),
                              bitwise_equal=equal, max_allocated_mb=max(
                                  r["max_allocated_mb"] for r in rec.values()),
                              kept_mb=kept_mb, kept_mb_dropped=(held() - mem0) / 2**20)
        runs[str(D)] = rec
        if D == 4:  # (b) the first LM iteration's pieces of every shard
            sp = shard(p0)
            for i, pts in enumerate(sp.points):
                q = dist_ba._problem(sp, i, sp.pose_R, sp.pose_t, pts)
                red = schur_bucketed.assemble(q, DEFAULT_CAM, q.obs_valid, delta)
                got = schur_bucketed._pieces_tail(q, *red, mu0)
                S, rhs = kitti00_dense_pieces(q, red, mu0)
                dense["S_rel"].append(float((got.S_half - S).abs().max() / S.abs().max()))
                dense["rhs_rel"].append(float((got.rhs_corr - rhs).abs().max()
                                              / rhs.abs().max()))
                del red, got, S, rhs
            del sp
            dense["max_allocated_mb"] = torch.cuda.max_memory_allocated() / 2**20

    # (c) The flat engine's matrix-free GBA.
    flat_graphs = (schur._cg_head_jit, schur._pcg_chunk_jit, schur._lm_tail_jit)
    mem0 = held()

    def flat_call(problem):
        out, _, stats = schur.global_ba_cg(facade.bucketed_to_flat(problem), DEFAULT_CAM,
                                           num_iters=iters)
        return out.pose_R, out.pose_t, out.points, stats.chi2, stats.iters_accepted

    flat_p0 = facade.bucketed_to_flat(p0)
    flat_chi2_before = float(schur.chi2_only(flat_p0, DEFAULT_CAM, flat_p0.obs_valid, delta))
    del flat_p0
    flat_runs = {}
    f_graphed, flat_runs["graphed"] = measured(lambda: flat_call(p0))
    f_again, flat_runs["graphed_again"] = measured(lambda: flat_call(p0))
    f_eager, flat_runs["eager"] = measured(lambda: flat_call(p0), eager=True)
    flat_ate = ate_of(f_graphed[0], f_graphed[1])
    flat_draws = [dict(k=0, ate_m=flat_ate, chi2=float(f_graphed[3]))]
    for k in ulps:
        out, r = measured(lambda: flat_call(jittered(k)))
        flat_draws.append(dict(k=k, ate_m=ate_of(out[0], out[1]), chi2=float(out[3]),
                               s=r["s"], graph_captures=r["graph_captures"]))
        del out
    flat_kept = (held() - mem0) / 2**20
    for g in flat_graphs:
        g.clear()
    p_flat = p0._replace(pose_R=f_graphed[0], pose_t=f_graphed[1], points=f_graphed[2])
    flat = dict(ate_m=flat_ate, chi2=float(f_graphed[3]), chi2_before=flat_chi2_before,
                accepted=int(f_graphed[4]),
                bitwise_equal=same_bits(f_graphed, f_again) and same_bits(f_again, f_eager),
                chi2_plain=float(schur_bucketed.chi2_only(p_flat, DEFAULT_CAM, p0.obs_valid,
                                                          None)),
                max_allocated_mb=max(r["max_allocated_mb"] for r in flat_runs.values()),
                kept_mb=flat_kept, draws=flat_draws)
    del f_graphed, f_again, f_eager, p_flat
    flat["kept_mb_dropped"] = (held() - mem0) / 2**20

    run = dict(kfs=P, landmarks=p0.num_points, edges=int(p0.obs_valid.sum()),
               gba_iters=iters, robust_delta=delta, ate_after_loop_m=keep["ate_after_loop_m"],
               chi2_before=chi2_before, shards=shards, draws=draws, dense=dense, flat=flat)
    if write_record is not None:
        record = dict(card=CARD, **json.loads(json.dumps(run)))
        for d in record["draws"] + record["flat"]["draws"]:
            d.pop("s", None)
            d.pop("graph_captures", None)
        with open(write_record, "w") as f:
            json.dump(record, f, indent=1)
    bad = scale_kitti00.dist_gates(run, record)
    emit("kitti00_dist", **run, runs=runs, flat_runs=flat_runs, launches=launches,
         phase22_gba=keep.get("gba"), tolerances=scale_kitti00.dist_tolerances(run, record),
         dense_rel_tol=scale_kitti00.DIST_DENSE_REL_TOL,
         alone_store_and_phase22_s=alone_s if alone else None, failures=bad,
         seconds=time.perf_counter() - t_phase,
         note="graphed: the first call (it captures), graphed_again: replays only, eager: "
              "under disable_graphs; s to a synchronize; kept_mb: memory_reserved after "
              "empty_cache after the shard count's runs against before them (its capture "
              "held), kept_mb_dropped: the same once the graph is dropped; chi2: the LM's "
              "robust chi2 (delta sqrt(5.991)), chi2_plain: chi2_only without it (phase 22's "
              "chi2_after); draws: 1 shard / the flat GBA on the store rescaled by "
              "1 + k 2^-23")
    if min(launches["ba_assembly"], launches["ba_chi2"]) <= 0:
        bad.append(f"a kernel of distributed BA never launched: {launches}")
    if bad:
        raise AssertionError("KITTI 00 distributed BA and flat GBA: " + "; ".join(bad))
    return launches

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
    for P, L, K in ((96, 8192, 5), (600, 120000, 7), KITTI00_SHAPE, (1400, 60000, 7),
                    (6000, 60000, 7)) + WIDE_K_SHAPES:
        if P == 600:
            prob = gather_global_problem_bucketed(store, dev)[0]
        elif (P, L, K) == KITTI00_SHAPE:  # phase 22's problem, before its loop correction
            prob = gather_global_problem_bucketed(kitti00_scale_store()[0], dev)[0]
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
                if P == 600 or (P, L, K) == KITTI00_SHAPE:
                    k2_here["k2_at_this_shape"]["plain_ms"] = device_ms(
                        lambda: assembly.assemble_plain(*k2_args), n=3)
                if (P, L, K) == KITTI00_SHAPE:
                    # K2 against its plain version in float64 at phase 22's
                    # shape (the one-hot of L K P floats: ~22 GB in float64),
                    # by phase 3's rule, wherever the plain version in float32
                    # keeps that rule too: the store's points and poses lie up
                    # to 110 m from the origin, and float32 rounding of the
                    # camera-frame point (~1e-5 m) alone moves bl and U past it.
                    got2 = assembly.assemble(*k2_args, groups=groups)
                    plain2 = assembly.assemble_plain(*k2_args)
                    excess = {who: assembly.excess_over_plain(
                        res, *k2_args, rtol=K2_RTOL, atol=K2_ATOL, camera_sums=True)
                        for who, res in (("k2", got2), ("plain_f32", plain2))}
                    bad2 = {n: e for n, (e, _) in excess["k2"].items()
                            if e > 0 and excess["plain_f32"][n][0] <= 0}
                    if bad2:
                        raise AssertionError(f"K2 off its plain version at "
                                             f"{(P, L, K, delta)}: {bad2} (the float32 "
                                             f"plain version: {excess['plain_f32']})")
                    k2_here["k2_at_this_shape"]["excess_over_plain_f64"] = excess
                    del got2, plain2
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

    # 19 and 20 start here, in child processes beside phases 9-18 ----------
    children = start_child_phases()

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

    # 21. The LiDAR soak, beside the children's last minutes ---------------
    lidar_launches = lidar_soak_phase(
        reuse=os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_soak"))

    # 22. The loop correction at KITTI 00's scale ---------------------------
    kitti00 = {}
    kitti00_launches = kitti00_scale_phase(keep=kitti00)

    # 23. Distributed BA and the flat GBA at KITTI 00's scale -----------------
    kitti00_dist_launches = kitti00_dist_phase(kitti00)
    del kitti00

    # 19-20. The long run and the fusion soak (the child's) ----------------
    child_launches = finish_child_phases(children)
    long_launches, soak_launches = child_launches["long_run"], child_launches["kitti_soak"]

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
                                   graphs_paths=graph_launches["hamming"],
                                   long_run=long_launches["hamming"],
                                   kitti_soak=soak_launches["hamming"],
                                   lidar_soak=lidar_launches["hamming"],
                                   kitti00_loop_correction=kitti00_launches["hamming"],
                                   kitti00_dist_ba=kitti00_dist_launches["hamming"]),
             max_abs_err=0.0, **timed(k1[(2048, 2000)], "library_ms")),
        dict(name="ba_assembly", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:342",
             launches=fusion_launches["ba_assembly"],
             launches_by_path=dict(kitti_rgbd=launches["ba_assembly"],
                                   fusion=fusion_launches["ba_assembly"],
                                   gba_at_scale=gba_launches["ba_assembly"],
                                   kitti00_loop_correction=kitti00_launches["ba_assembly"],
                                   kitti00_dist_ba=kitti00_dist_launches["ba_assembly"],
                                   ring_loop=loop_launches["ba_assembly"],
                                   stereo=stereo_launches["ba_assembly"],
                                   mono=mono_launches["ba_assembly"],
                                   kitti_runner=runner_launches["ba_assembly"],
                                   dist_ba=dist_launches["ba_assembly"],
                                   cg_local_ba=dist_launches["cg_local_ba"]["ba_assembly"],
                                   local_ba_obs_cap_24=wide_launches["local_ba"]["ba_assembly"],
                                   gba_obs_per_landmark_32=wide_launches["gba"]["ba_assembly"],
                                   graphs_paths=graph_launches["ba_assembly"],
                                   long_run=long_launches["ba_assembly"],
                                   kitti_soak=soak_launches["ba_assembly"],
                                   lidar_soak=lidar_launches["ba_assembly"]),
             max_abs_err=k2_err,
             **timed(k2[(32, 4096, 8, 2.447)]), library_ms=None),
        dict(name="ba_chi2", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:508",
             launches=loop_launches["ba_chi2"],
             launches_by_path=dict(gba_at_scale=gba_launches["ba_chi2"],
                                   kitti00_loop_correction=kitti00_launches["ba_chi2"],
                                   kitti00_dist_ba=kitti00_dist_launches["ba_chi2"],
                                   ring_loop=loop_launches["ba_chi2"],
                                   kitti_runner=runner_launches["ba_chi2"],
                                   dist_ba=dist_launches["ba_chi2"],
                                   cg_local_ba=dist_launches["cg_local_ba"]["ba_chi2"],
                                   gba_obs_per_landmark_32=wide_launches["gba"]["ba_chi2"],
                                   long_run=long_launches["ba_chi2"],
                                   kitti_soak=soak_launches["ba_chi2"],
                                   lidar_soak=lidar_launches["ba_chi2"]),
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
