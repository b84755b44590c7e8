#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sqrtlm_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. build the hand-written kernels K1 (csrc/hamming.cu) and K2 with its
     chi2-only instance K3 (csrc/ba_assembly.cu) with nvcc for sm_90a, one
     compiler per source, started together;
  2. K1 against its plain PyTorch version at the main path's shapes on
     random full-32-bit descriptors — exactly equal — with both times;
  3. K2 against its plain version at (P, L, K) = (32, 4096, 8) and
     (96, 8192, 5), with and without the Huber kernel, at rtol 5e-3 /
     atol 5e-4, bitwise repeatable, with both times;
  4. the main path at KITTI size: `SlamSystem.track_depth` over 16 frames of
     a synthetic world rendered at 1226x370 with the KITTI 00-02
     intrinsics, 2000 ORB features, default tracking and mapping configs.
     Launch counters are zeroed just before and read just after; every
     frame must track, with >= 3 keyframes, >= 1 local BA, both kernels
     launched, ATE < 0.05 m;
  5. the tracking shape of bench.py (240x320, 1000 features, 24 frames);
  6. local-BA LM iterations/s at the bench.py shape (P=96, L=8192, 5
     observations per landmark, Huber 2.447, 15 iterations per call, 5
     chained calls, one synchronize, best of 3); chi2 must fall;
  7. K3 against its plain version at (P, L, K) = (96, 8192, 5) (the bench
     problem) and (600, 120000, 7) (phase 8's global-BA problem), with and
     without the Huber kernel: rtol 1e-4 against
     the plain version evaluated in float64, bitwise repeatable, compared
     with K2's chi2 on the same inputs, with both times;
  8. global BA at scale (benchmarks/bench_scale.py's flow): 600 keyframes,
     1.2e5 landmarks, 5 observations each, drift 4e-4; the true loop edge
     through the essential graph (edge_cap 16384, 30 iterations), then 10 LM
     iterations of `LoopCloser.run_global_ba`. Counters zeroed just before
     the GBA and read just after; ATE must fall at each stage, chi2 must
     fall, K2 and K3 must launch, and a second GBA from the same store must
     give bitwise-equal poses and landmarks;
  9. the loop path end to end: `SlamSystem(..., loop_detection=True)` over
     the ring scene of tests/test_e2e_loop.py (ring_world(7, 2500), 160
     frames at frac 1.3, 240x320, 600 features, default LoopClosingConfig).
     Counters zeroed just before and read just after; >= 158 frames tracked,
     >= 1 loop closed, >= 20 landmarks fused, ATE < 0.3 m, K3 launched
     inside the loop's global BA.
Then the kernel summary line, the card line, and the final status line.

Imports nothing of JAX and nothing of the JAX package; inputs are made
from seeds with numpy. Needs `torch.cuda.is_available()`.
"""

from __future__ import annotations

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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median device time of `fn` in ms (CUDA events around each call)."""
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


def gt_cam_to_world(poses) -> np.ndarray:
    out = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = T.R, T.t
        out.append(np.linalg.inv(M))
    return np.stack(out)


def run_sequence(SlamSystem, cfg, cam, frames, device, time_from: int):
    """Track `frames`; returns (system, per-frame seconds, tracked count)."""
    import torch

    system = SlamSystem(cam, cfg, device=device)
    seconds, tracked = [], 0
    for img, depth in frames:
        t0 = time.perf_counter()
        pose = system.track_depth(img, depth)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        tracked += pose is not None
    return system, seconds[time_from:], tracked


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
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig, essential_graph
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.ops import build, hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig

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
    for Q, T in ((2048, 2000), (4096, 2000), (2000, 2000)):
        q, t = words(Q), words(T)
        got = hamming.hamming_matrix(q, t)
        want = hamming.hamming_matrix_plain(q, t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at {(Q, T)}")
        ms = cuda_ms(lambda: hamming.hamming_matrix(q, t))
        plain_ms = cuda_ms(lambda: hamming.hamming_matrix_plain(q, t), n=5)
        k1[(Q, T)] = (ms, plain_ms)
        emit("k1_vs_plain", shape=[Q, T], exact=True, ms=ms, plain_ms=plain_ms)

    # 3. K2 vs plain ------------------------------------------------------
    cam_bench = synthetic.DEFAULT_CAM
    k2 = {}
    k2_err = 0.0
    for P, L, K in ((32, 4096, 8), (96, 8192, 5)):
        flat, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6,
                                            obs_per_landmark=K)
        prob = schur_bucketed.from_flat(flat, K, device=dev)
        w = prob.obs_inv_sigma2 * prob.obs_valid.float()
        for delta in (None, 2.447):
            args = (prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(), prob.points,
                    prob.obs_cam, prob.obs_uvr, w, cam_bench, delta)
            got = assembly.assemble(*args)
            again = assembly.assemble(*args)
            plain32 = assembly.assemble_plain(*args)
            torch.cuda.synchronize()
            for name, g, a in zip(assembly.AssemblyOut._fields, got, again):
                if not torch.equal(g, a):
                    raise AssertionError(f"K2 {name} not repeatable at {(P, L, K, delta)}")
            # Against the plain version evaluated in float64 on the same inputs
            # (see assembly.excess_over_plain for the rule).
            excess = assembly.excess_over_plain(got, *args, rtol=K2_RTOL, atol=K2_ATOL)
            bad = {n: e for n, (e, _) in excess.items() if e > 0}
            if bad:
                raise AssertionError(f"K2 off its plain version at {(P, L, K, delta)}: {bad}")
            args64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                      for a in args]
            errs = {n: float((g.double() - p).abs().max()) for n, g, p in
                    zip(assembly.AssemblyOut._fields, got, assembly.assemble_plain(*args64))}
            vs32 = {n: float((g - p).abs().max())
                    for n, g, p in zip(assembly.AssemblyOut._fields, got, plain32)}
            k2_err = max(k2_err, max(errs.values()))
            ms = cuda_ms(lambda: assembly.assemble(*args))
            plain_ms = cuda_ms(lambda: assembly.assemble_plain(*args), n=10)
            k2[(P, L, K, delta)] = (ms, plain_ms)
            emit("k2_vs_plain", shape=[P, L, K], robust_delta=delta, rtol=K2_RTOL,
                 atol=K2_ATOL, max_abs_err_vs_plain_f64=errs,
                 beyond_rtol_atol={n: c for n, (_, c) in excess.items()},
                 max_abs_diff_vs_plain_f32=vs32, repeatable=True, ms=ms, plain_ms=plain_ms)

    # 4. Main path at KITTI size ------------------------------------------
    kcam = Camera(**KITTI_INTRINSICS)
    world = synthetic.SyntheticWorld(seed=1, n_points=3000)
    poses = synthetic.forward_trajectory(16, step=0.3)
    frames = [world.render(T, kcam, H=KITTI_H, W=KITTI_W) for T in poses]
    cfg = SystemConfig(orb=ORBConfig(max_features=2000))
    hamming.launch_count = 0
    assembly.launch_count = 0
    utils.host_reads = 0
    t0 = time.perf_counter()
    system, secs, tracked = run_sequence(SlamSystem, cfg, kcam, frames, dev, time_from=5)
    wall = time.perf_counter() - t0
    launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count}
    reads = utils.host_reads
    ate, _ = ate_rmse(system.get_trajectory(), gt_cam_to_world(poses), align_scale=False)
    main = dict(frames=len(frames), tracked=tracked, keyframes=system.num_keyframes(),
                landmarks=system.num_landmarks(), local_ba=system.local_mapper.num_local_ba,
                launches=launches, ate_m=ate,
                tracked_frames_per_s=1.0 / float(np.median(secs)),
                median_ms=1e3 * float(np.median(secs)),
                host_reads_per_frame=reads / len(frames), wall_s=wall)
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
    poses_b = synthetic.forward_trajectory(24, step=0.3)
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
    k3 = {}
    k3_err = 0.0
    for P, L, K in ((96, 8192, 5), (600, 120000, 7)):
        if P == 600:
            prob = gather_global_problem_bucketed(store, dev)[0]
        else:
            flat, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6,
                                                obs_per_landmark=K)
            prob = schur_bucketed.from_flat(flat, K, device=dev)
        if tuple(prob.obs_cam.shape) != (L, K) or prob.num_poses != P:
            raise AssertionError(f"K3 problem shape {prob.num_poses, *prob.obs_cam.shape}")
        w = prob.obs_inv_sigma2 * prob.obs_valid.float()
        for delta in (None, 2.447):
            args = (prob.pose_R, prob.pose_t, prob.points, prob.obs_cam, prob.obs_uvr, w,
                    cam_bench, delta)
            got = assembly.chi2_sum(*args)
            again = assembly.chi2_sum(*args)
            k2_chi2 = assembly.assemble(prob.pose_R, prob.pose_t, (~prob.pose_fixed).float(),
                                        prob.points, prob.obs_cam, prob.obs_uvr, w, cam_bench,
                                        delta).chi2
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
            ms = cuda_ms(lambda: assembly.chi2_sum(*args))
            plain_ms = cuda_ms(lambda: assembly.chi2_plain(*args), n=10)
            k3[(P, L, K, delta)] = (ms, plain_ms)
            emit("k3_vs_plain", shape=[P, L, K], robust_delta=delta, rtol=K3_RTOL,
                 chi2=float(got), plain_f64=want, rel_err=rel, repeatable=True,
                 equal_to_k2_chi2=bool(torch.equal(got, k2_chi2)),
                 k2_chi2_diff=float(got) - float(k2_chi2), ms=ms, plain_ms=plain_ms)
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
    t0 = time.perf_counter()
    pg_out, eg_chi2 = essential_graph.optimize_pose_graph(pg, num_iters=30)
    torch.cuda.synchronize()
    eg_opt_s = time.perf_counter() - t0
    lc._apply_pose_graph(pg_out, Kf)
    ate_eg = store_ate(store, true_R, true_t)
    p0, _ = gather_global_problem_bucketed(store, dev)
    chi2_before = float(schur_bucketed.chi2_only(p0, cam_bench, p0.obs_valid, None))
    n_edges = int(p0.obs_valid.sum())
    del p0
    snapshot = copy.deepcopy(store)
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gba_ok = lc.run_global_ba()
    torch.cuda.synchronize()
    gba_s = time.perf_counter() - t0
    gba_launches = {"ba_assembly": assembly.launch_count,
                    "ba_chi2": assembly.chi2_launch_count}
    gba_reads = utils.host_reads
    ate_gba = store_ate(store, true_R, true_t)
    p1, _ = gather_global_problem_bucketed(store, dev)
    chi2_after = float(schur_bucketed.chi2_only(p1, cam_bench, p1.obs_valid, None))
    del p1
    lc2 = LoopCloser(snapshot, cam_bench, cfg=gba_cfg, device=dev)
    t0 = time.perf_counter()
    gba2_ok = lc2.run_global_ba()
    torch.cuda.synchronize()
    gba2_s = time.perf_counter() - t0
    repeat_equal = all(np.array_equal(getattr(store, f), getattr(snapshot, f))
                       for f in ("kf_R", "kf_t", "lm_pos", "lm_obs_kf"))
    emit("gba_at_scale", kfs=600, landmarks=120_000, edges=n_edges, gba_iters=10,
         store_build_s=build_store_s, essential_graph_build_s=eg_build_s,
         essential_graph_opt_s=eg_opt_s, essential_graph_edges=int(pg.e_valid.sum()),
         essential_graph_chi2=float(eg_chi2), gba_s=gba_s, gba_repeat_s=gba2_s,
         gba_completed=bool(gba_ok), ate_drift_m=ate_drift, ate_after_loop_m=ate_eg,
         ate_after_gba_m=ate_gba, chi2_before=chi2_before, chi2_after=chi2_after,
         launches=gba_launches, host_reads=gba_reads, repeat_bitwise_equal=repeat_equal,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (gba_ok and gba2_ok):
        raise AssertionError("global BA at scale did not complete")
    if not ate_drift > ate_eg > ate_gba:
        raise AssertionError(f"ATE did not fall at each stage: {ate_drift}, {ate_eg}, {ate_gba}")
    if not chi2_after < chi2_before:
        raise AssertionError(f"GBA chi2 did not fall: {chi2_before} -> {chi2_after}")
    if min(gba_launches.values()) <= 0:
        raise AssertionError(f"a kernel of global BA never launched: {gba_launches}")
    if not repeat_equal:
        raise AssertionError("a second GBA from the same store gave different results")
    del store, snapshot, lc, lc2, pg, pg_out

    # 9. The loop path end to end -----------------------------------------
    ring = synthetic.ring_world(seed=7, n_points=2500)
    ring_poses = synthetic.ring_trajectory(160, frac=1.3)
    ring_frames = [ring.render(T, cam_bench) for T in ring_poses]
    loop_sys = SlamSystem(cam_bench, SystemConfig(orb=ORBConfig(max_features=600),
                                                  loop_detection=True),
                          device=dev, loop_cfg=LoopClosingConfig())
    lc = loop_sys.loop_closer
    gba_runs = []
    run_gba = lc.run_global_ba

    def counted_gba(generation=None):
        c2, c3 = assembly.launch_count, assembly.chi2_launch_count
        t = time.perf_counter()
        ok = run_gba(generation)
        torch.cuda.synchronize()
        gba_runs.append(dict(ok=ok, s=time.perf_counter() - t, kfs=loop_sys.num_keyframes(),
                             ba_assembly=assembly.launch_count - c2,
                             ba_chi2=assembly.chi2_launch_count - c3))
        return ok

    lc.run_global_ba = counted_gba
    hamming.launch_count = assembly.launch_count = assembly.chi2_launch_count = 0
    utils.host_reads = 0
    ring_secs, ring_tracked = [], 0
    t0 = time.perf_counter()
    for img, depth in ring_frames:
        t = time.perf_counter()
        pose = loop_sys.track_depth(img, depth)
        torch.cuda.synchronize()
        ring_secs.append(time.perf_counter() - t)
        ring_tracked += pose is not None
    loop_sys.shutdown()
    ring_wall = time.perf_counter() - t0
    loop_launches = {"hamming": hamming.launch_count, "ba_assembly": assembly.launch_count,
                     "ba_chi2": assembly.chi2_launch_count}
    est = loop_sys.get_trajectory()
    ring_ate, _ = ate_rmse(est, gt_cam_to_world(ring_poses[: len(est)]))
    k3_in_gba = sum(r["ba_chi2"] for r in gba_runs)
    emit("loop_path_ring", frames=len(ring_frames), tracked=ring_tracked,
         keyframes=loop_sys.num_keyframes(), landmarks=loop_sys.num_landmarks(),
         loops_closed=lc.num_loops_closed, loops_rejected=lc.num_loops_rejected,
         last_fused=lc.last_fused, gba_completed=lc.num_gba_completed, gba_runs=gba_runs,
         launches=loop_launches, ate_m=ring_ate,
         median_ms=1e3 * float(np.median(ring_secs)), max_ms=1e3 * float(np.max(ring_secs)),
         host_reads_per_frame=utils.host_reads / len(ring_frames), wall_s=ring_wall)
    if ring_tracked < len(ring_frames) - 2:
        raise AssertionError(f"ring: tracked {ring_tracked}/{len(ring_frames)}")
    if lc.num_loops_closed < 1 or lc.last_fused < 20:
        raise AssertionError(f"ring: {lc.num_loops_closed} loops, {lc.last_fused} fused")
    if not ring_ate < 0.3:
        raise AssertionError(f"ring ATE {ring_ate} m >= 0.3 m")
    if k3_in_gba <= 0 or min(loop_launches.values()) <= 0:
        raise AssertionError(f"ring: a kernel never launched: {loop_launches}, {gba_runs}")

    # Summary -------------------------------------------------------------
    kernels = [
        dict(name="hamming", route="cuda", source="sqrtlm_slam_tpu_torch/csrc/hamming.cu",
             replaces="sqrtlm_slam_tpu/ops/hamming.py:45", launches=launches["hamming"],
             max_abs_err=0.0, ms=k1[(2048, 2000)][0], plain_ms=k1[(2048, 2000)][1]),
        dict(name="ba_assembly", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:342",
             launches=launches["ba_assembly"], max_abs_err=k2_err,
             ms=k2[(32, 4096, 8, 2.447)][0], plain_ms=k2[(32, 4096, 8, 2.447)][1]),
        dict(name="ba_chi2", route="cuda",
             source="sqrtlm_slam_tpu_torch/csrc/ba_assembly.cu",
             replaces="sqrtlm_slam_tpu/optim/assembly_pallas.py:508",
             launches=loop_launches["ba_chi2"], max_abs_err=k3_err,
             ms=k3[(600, 120000, 7, 2.447)][0], plain_ms=k3[(600, 120000, 7, 2.447)][1]),
    ]
    emit("done", total_s=time.perf_counter() - t_start, build_s=built)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
