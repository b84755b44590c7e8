#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sqrtlm_slam_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. build the hand-written kernels K1 (csrc/hamming.cu) and K2
     (csrc/ba_assembly.cu) with nvcc for sm_90a;
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
     chained calls, one synchronize, best of 3); chi2 must fall.
Then the kernel summary line, the card line, and the final status line.

Imports nothing of JAX and nothing of the JAX package; inputs are made
from seeds with numpy. Needs `torch.cuda.is_available()`.
"""

from __future__ import annotations

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
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.ops import build, hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig

    CARD = card_line()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Build -----------------------------------------------------------
    built = {}
    for name in ("hamming", "ba_assembly"):
        build.load(name)
        info = build.build_info(name)
        built[name] = info["build_s"]
        ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, build_s=info["build_s"], ptxas=ptxas)

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
    ]
    emit("done", total_s=time.perf_counter() - t_start, build_s=built)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
