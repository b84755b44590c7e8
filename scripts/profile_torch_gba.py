#!/usr/bin/env python3
"""Where the port's loop-closure time goes at scale on one GPU.

    python3 scripts/profile_torch_gba.py

Builds the global-BA-at-scale store (600 keyframes, 1.2e5 landmarks, 5
observations each, drift 4e-4; `eval/scale.py`) and the essential graph of
its true loop edge, then prints one JSON object of warm timings (host clock
around synchronized calls, the first call of each piece excluded):
  * the essential graph: one and five iterations, the vmapped Sim3
    Jacobians, the fixed-order block plan, a 4200x4200 Cholesky, and a
    torch.profiler window over one iteration (launches, device ms, top ops);
  * global BA after the essential graph: the whole-map gather, K3, the
    camera plan, one PCG step and its CG iterations, the K2 context, one
    Schur matvec, 10 LM iterations of `ba_iterate_cg`, and a profiler
    window over 2 LM iterations (device busy ms against wall ms).
The first line carries the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_gba: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM as cam
    from sqrtlm_slam_tpu_torch.factors import pose_graph
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import LoopCloser, LoopClosingConfig
    from sqrtlm_slam_tpu_torch.loop import essential_graph as eg
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.optim import loss, segment
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed as sb

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    store, true_R, true_t = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5,
                                             drift=4e-4)
    lc = LoopCloser(store, cam, cfg=LoopClosingConfig(edge_cap=16384), device=dev)
    K = store.num_kf
    R_cl = true_R[K - 1] @ true_R[0].T
    t_cl = true_t[K - 1] - R_cl @ true_t[0]
    S12 = sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R_cl), torch.as_tensor(t_cl))
    ones = np.ones(K, np.float32)
    pg = lc._build_pose_graph(K - 1, 0, S12, ones, store.kf_R[:K].copy(),
                              store.kf_t[:K].copy(), ones.copy(), store.kf_R[:K].copy(),
                              store.kf_t[:K].copy())

    def warm_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    def window(fn, top=8):
        """Profiler window: wall ms (profiler on), kernel ms (device events
        only: op rows would count each kernel twice), idle share, launches."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        ka = prof.key_averages()
        kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        return dict(
            launches=sum(e.count for e in ka if e.key == "cudaLaunchKernel"),
            wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1.0 - device_ms / wall_ms,
            top_kernels=[(e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count)
                         for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]])

    out = {}
    out["eg_1iter_ms"] = warm_ms(lambda: eg.optimize_pose_graph(pg, num_iters=1))
    out["eg_5iter_ms"] = warm_ms(lambda: eg.optimize_pose_graph(pg, num_iters=5), 2)
    S_i, S_j = eg._edge_poses(pg)
    out["eg_jacobians_ms"] = warm_ms(
        lambda: pose_graph.sim3_relative_residual_jac(S_i, S_j, pg.measurements()))
    ei, ej = pg.e_i.long(), pg.e_j.long()
    out["eg_block_plan_ms"] = warm_ms(lambda: segment.segment_plan(
        torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), K * K,
        keep=pg.e_valid.repeat(4)))
    A = torch.randn(K * 7, K * 7, device=dev)
    A = A @ A.T + K * 7 * torch.eye(K * 7, device=dev)
    out["eg_cholesky_ms"] = warm_ms(lambda: torch.linalg.cholesky(A))
    out["eg_edges"] = [int(pg.e_valid.sum()), int(pg.e_valid.numel())]
    out["eg_1iter_window"] = window(lambda: eg.optimize_pose_graph(pg, num_iters=1))

    res, _ = eg.optimize_pose_graph(pg, num_iters=30)
    lc._apply_pose_graph(res, K)
    p, _ = gather_global_problem_bucketed(store, dev)
    act, delta = p.obs_valid, math.sqrt(loss.CHI2_2DOF)
    mu = torch.tensor(1e-3, device=dev)
    plan = sb.pose_plan(p, act)
    out["gather_ms"] = warm_ms(lambda: gather_global_problem_bucketed(store, dev))
    out["k3_ms"] = warm_ms(lambda: sb.chi2_only(p, cam, act, delta), 10)
    out["camera_plan_ms"] = warm_ms(lambda: sb.pose_plan(p, act))
    out["pcg_step_ms"] = warm_ms(lambda: sb.cg_reduce_and_solve(
        p, cam, act, delta, mu, cg_iters=100, cg_tol=1e-2, plan=plan), 5)
    out["pcg_step_cg_iters"] = int(sb.cg_reduce_and_solve(
        p, cam, act, delta, mu, cg_iters=100, cg_tol=1e-2, plan=plan)[5])
    ctx = sb._cg_context(p, cam, act, delta, mu)
    out["k2_context_ms"] = warm_ms(lambda: sb._cg_context(p, cam, act, delta, mu), 5)
    v = torch.randn(K, 6, device=dev)
    out["matvec_ms"] = warm_ms(lambda: sb._schur_matvec(v, ctx, p.obs_cam, p.pose_fixed,
                                                        plan), 20)
    out["lm10_ms"] = warm_ms(lambda: sb.ba_iterate_cg(p, cam, act, 10, robust_delta=delta), 2)
    t = time.perf_counter()
    sb.ba_iterate_cg(p, cam, act, 2, robust_delta=delta)
    torch.cuda.synchronize()
    out["lm2_wall_ms"] = (time.perf_counter() - t) * 1e3
    out["lm2_window"] = window(lambda: sb.ba_iterate_cg(p, cam, act, 2, robust_delta=delta))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
