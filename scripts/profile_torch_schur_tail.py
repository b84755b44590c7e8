#!/usr/bin/env python3
"""Where the sqrt-Schur tail's time goes on the card.

    python3 scripts/profile_torch_schur_tail.py

Times `schur_bucketed._pieces_tail` (the slot-pair sums of Y Y^T and
rhs_corr, the damping, the closed-form 3x3 factors) on K2's plain
reductions at bench.py's shape (96 poses, 8,192 landmarks, 5 slots,
`make_ba_problem`, Huber 2.447) and at KITTI 00's (`make_scale_store` at
1,400 keyframes x 280,000 landmarks, 7 slots: one shard of phase 23):
graphed (a captured graph's replay, CUDA events, median of 20) and eager
(host clock to a synchronize, best of 5), and the device time of its
largest kernels (torch.profiler, 3 eager calls). Prints the card's name
and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_schur_tail: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.optim import assembly
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed as sb
    from sqrtlm_slam_tpu_torch.utils import cache

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    flat, _ = synthetic.make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6,
                                        obs_per_landmark=5)
    store, _, _ = make_scale_store(n_kf=1400, n_lm=280_000, obs_per_lm=5, drift=4e-4)
    problems = (("bench", sb.from_flat(flat, 5, device=dev)),
                ("kitti00", gather_global_problem_bucketed(store, dev)[0]))
    mu = torch.tensor(1e-3, device=dev)
    for name, p in problems:
        red = assembly.assemble_plain(p.pose_R, p.pose_t, ~p.pose_fixed, p.points, p.obs_cam,
                                      p.obs_uvr, p.obs_inv_sigma2 * p.obs_valid.float(),
                                      synthetic.DEFAULT_CAM, 2.447)
        graphed = cache.graphed(sb._pieces_tail)
        graphed(p, *red, mu)
        torch.cuda.synchronize()
        replays = []
        for _ in range(20):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graphed(p, *red, mu)
            b.record()
            b.synchronize()
            replays.append(a.elapsed_time(b))
        eager = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sb._pieces_tail(p, *red, mu)
            torch.cuda.synchronize()
            eager.append(1e3 * (time.perf_counter() - t))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                sb._pieces_tail(p, *red, mu)
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.device_time_total / 3e3) for e in prof.key_averages()
                       if e.device_time_total > 0), key=lambda r: -r[1])[:10]
        print(json.dumps(dict(shape=name, P=p.num_poses, L=p.num_points,
                              K=int(p.obs_cam.shape[1]),
                              graphed_ms=sorted(replays)[len(replays) // 2],
                              eager_ms=min(eager),
                              top_device_ms=[(k[:80], v) for k, v in rows])), flush=True)
        del graphed


if __name__ == "__main__":
    main()
