#!/usr/bin/env python3
"""Kernel device times and two end-to-end numbers of the PyTorch/CUDA port on
one GPU, for comparing two trees of the repository in one call on one card.

    python3 scripts/bench_torch_paths.py [--root DIR] [--label NAME]
                                         [--kernels-only | --local-ba-only]

Imports `sqrtlm_slam_tpu_torch` from DIR (default: this repository), builds
its kernels, then measures
  * kernel_ms: the device time per call of the hand-written kernels alone
    (the torch.profiler rows of the kernels defined in `csrc/`, summed over
    the kernels one wrapper call launches) for K1 at
    2048x2000 and 4096x2000 on random descriptors, K2 at (P, L, K) =
    (32, 4096, 8) and (96, 8192, 5) from `make_ba_problem` and at
    (600, 120000, 7) from the global-BA-at-scale store, and K3 at
    (96, 8192, 5), (600, 120000, 7), (1400, 60000, 7) and (6000, 60000, 7)
    (the last two on the bench problem's 14.4 m track, observations nearer
    than 1 m dropped; "pose cap" where the tree's K3 refuses P), with K2
    beside it at each K3 shape, and both past 16 slots per landmark at
    (32, 4096, 24), (96, 8192, 32), (96, 4096, 64) and the dense
    (64, 4096, 64) and (96, 2048, 96) ("K cap" where the tree refuses K),
    Huber 2.447; each
    also split by kernel
    (`<name>_by_kernel`); and `ticket_zero_ms`, the device time of zeroing
    one int32 on the card (what a per-call zeroed K3 ticket would add);
  * local_ba_lm_iters_per_s: the bench.py protocol (P=96, L=8192, 5
    observations per landmark, stereo 0.6, Huber 2.447, 15 LM iterations
    per `ba_iterate` call, 5 chained calls, one synchronize, best of 3),
    op by op and (`local_ba_graphed_lm_iters_per_s`) with each call a
    captured graph's replay (`utils.cache.graphed`; `--local-ba-only`
    measures these two alone);
  * tracked_frames_per_s: `SlamSystem.track_depth` over the bench.py
    tracking shape (240x320, 1000 ORB features, synthetic world seed 1,
    1200 points, 24 frames at 0.3 m), median over frames 5-23, each frame
    timed to `torch.cuda.synchronize()`;
and prints one JSON line with the card's name and power limit. Run it from
two trees in turns (A, B, B, A) to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# The kernels of csrc/ (this tree's and earlier ones'), by name.
OWN_KERNEL = re.compile(r"::(hamming\w*|ba_\w+|chi2_\w+)_kernel\b")


def _device_rows(fn, n: int = 20, own_only: bool = True) -> dict:
    """{kernel: device ms per call of `fn`}: the repository's kernels, or
    with `own_only=False` every kernel and memset that `fn` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        m = OWN_KERNEL.search(e.key)
        if e.device_type != torch.autograd.DeviceType.CUDA or (own_only and not m):
            continue
        name = m.group(1) + "_kernel" if m else e.key
        rows[name] = rows.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return rows


def _kernel_ms(dev, cam) -> dict:
    import torch

    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.eval.scale import make_scale_store
    from sqrtlm_slam_tpu_torch.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu_torch.ops import hamming
    from sqrtlm_slam_tpu_torch.optim import assembly, schur_bucketed

    out = {}
    rng = np.random.RandomState(0)
    for Q, T in ((2048, 2000), (4096, 2000)):
        q, t = (utils.desc_to_torch(rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64)
                                    .astype(np.uint32), dev) for n in (Q, T))
        out[f"k1_{Q}x{T}"] = sum(_device_rows(lambda: hamming.hamming_matrix(q, t)).values())
    problems = {}
    for P, L, K in ((32, 4096, 8), (96, 8192, 5), (1400, 60000, 7), (6000, 60000, 7),
                    (32, 4096, 24), (96, 8192, 32), (96, 4096, 64), (64, 4096, 64),
                    (96, 2048, 96)):
        big = dict(spacing=96 * 0.15 / P, min_depth=1.0) if P > 96 else {}
        flat, _ = synthetic.make_ba_problem(seed=0, P=P, L=L, stereo_frac=0.6,
                                            obs_per_landmark=0 if K == P else K, **big)
        problems[(P, L, K)] = schur_bucketed.from_flat(flat, K, device=dev)
    store, _, _ = make_scale_store(n_kf=600, n_lm=120_000, obs_per_lm=5, drift=4e-4)
    problems[(600, 120000, 7)] = gather_global_problem_bucketed(store, dev)[0]
    for (P, L, K), p in problems.items():
        w = p.obs_inv_sigma2 * p.obs_valid.float()
        args = (p.pose_R, p.pose_t, (~p.pose_fixed).float(), p.points, p.obs_cam, p.obs_uvr,
                w, cam, 2.447)
        key = f"{P}_{L}_{K}"
        try:
            assembly.assemble(*args)
        except ValueError as err:  # an older tree's cap of 16 slots per landmark
            out[f"k2_{key}"] = out[f"k3_{key}"] = "K cap"
            out[f"k2_{key}_refused"] = str(err)
            continue
        rows = _device_rows(lambda: assembly.assemble(*args))
        out[f"k2_{key}"], out[f"k2_{key}_by_kernel"] = sum(rows.values()), rows
        if (P, K) == (32, 8):
            continue
        k3_args = (p.pose_R, p.pose_t, p.points, p.obs_cam, p.obs_uvr, w, cam, 2.447)
        try:
            assembly.chi2_sum(*k3_args)
        except ValueError as err:  # an older tree's pose cap
            out[f"k3_{key}"] = "pose cap"
            out[f"k3_{key}_refused"] = str(err)
            continue
        rows = _device_rows(lambda: assembly.chi2_sum(*k3_args))
        out[f"k3_{key}"], out[f"k3_{key}_by_kernel"] = sum(rows.values()), rows
    out["ticket_zero_ms"] = sum(_device_rows(
        lambda: torch.zeros((), dtype=torch.int32, device=dev), n=50, own_only=False).values())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--local-ba-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_paths: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.ops import build
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem, SystemConfig
    from sqrtlm_slam_tpu_torch.utils import cache

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build.load_all(("hamming", "ba_assembly"))
    cam = synthetic.DEFAULT_CAM
    kernel_ms = None if args.local_ba_only else _kernel_ms(dev, cam)
    if args.kernels_only:
        print(json.dumps({"label": args.label, "card": card, "kernel_ms": kernel_ms}),
              flush=True)
        return

    flat, _ = synthetic.make_ba_problem(seed=0, P=96, L=8192, stereo_frac=0.6,
                                        obs_per_landmark=5)
    prob0 = schur_bucketed.from_flat(flat, 5, device=dev)
    iters, calls = 15, 5

    graphed_iterate = cache.graphed(schur_bucketed.ba_iterate,
                                    static_argnames=("cam", "num_iters", "robust_delta"))

    def lm_iters_per_s(iterate):
        """(LM iterations/s, chi2 at the end) of 5 chained calls, best of 3."""
        def ba_call(p):
            out, chi2, _ = iterate(p, cam, p.obs_valid, iters, robust_delta=2.447)
            return out, chi2

        ba_call(prob0)  # warm-up (the graphed one captures)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = prob0
            for _ in range(calls):
                out, chi2 = ba_call(out)
            chi2_end = float(chi2)
            best = min(best, time.perf_counter() - t0)
        return calls * iters / best, chi2_end

    iters_per_s, chi2_end = lm_iters_per_s(schur_bucketed.ba_iterate)
    graphed_per_s, graphed_chi2 = lm_iters_per_s(graphed_iterate)
    if args.local_ba_only:
        print(json.dumps({"label": args.label, "card": card,
                          "local_ba_lm_iters_per_s": iters_per_s,
                          "local_ba_graphed_lm_iters_per_s": graphed_per_s,
                          "chi2_end": chi2_end, "graphed_chi2_end": graphed_chi2}), flush=True)
        return

    world = synthetic.SyntheticWorld(seed=1, n_points=1200)
    frames = [world.render(T, cam) for T in synthetic.forward_trajectory(24, step=0.3)]
    system = SlamSystem(cam, SystemConfig(orb=ORBConfig(max_features=1000)), device=dev)
    secs, tracked = [], 0
    for img, depth in frames:
        t0 = time.perf_counter()
        tracked += system.track_depth(img, depth) is not None
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)

    print(json.dumps({
        "label": args.label, "card": card, "kernel_ms": kernel_ms,
        "local_ba_lm_iters_per_s": iters_per_s,
        "local_ba_graphed_lm_iters_per_s": graphed_per_s, "chi2_end": chi2_end,
        "tracked_frames_per_s": 1.0 / float(np.median(secs[5:])),
        "median_ms": 1e3 * float(np.median(secs[5:])), "tracked": tracked,
        "frames": len(frames)}), flush=True)


if __name__ == "__main__":
    main()
