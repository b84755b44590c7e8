"""Worker entry point for multi-process distributed BA.

Each OS process runs

    python -m sqrtlm_slam_tpu_torch.parallel.mp_worker \\
        --coordinator localhost:PORT --nproc N --pid I \\
        [--shards-per-proc 2] [--device cuda|cpu] [--backend gloo|nccl] [--out result.npz]

Every worker builds the same synthetic BA problem (the port's numpy
`eval.synthetic.make_ba_problem`), joins the process group and runs the
Nielsen LM loop over all processes' shards (`multiprocess.distributed_ba_lm`)
once for one iteration (warm-up), then timed. Each prints one JSON line:
chi2, accepted steps, a SHA-256 digest of its resulting poses and landmarks
(equal digests = bitwise-equal results on every rank), the timed call's
wall seconds, and the median ms of one iteration's two all-reduces at this
problem's sizes. Process 0 writes the result to `--out`. Two ranks on one
GPU need `--backend gloo` (NCCL takes one GPU per rank).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def result_digest(pose_R, pose_t, points, chi2) -> str:
    """SHA-256 of a result's host arrays: equal digests, bitwise-equal
    results."""
    import numpy as np

    return hashlib.sha256(b"".join(np.ascontiguousarray(np.asarray(a)).tobytes()
                                   for a in (pose_R, pose_t, points, chi2))).hexdigest()


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_reduce_ms(numel: int, device, n: int = 20) -> float:
    """Median ms of one all_reduce of `numel` float32 on `device`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    buf = torch.ones(numel, dtype=torch.float32, device=device)
    times = []
    for _ in range(n + 2):
        _sync(device)
        t = time.perf_counter()
        dist.all_reduce(buf)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times[2:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--shards-per-proc", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--out", default="")
    ap.add_argument("--poses", type=int, default=5)
    ap.add_argument("--landmarks", type=int, default=48)
    ap.add_argument("--obs-per-lm", type=int, default=5)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM, make_ba_problem
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed
    from sqrtlm_slam_tpu_torch.parallel import multiprocess
    from sqrtlm_slam_tpu_torch.utils import to_host

    torch.backends.cuda.matmul.allow_tf32 = False
    multiprocess.initialize(args.coordinator, args.nproc, args.pid, backend=args.backend,
                            device=args.device)
    try:
        mesh = multiprocess.global_mesh(args.shards_per_proc, device=args.device)
        flat, _ = make_ba_problem(seed=args.seed, P=args.poses, L=args.landmarks,
                                  obs_per_landmark=args.obs_per_lm)
        b = schur_bucketed.from_flat(flat, K=args.obs_per_lm, device=mesh.home)
        multiprocess.distributed_ba_lm(b, DEFAULT_CAM, mesh, num_iters=1)  # warm-up
        _sync(mesh.home)
        t0 = time.perf_counter()
        out, chi2, n_acc = multiprocess.distributed_ba_lm(b, DEFAULT_CAM, mesh,
                                                          num_iters=args.iters)
        _sync(mesh.home)
        wall = time.perf_counter() - t0
        P6 = 6 * args.poses
        comm_ms = _all_reduce_ms(P6 * P6 + 2 * P6, mesh.home) + _all_reduce_ms(2, mesh.home)
        pose_R, pose_t, points, chi2, n_acc = to_host(out.pose_R, out.pose_t, out.points,
                                                      chi2, n_acc)
        digest = result_digest(pose_R, pose_t, points, chi2)
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "sqrtlm_slam_tpu")]
        if loaded:
            raise RuntimeError(f"mp_worker imported the JAX package or JAX: {loaded[:5]}")
        print(json.dumps({
            "rank": args.pid, "nproc": args.nproc, "shards": mesh.num_shards,
            "device": str(mesh.home), "backend": dist.get_backend(), "chi2": float(chi2),
            "accepted": int(n_acc), "iters": args.iters, "digest": digest, "wall_s": wall,
            "allreduce_ms_per_iter": comm_ms}), flush=True)
        if args.out and args.pid == 0:
            np.savez(args.out, pose_R=pose_R, pose_t=pose_t, points=points, chi2=float(chi2),
                     n_acc=int(n_acc), n_shards=mesh.num_shards)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
