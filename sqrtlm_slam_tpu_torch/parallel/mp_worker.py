"""Worker entry point for multi-process distributed BA.

Each OS process runs

    python -m sqrtlm_slam_tpu_torch.parallel.mp_worker \\
        --coordinator localhost:PORT --nproc N --pid I \\
        [--shards-per-proc 2] [--device cuda|cpu] [--backend gloo|nccl] [--out result.npz]

Every worker builds the same synthetic BA problem (the port's numpy
`eval.synthetic.make_ba_problem`), joins the process group and runs the
Nielsen LM loop over all processes' shards (`multiprocess.distributed_ba_lm`)
once (the first call, which captures its graphs), then timed, then once
more under torch.profiler (on the card), then eagerly
(`cache.disable_graphs()`: timed, then profiled on the card). Each prints one JSON line: chi2, accepted
steps, a SHA-256 digest of its resulting poses and landmarks (equal digests
= bitwise-equal results on every rank), the timed call's wall seconds, the
median ms of one iteration's two all-reduces at this problem's sizes, the
first call's seconds and captures, the timed call's captures and replays,
the CUDA launches of a call (kernel and graph launches, counted by the
profiler; null on the CPU) graphed and eager, the eager call's wall
seconds, and whether its digest equals the graphed one. Process 0 writes
the result to `--out`. Two ranks on one GPU need `--backend gloo` (NCCL
takes one GPU per rank).
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


_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")


def _cuda_launches(fn, device):
    """CUDA launches (kernels and graphs) of one call of `fn`, from
    torch.profiler; None off the card (where `fn` is not called)."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    return sum(e.count for e in prof.key_averages() if e.key in _LAUNCHES)


def _timed(fn, device):
    """(fn(), wall seconds to a synchronize, graph captures, graph replays)."""
    from sqrtlm_slam_tpu_torch import utils

    utils.graph_captures = utils.graph_replays = 0
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0, utils.graph_captures, utils.graph_replays


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
    from sqrtlm_slam_tpu_torch.utils import cache, to_host

    torch.backends.cuda.matmul.allow_tf32 = False
    multiprocess.initialize(args.coordinator, args.nproc, args.pid, backend=args.backend,
                            device=args.device)
    try:
        mesh = multiprocess.global_mesh(args.shards_per_proc, device=args.device)
        flat, _ = make_ba_problem(seed=args.seed, P=args.poses, L=args.landmarks,
                                  obs_per_landmark=args.obs_per_lm)
        b = schur_bucketed.from_flat(flat, K=args.obs_per_lm, device=mesh.home)

        def run():
            return multiprocess.distributed_ba_lm(b, DEFAULT_CAM, mesh, num_iters=args.iters)

        _, first_s, first_captures, _ = _timed(run, mesh.home)
        (out, chi2, n_acc), wall, captures, replays = _timed(run, mesh.home)
        launches = _cuda_launches(run, mesh.home)
        with cache.disable_graphs():
            (e_out, e_chi2, _), eager_wall, _, _ = _timed(run, mesh.home)
            eager_launches = _cuda_launches(run, mesh.home)
        P6 = 6 * args.poses
        comm_ms = _all_reduce_ms(P6 * P6 + 2 * P6, mesh.home) + _all_reduce_ms(2, mesh.home)
        pose_R, pose_t, points, chi2, n_acc = to_host(out.pose_R, out.pose_t, out.points,
                                                      chi2, n_acc)
        digest = result_digest(pose_R, pose_t, points, chi2)
        eager_digest = result_digest(*to_host(e_out.pose_R, e_out.pose_t, e_out.points,
                                              e_chi2))
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "sqrtlm_slam_tpu")]
        if loaded:
            raise RuntimeError(f"mp_worker imported the JAX package or JAX: {loaded[:5]}")
        print(json.dumps({
            "rank": args.pid, "nproc": args.nproc, "shards": mesh.num_shards,
            "device": str(mesh.home), "backend": dist.get_backend(), "chi2": float(chi2),
            "accepted": int(n_acc), "iters": args.iters, "digest": digest, "wall_s": wall,
            "allreduce_ms_per_iter": comm_ms, "first_call_s": first_s,
            "first_call_captures": first_captures, "graph_captures": captures,
            "graph_replays": replays, "cuda_launches": launches, "eager_wall_s": eager_wall,
            "eager_cuda_launches": eager_launches,
            "eager_bitwise_equal": eager_digest == digest}), flush=True)
        if args.out and args.pid == 0:
            np.savez(args.out, pose_R=pose_R, pose_t=pose_t, points=points, chi2=float(chi2),
                     n_acc=int(n_acc), n_shards=mesh.num_shards)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
