#!/usr/bin/env python3
"""What a recapture of a per-loop program costs, with and without the
allocator's `empty_cache` that `utils/cache.py` makes when a `max_entries=1`
program drops its graph.

The program is the essential graph's Gauss-Newton step
(`essential_graph._gn_step_jit`), the per-loop program that a fusion soak
recaptures most often (once a correction, committed or vetoed). It is
recaptured at `--steps` growing keyframe counts (480, 488, ...: a soak's
loop corrections span ~450-550 keyframes), each through
`optimize_pose_graph` with `--iters` steps, first as the cache does it and
then with `torch.cuda.empty_cache` made a no-op. For each call: its ms (the
capture and the replays, between synchronizes) and `memory_reserved` as
the run holds it (no `empty_cache` of the script's own). Then
`empty_cache`'s own ms on an allocator holding the last call's cache.

    python3 scripts/recapture_cost.py [--steps 8] [--iters 30]

Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    from sqrtlm_slam_tpu_torch.eval import scale
    from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu_torch.geometry import sim3
    from sqrtlm_slam_tpu_torch.loop import closing, essential_graph

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    step = essential_graph._gn_step_jit
    mb = 1.0 / 2**20

    def graph_of(n_kf: int):
        """The essential graph of a loop from the last keyframe to the first,
        as `LoopCloser.correct_loop` builds it, on a drifted ring store."""
        store, _, _ = scale.make_scale_store(n_kf=n_kf, n_lm=4 * n_kf, obs_per_lm=5,
                                             drift=4e-4, radius=80.0 * n_kf / 600)
        lc = closing.LoopCloser(store, DEFAULT_CAM, device=dev)
        ones = np.ones(n_kf, np.float32)
        R, t = store.kf_R[:n_kf].copy(), store.kf_t[:n_kf].copy()
        S12 = sim3.Sim3(torch.tensor(1.0), torch.eye(3), torch.zeros(3))
        return lc._build_pose_graph(n_kf - 1, 0, S12, ones, R, t, ones.copy(), R.copy(),
                                    t.copy())

    sizes = [480 + 8 * i for i in range(args.steps)]
    graphs = [graph_of(k) for k in sizes]

    def run(emptying: bool) -> list:
        step._entries.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        real = torch.cuda.empty_cache
        if not emptying:
            torch.cuda.empty_cache = lambda: None
        try:
            calls = []
            for k, g in zip(sizes, graphs):
                captures = step.captures
                torch.cuda.synchronize()
                t = time.perf_counter()
                essential_graph.optimize_pose_graph(g, num_iters=args.iters)
                torch.cuda.synchronize()
                calls.append(dict(keyframes=k, ms=1e3 * (time.perf_counter() - t),
                                  captured=step.captures - captures,
                                  reserved_as_held_mb=torch.cuda.memory_reserved() * mb))
            return calls
        finally:
            torch.cuda.empty_cache = real

    run(True)  # kernels built, allocator warm
    with_emptying = run(True)
    without = run(False)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved() * mb
    t = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    empty_ms = 1e3 * (time.perf_counter() - t)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(program="loop.essential_graph._gn_step_jit", iters=args.iters,
               card=card.strip().splitlines()[0] if card.strip() else None,
               with_empty_cache=with_emptying, without_empty_cache=without,
               empty_cache_ms=empty_ms, empty_cache_released_mb=held - torch.cuda.memory_reserved() * mb,
               note="ms: optimize_pose_graph between synchronizes (a capture and iters - 1 "
                    "replays); memory as the run holds it")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
