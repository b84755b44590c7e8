#!/usr/bin/env python3
"""`run_long` of `eval/longrun.py` on the CPU, from either package, with the
trajectory's ATE so far at every progress line: the reference record that
`chip_smoke.py` phase 19 gates the card's long run against.

    JAX_PLATFORMS=cpu python3 scripts/longrun_reference.py --package jax \
        --max-landmarks 600000                         # hours on the CPU
    python3 scripts/longrun_reference.py --package port  # the port, on the CPU

At `run_long`'s defaults the store's 400,000 landmark rows run out near
frame 850 and the JAX package's `MapStore.add_landmark` asserts; the line
`CROSSED 400000 landmark rows at frame N` marks where, and a larger
`--max-landmarks` lets its run reach its end (the port reclaims dead rows
instead, which gives the bits of a run with room to spare). The last lines
are `RESULT {...}` (the summary, the crossing frame, GBAs completed /
aborted, loops rejected) and `PR {...}` (place recognition). CPU only: the
JAX package does not run on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROWS = 400000  # run_long's max_landmarks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--max-landmarks", type=int, default=ROWS)
    ap.add_argument("--every", type=int, default=25, help="frames between progress lines")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sqrtlm_slam_tpu.eval import longrun
        from sqrtlm_slam_tpu.eval.ate import ate_rmse
        from sqrtlm_slam_tpu.eval.synthetic import ring_trajectory
        from sqrtlm_slam_tpu.mapstore import store as store_mod
        from sqrtlm_slam_tpu.pipeline import system as system_mod
        kw = {}
    else:
        from sqrtlm_slam_tpu_torch.eval import longrun
        from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
        from sqrtlm_slam_tpu_torch.eval.synthetic import ring_trajectory
        from sqrtlm_slam_tpu_torch.mapstore import store as store_mod
        from sqrtlm_slam_tpu_torch.pipeline import system as system_mod
        kw = dict(device="cpu")

    poses = ring_trajectory(args.frames, radius=42.0, frac=2.3)
    seen, frame, crossed = {}, [0], {}
    track_depth, add_landmark = system_mod.SlamSystem.track_depth, store_mod.MapStore.add_landmark

    def counted_track_depth(self, *a, **k):
        seen["system"] = self
        frame[0] += 1
        return track_depth(self, *a, **k)

    def watched_add_landmark(self, *a, **k):
        if self.num_lm >= ROWS and "frame" not in crossed:
            crossed["frame"] = frame[0]
            print(f"CROSSED {ROWS} landmark rows at frame {frame[0]}", flush=True)
        return add_landmark(self, *a, **k)

    system_mod.SlamSystem.track_depth = counted_track_depth
    store_mod.MapStore.add_landmark = watched_add_landmark

    def gt(ids):
        out = []
        for f in ids:
            T = poses[int(f)]
            M = np.eye(4)
            M[:3, :3], M[:3, 3] = np.asarray(T.R), np.asarray(T.t)
            out.append(np.linalg.inv(M))
        return np.stack(out)

    def log(msg):
        s, extra = seen.get("system"), ""
        if s is not None and "DONE" not in msg:
            est = s.get_trajectory()
            ids = ([f for f, _, _, _ in s.tracker.trajectory] if args.package == "jax"
                   else list(s.trajectory_frame_ids()))[: len(est)]
            if len(est) > 2:
                extra = f" ate_so_far={ate_rmse(est, gt(ids))[0]:.3f} num_lm={s.store.num_lm}"
        print(msg + extra, time.strftime("%H:%M:%S"), flush=True)

    t = time.time()
    out, s = longrun.run_long(n_frames=args.frames, max_landmarks=args.max_landmarks,
                              progress_every=args.every, log=log, **kw)
    lc = s.loop_closer
    print("RESULT", json.dumps({
        "summary": out, "crossed": crossed,
        "gba": [getattr(lc, a, None) for a in ("num_gba_completed", "num_gba_aborted",
                                               "num_loops_rejected")],
        "total_s": time.time() - t}), flush=True)
    print("PR", json.dumps(longrun.evaluate_place_recognition(s, poses, log=lambda m: None)),
          flush=True)


if __name__ == "__main__":
    main()
