#!/usr/bin/env python3
"""The PCG's start in the long run's first global BAs, on the card.

    python3 scripts/longrun_pcg_start.py [--gbas 2]

Runs `eval.longrun.run_long` at its defaults (1,000 frames of the 42 m
ring) and, at each of the first `--gbas` global BAs
(`LoopCloser.run_global_ba`), prints one JSON line: the gathered problem's
size and largest landmark coordinate, then for each LM iteration the PCG
start (`schur_bucketed._pcg_run`): whether its stop test read done before
the first iteration, the float32 and float64 sums of squares of the
right-hand side, its largest entry, the stop limit and the iterations run.
The process ends after the last of those GBAs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbas", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("longrun_pcg_start: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from sqrtlm_slam_tpu_torch.eval import longrun
    from sqrtlm_slam_tpu_torch.loop import closing
    from sqrtlm_slam_tpu_torch.ops import build
    from sqrtlm_slam_tpu_torch.optim import schur_bucketed as sb

    build.load_all(("hamming", "ba_assembly"))
    starts = []
    pcg_run = sb._pcg_run

    def recorded_pcg_run(chunk, s, max_iters, check_every):
        r64 = s.r.double()
        rec = dict(done_at_start=bool(s.done), rr_f32=float(torch.sum(s.r * s.r)),
                   rr_f64=float(torch.sum(r64 * r64)), abs_max=float(s.r.abs().max()),
                   limit=float(s.limit))
        out = pcg_run(chunk, s, max_iters, check_every)
        starts.append(dict(rec, iterations=int(out.n)))
        return out

    sb._pcg_run = recorded_pcg_run
    run_global_ba = closing.LoopCloser.run_global_ba
    done = [0]

    def recorded_gba(self, *a, **k):
        p, _ = closing.gather_global_problem_bucketed(self.store, self.device)
        head = dict(keyframes=int(self.store.num_kf), poses=p.num_poses,
                    landmarks=p.num_points, max_abs_point_m=float(p.points.abs().max()))
        del p
        starts.clear()
        ok = run_global_ba(self, *a, **k)
        print(json.dumps(dict(head, written_back=ok, pcg_starts=list(starts))), flush=True)
        done[0] += 1
        if done[0] >= args.gbas:
            sys.stdout.flush()
            os._exit(0)
        return ok

    closing.LoopCloser.run_global_ba = recorded_gba
    longrun.run_long(n_frames=1000, device="cuda", log=lambda *a: None)


if __name__ == "__main__":
    main()
