#!/usr/bin/env python3
"""How often the port's distributed BA at 1, 2 and 4 shards passes the
shard-count bars of two CPU tests when its inputs are rescaled by
1 + k 2^-23 (a rounding-level change), for one tree of the repository.

    JAX_PLATFORMS=cpu python3 scripts/shard_agreement_draws.py [--root DIR] [--ks=-4..4]

The two tests and their bars (their problems, 6 LM iterations):
  * `tests/test_torch_dist_ba.py::test_shard_counts_agree_and_one_shard_is_
    the_single_device_loop` (P=6, L=64, every pose sees every landmark):
    2 and 4 shards accept as many LM iterations as 1 shard;
  * `tests/test_torch_wide_k.py::test_distributed_lm_at_wide_k` (seed 13,
    P=48, L=192, 24 slots a landmark): the same accepted count, pose_t
    within 1e-4 and the landmarks seen twice within 1e-3 of 1 shard's.
Each k rescales the problem's pose translations and points. Prints one
JSON line per k and test, then the count of draws that pass. Both trees'
counts side by side say whether a bar holds by its margin or by the draw.
The problems come from the JAX package's test helpers (JAX on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ks", default="-4..4")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    lo, hi = (int(x) for x in args.ks.split(".."))

    import jax
    import numpy as np
    import torch

    torch.set_num_threads(2)
    import tests.test_torch_wide_k as wide
    from sqrtlm_slam_tpu.optim import schur_bucketed as j_sb
    from sqrtlm_slam_tpu_torch import convert
    from sqrtlm_slam_tpu_torch.parallel import dist_ba
    from tests.test_schur_ba import CAM as J_CAM
    from tests.test_schur_ba import make_ba_scene

    scene = make_ba_scene(jax.random.PRNGKey(77), P=6, L=64, noise=0.4)[0]
    tp = wide._problems(13, 48, 192, 24)[1]
    cases = {"dist_ba": (convert.ba_problem(j_sb.from_flat(scene, K=6)),
                         convert.camera(J_CAM), None),
             "wide_k": (tp, wide.CAM, wide._seen_twice(tp))}
    passed = {name: 0 for name in cases}
    for k in range(lo, hi + 1):
        f = 1.0 + k * 2.0 ** -23
        for name, (p0, cam, seen) in cases.items():
            p = p0._replace(points=p0.points * f, pose_t=p0.pose_t * f)
            res = {D: dist_ba.distributed_ba_lm(p, cam, dist_ba.make_mesh(D, "cpu"), num_iters=6)
                   for D in (1, 2, 4)}
            acc = [int(res[D][2]) for D in (1, 2, 4)]
            ok = len(set(acc)) == 1
            row = dict(test=name, k=k, accepted=acc)
            if seen is not None:
                dt = [float(np.abs(res[D][0].pose_t.numpy() - res[1][0].pose_t.numpy()).max())
                      for D in (2, 4)]
                dp = [float(np.abs(res[D][0].points.numpy()[seen]
                                   - res[1][0].points.numpy()[seen]).max()) for D in (2, 4)]
                ok = ok and max(dt) <= 1e-4 and max(dp) <= 1e-3
                row.update(pose_t_diff=dt, points_diff=dp)
            passed[name] += ok
            print(json.dumps(dict(row, passes=ok)), flush=True)
    print(json.dumps(dict(root=root, draws=hi - lo + 1, passes=passed)), flush=True)


if __name__ == "__main__":
    main()
