#!/usr/bin/env python3
"""The LiDAR soak's two pose-graph backends (`backend_for_loop`,
`backend_for_gnss`) on the JAX package's 1,000-pose chain
(`eval/lidar_soak_jax.npz`, "slam"), solved by the port's damped
Gauss-Newton in float64 on the CPU: the answer that a float32 solve of the
same (6K, 6K) systems rounds away from. Prints, for each backend, how far
(largest sensor-centre distance, m) the JAX package's float32 result (the
npz's "backend_loop" / "backend_gnss") and the port's float32 result on
this machine's `--device` land from the float64 answer, and the condition
number of the free block of the first and the last step's damped normal
matrix (the pinned rows, the first pose's, left out).

    python3 scripts/lidar_backend_f64.py --root build/lidar_soak [--device cpu] \\
        [--write]    # --write: store the answers in the npz as *_f64 (float32)

`--root` is the `kitti_synth` sequence the chain was recorded on (its
ground truth gives the loop's relative pose and the anchors). The float64
solve of 20 steps of a 6,000-unknown dense system takes about a minute a
backend on 4 CPU cores; the eigenvalues as long again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def solve(chain_lw: np.ndarray, gt_l: np.ndarray, name: str, dtype, device: str,
          keep_systems: bool = False):
    """(result (K, 3, 4) float64 T_lw, [damped normal matrices of the first
    and last steps] with `keep_systems`) of one backend on `chain_lw`."""
    import torch

    from sqrtlm_slam_tpu_torch.eval import lidar_soak
    from sqrtlm_slam_tpu_torch.geometry import se3
    from sqrtlm_slam_tpu_torch.lidar import backend

    def pose(M):
        return se3.SE3(torch.as_tensor(M[:3, :3], dtype=dtype, device=device),
                       torch.as_tensor(M[:3, 3], dtype=dtype, device=device))

    chain = [pose(M) for M in chain_lw]
    last = len(chain) - 1
    if name == "loop":
        i = lidar_soak.JAX_RECORD["backends"]["loop"]["i"]
        T = lidar_soak.relative(gt_l, i, last)
        g = backend.build_chain_graph(chain, [(i, last, pose(T))])
    else:
        g = backend.build_chain_graph(chain, [], anchors=lidar_soak.gnss_anchors(gt_l, len(chain)))
    # build_chain_graph assembles on the host in float32, as both packages do;
    # the solve then runs in the chain's dtype from the same graph.
    g = g._replace(**{k: getattr(g, k).to(dtype) for k in
                      ("R", "t", "e_R", "e_t", "e_info", "a_pos", "a_info")})
    systems = []
    cholesky_ex = torch.linalg.cholesky_ex

    def kept(A, *a, **k):
        if keep_systems:
            systems.append(A.detach().cpu().numpy().astype(np.float64))
        return cholesky_ex(A, *a, **k)

    torch.linalg.cholesky_ex = kept
    try:
        out, _ = backend.optimize_se3_graph(g, num_iters=20)
    finally:
        torch.linalg.cholesky_ex = cholesky_ex
    res = np.concatenate([out.R.double().cpu().numpy(), out.t.double().cpu().numpy()[..., None]],
                         -1)
    return res, systems[:1] + systems[-1:]


def condition(H: np.ndarray) -> float:
    """2-norm condition number of the free block (rows whose diagonal is not
    the pin's 1 + mu with a zero row)."""
    off = np.abs(H).sum(1) - np.abs(np.diag(H))
    free = ~((off == 0) & np.isclose(np.diag(H), 1.0, rtol=0, atol=1e-5))
    w = np.linalg.eigvalsh(H[np.ix_(free, free)])
    return float(w[-1] / w[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="the kitti_synth sequence root")
    ap.add_argument("--device", default="cpu", help="the port's float32 solve's device")
    ap.add_argument("--write", action="store_true",
                    help="add the float64 answers to eval/lidar_soak_jax.npz")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from sqrtlm_slam_tpu_torch.eval import lidar_soak

    path = os.path.join(os.path.dirname(lidar_soak.__file__), "lidar_soak_jax.npz")
    data = dict(np.load(path))
    gt_l = lidar_soak.lidar_gt(args.root)
    report = dict(device=args.device, torch=torch.__version__, threads=torch.get_num_threads())
    for name in ("loop", "gnss"):
        ref, systems = solve(data["slam"], gt_l, name, torch.float64, "cpu", keep_systems=True)
        f32, _ = solve(data["slam"], gt_l, name, torch.float32, args.device)
        c64 = lidar_soak.chain_positions(ref)

        def dist(x):
            return float(np.abs(lidar_soak.chain_positions(x) - c64).max())

        report[name] = dict(
            jax_f32_from_f64_m=dist(data[f"backend_{name}"].astype(np.float64)),
            port_f32_from_f64_m=dist(f32),
            jax_from_port_f32_m=float(np.abs(lidar_soak.chain_positions(f32)
                                             - lidar_soak.chain_positions(
                                                 data[f"backend_{name}"].astype(np.float64))
                                             ).max()),
            f64_end_drift_m=lidar_soak.end_drift(ref, gt_l),
            condition_first_step=condition(systems[0]),
            condition_last_step=condition(systems[-1]),
            unknowns=int(systems[0].shape[0]))
        data[f"backend_{name}_f64"] = ref.astype(np.float32)
        print(name, json.dumps(report[name]), flush=True)
    if args.write:
        np.savez_compressed(path, **data)
    print("RESULT " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
