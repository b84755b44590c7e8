#!/usr/bin/env python3
"""The loop correction at KITTI 00's scale on the CPU, from either package:
`benchmarks/bench_scale.py`'s flow (`sqrtlm_slam_tpu_torch/eval/scale_kitti00.py`,
`FLOW`), the ATE after each stage, chi2 before and after global BA.

    JAX_PLATFORMS=cpu python3 scripts/scale_reference.py --package jax \\
        --record sqrtlm_slam_tpu_torch/eval/scale_kitti00_jax.json   # ~15 min
    python3 scripts/scale_reference.py --package port --threads 4      # ~4 min

Prints `RESULT {...}` last: sizes, `ate_drift_m`, `ate_after_loop_m`,
`ate_after_gba_m`, `chi2_before`, `chi2_after`, `edges` (observations),
`essential_graph_edges`, `gba_completed`, the seconds of each stage, the
host's CPU and threads. Every ATE is the port's `eval/scale.py::store_ate`
(numpy, float64) for either package, the one `chip_smoke.py` reads: the
JAX package's own aligns in float32 (`package_ate_drift_m`, its drift
ATE). `--record PATH` writes the result there as JSON (the JAX run's is
the record `chip_smoke.py` phase 22 gates the card against).

Options for telling a fault of the port from float32 rounding:
  --float64            the essential graph in float64 (the problem built in
                       float32 as always, then cast; the JAX package under
                       `jax_enable_x64`); global BA is skipped;
  --eg-checkpoints N,M the ATE after N, M, ... Gauss-Newton steps (each
                       continuing from the last), e.g. 30,100;
  --jitter-ulps K      the store's keyframe translations and landmark
                       positions scaled by 1 + K x 2^-23: a rounding-level
                       change of the input;
  --threads N          torch's CPU threads (the port), OpenBLAS's under the
                       JAX package's LAPACK calls;
  --device cuda        the port on the card (graphed, as its entry points
                       run; TF32 off, as `chip_smoke.py` runs);
  --dump PATH.npz      the pose graph as built, the poses after its first
                       Gauss-Newton step and after the flow's steps;
  --merge-draws RECORD DRAW...
                       append other runs' results (`--record` files of the
                       same configuration) to RECORD: float32 runs to
                       `float32_draws` (`scale_kitti00.tolerances` gates
                       within their spread), `--float64` runs to
                       `float64_runs` (`scale_kitti00.float64_answer`);
  --compare A B        two dumps: the largest differences of the problems'
                       arrays (float32 rows also in units in the last
                       place of the row's largest entry) and of the poses after one step and after
                       the flow's steps (prints `COMPARE {...}`).

`--lms 60000 --gba-iters 2` is the smaller configuration of the first
comparison (PERF.md section 7).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sqrtlm_slam_tpu_torch.eval.scale import store_ate  # noqa: E402
from sqrtlm_slam_tpu_torch.eval import scale_kitti00  # noqa: E402
from sqrtlm_slam_tpu_torch.eval.scale_kitti00 import FLOW, pose_graph_of_loop  # noqa: E402

PROBLEM_FIELDS = ("s", "R", "t", "fixed", "valid", "e_i", "e_j", "e_s", "e_R", "e_t",
                  "e_valid")


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


class Package:
    """One package's scale store, loop closer, essential graph and GBA
    problem, with host conversions."""

    def __init__(self, name: str, threads: int | None, device: str = "cpu"):
        self.name = name
        if name == "jax":
            os.environ["JAX_PLATFORMS"] = "cpu"
            if threads:  # the LAPACK under jax.scipy's Cholesky (scipy's OpenBLAS)
                os.environ["OPENBLAS_NUM_THREADS"] = str(threads)
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_platforms", "cpu")
            from sqrtlm_slam_tpu.eval import scale
            from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM
            from sqrtlm_slam_tpu.geometry import sim3
            from sqrtlm_slam_tpu.loop import closing, essential_graph
            from sqrtlm_slam_tpu.optim import schur_bucketed

            self.jax, self.jnp = jax, jnp
            self.cam = DEFAULT_CAM
            self.sim3 = lambda R, t: sim3.Sim3(jnp.asarray(1.0), jnp.asarray(R), jnp.asarray(t))
            self.closer = lambda store, cfg: closing.LoopCloser(store, DEFAULT_CAM, cfg=cfg)
            self.gather = lambda store: closing.gather_global_problem_bucketed(store)[0]
            self.host = np.asarray
        else:
            import torch

            if threads:
                torch.set_num_threads(threads)
            torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
            from sqrtlm_slam_tpu_torch.eval import scale
            from sqrtlm_slam_tpu_torch.eval.synthetic import DEFAULT_CAM
            from sqrtlm_slam_tpu_torch.geometry import sim3
            from sqrtlm_slam_tpu_torch.loop import closing, essential_graph
            from sqrtlm_slam_tpu_torch.optim import schur_bucketed

            self.torch = torch
            self.cam = DEFAULT_CAM
            self.sim3 = lambda R, t: sim3.Sim3(torch.tensor(1.0), torch.as_tensor(R),
                                               torch.as_tensor(t))
            self.closer = lambda store, cfg: closing.LoopCloser(store, DEFAULT_CAM, cfg=cfg,
                                                                device=device)
            self.gather = lambda store: closing.gather_global_problem_bucketed(store, device)[0]
            self.host = lambda x: x.detach().cpu().numpy()
        self.scale, self.closing, self.eg, self.sb = scale, closing, essential_graph, \
            schur_bucketed

    def to_float64(self, problem):
        """The problem's floating arrays in float64."""
        if self.name == "jax":
            self.jax.config.update("jax_enable_x64", True)
            jnp = self.jnp
            return problem._replace(**{
                f: jnp.asarray(np.asarray(getattr(problem, f), np.float64))
                for f in PROBLEM_FIELDS if np.asarray(getattr(problem, f)).dtype == np.float32})
        return problem._replace(**{f: getattr(problem, f).double() for f in PROBLEM_FIELDS
                                   if getattr(problem, f).is_floating_point()})

    def optimize(self, problem, n: int):
        out, chi2 = self.eg.optimize_pose_graph(problem, num_iters=n)
        return out, float(chi2)

    def chi2(self, store) -> float:
        p = self.gather(store)
        return float(self.sb.chi2_only(p, self.cam, p.obs_valid, None))

    def problem_arrays(self, problem) -> dict:
        return {f: self.host(getattr(problem, f)) for f in PROBLEM_FIELDS}


def poses_ate(pkg: Package, out, true_R, true_t) -> float:
    return scale_kitti00.poses_ate(*(pkg.host(x) for x in (out.s, out.R, out.t)), true_R,
                                   true_t)


def pose_arrays(pkg: Package, out) -> dict:
    return {k: np.asarray(pkg.host(getattr(out, k)), np.float64) for k in ("s", "R", "t")}


def log(msg: str) -> None:
    print(f"[scale] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def run(args) -> dict:
    pkg = Package(args.package, args.threads, args.device)
    res = dict(package=args.package, device=args.device, kfs=FLOW["kfs"], landmarks=args.lms,
               obs_per_lm=FLOW["obs_per_lm"], drift=FLOW["drift"], edge_cap=FLOW["edge_cap"],
               eg_iters=FLOW["eg_iters"], gba_iters=args.gba_iters, gba_chunk=args.gba_iters,
               float64_essential_graph=args.float64, jitter_ulps=args.jitter_ulps,
               threads=args.threads, cpu=cpu_name(), cpu_count=os.cpu_count())
    if args.device != "cpu":
        import torch

        res["card"] = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    store, true_R, true_t = pkg.scale.make_scale_store(
        n_kf=FLOW["kfs"], n_lm=args.lms, obs_per_lm=FLOW["obs_per_lm"], drift=FLOW["drift"])
    if args.jitter_ulps:
        f = np.float32(1.0 + args.jitter_ulps * 2.0**-23)
        store.kf_t[:] = store.kf_t * f
        store.lm_pos[:] = store.lm_pos * f
    res["store_build_s"] = time.perf_counter() - t0
    res["ate_drift_m"] = store_ate(store, true_R, true_t)
    res["package_ate_drift_m"] = float(pkg.scale.store_ate(store, true_R, true_t))
    cfg = pkg.closing.LoopClosingConfig(edge_cap=FLOW["edge_cap"], gba_iters=args.gba_iters,
                                        gba_chunk=max(args.gba_iters, 1))
    lc = pkg.closer(store, cfg)
    K = store.num_kf
    t0 = time.perf_counter()
    problem = pose_graph_of_loop(lc, true_R, true_t, pkg.sim3)
    res["essential_graph_build_s"] = time.perf_counter() - t0
    res["essential_graph_edges"] = int(np.asarray(pkg.host(problem.e_valid)).sum())
    dump = {}
    if args.dump:
        dump.update({f"problem_{k}": v for k, v in pkg.problem_arrays(problem).items()})
    if args.float64:
        problem = pkg.to_float64(problem)
    if args.dump:
        one, _ = pkg.optimize(problem, 1)
        dump.update({f"step1_{k}": v for k, v in pose_arrays(pkg, one).items()})
    checkpoints = sorted(set(args.eg_checkpoints) | {FLOW["eg_iters"]})
    t0 = time.perf_counter()
    out, done, ate_at, flow_out = problem, 0, {}, None
    for n in checkpoints:
        out, chi2 = pkg.optimize(out, n - done)
        done = n
        ate_at[n] = poses_ate(pkg, out, true_R, true_t)
        log(f"essential graph: {n} steps, ATE {ate_at[n]}")
        if n == FLOW["eg_iters"]:
            flow_out, res["essential_graph_chi2"] = out, chi2
            res["essential_graph_opt_s"] = time.perf_counter() - t0
    res["ate_m_after_steps"] = {str(n): a for n, a in ate_at.items()}
    if args.dump:
        dump.update({f"flow_{k}": v for k, v in pose_arrays(pkg, flow_out).items()})
        np.savez_compressed(args.dump, **dump)
    lc._apply_pose_graph(flow_out, K)
    res["ate_after_loop_m"] = store_ate(store, true_R, true_t)
    if args.gba_iters and not args.float64:
        t0 = time.perf_counter()
        p0 = pkg.gather(store)
        res["edges"] = int(np.asarray(pkg.host(p0.obs_valid)).sum())
        res["chi2_before"] = float(pkg.sb.chi2_only(p0, pkg.cam, p0.obs_valid, None))
        del p0
        res["gather_and_chi2_s"] = time.perf_counter() - t0
        log(f"chi2 before GBA {res['chi2_before']}")
        t0 = time.perf_counter()
        res["gba_completed"] = bool(lc.run_global_ba())
        res["gba_s"] = time.perf_counter() - t0
        res["chi2_after"] = pkg.chi2(store)
        res["ate_after_gba_m"] = store_ate(store, true_R, true_t)
        if args.package == "jax":
            res["gba_s_note"] = "the first call: XLA's compile included"
    return res


def compare(a_path: str, b_path: str) -> dict:
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for k in a.files:
        x, y = a[k], b[k]
        if x.shape != y.shape:
            out[k] = f"shapes {x.shape} {y.shape}"
        elif x.dtype == bool or np.issubdtype(x.dtype, np.integer):
            out[k] = int((x != y).sum())  # entries that differ
        else:
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            out[k] = float(d.max())
            if x.dtype == np.float32 and y.dtype == np.float32 and x.ndim > 1:
                # In float32 ulps of the largest entry of the same row (an
                # edge's rotation or translation).
                m = np.maximum(np.abs(x), np.abs(y)).reshape(len(x), -1).max(1)
                ulp = np.spacing(m).astype(np.float64).reshape((-1,) + (1,) * (x.ndim - 1))
                out[k + "_ulps"] = float((d / ulp).max())
    return out


DRAW_KEYS = ("package", "device", "threads", "jitter_ulps", "ate_drift_m", "ate_after_loop_m",
             "ate_after_gba_m", "chi2_before", "chi2_after", "gba_completed")


def merge_draws(record_path: str, draw_paths: list) -> dict:
    """Append each draw's stages (another float32 run of the flow, written
    by `--record`) to the record's `float32_draws`, from which
    `scale_kitti00.tolerances` takes the spread. Draws of another
    configuration are refused."""
    with open(record_path) as f:
        record = json.load(f)
    draws = record.setdefault("float32_draws", [])
    f64 = record.setdefault("float64_runs", [])
    for path in draw_paths:
        with open(path) as f:
            d = json.load(f)
        # A float64 run solves the essential graph alone: the same graph
        # (keyframes, edges, steps) at any landmark count whose covisibility
        # weights pass `covis_edge_weight` (the store's poses do not depend
        # on the landmarks).
        same = ("kfs", "obs_per_lm", "eg_iters", "essential_graph_edges")
        if not d.get("float64_essential_graph"):
            same += ("landmarks", "gba_iters", "edges")
        for k in same:
            if d.get(k) != record.get(k):
                raise ValueError(f"{path}: {k} {d.get(k)} != the record's {record.get(k)}")
        if d.get("float64_essential_graph"):
            f64.append({k: d.get(k, "cpu" if k == "device" else None)
                        for k in ("package", "device", "landmarks", "ate_m_after_steps")})
        else:
            draws.append({k: d.get(k, "cpu" if k == "device" else None) for k in DRAW_KEYS})
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"))
    ap.add_argument("--lms", type=int, default=FLOW["lms"])
    ap.add_argument("--gba-iters", type=int, default=FLOW["gba_iters"])
    ap.add_argument("--eg-checkpoints", type=lambda s: [int(x) for x in s.split(",") if x],
                    default=[])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--jitter-ulps", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--record", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--merge-draws", nargs="+", default=None, metavar=("RECORD", "DRAW"))
    args = ap.parse_args(argv)
    if args.merge_draws:
        rec = merge_draws(args.merge_draws[0], args.merge_draws[1:])
        print("DRAWS " + json.dumps(rec["float32_draws"]), flush=True)
        return rec
    if args.compare:
        res = compare(*args.compare)
        print("COMPARE " + json.dumps(res), flush=True)
        return res
    if not args.package:
        ap.error("--package is required unless --compare is given")
    if args.package == "jax" and args.device != "cpu":
        ap.error("the JAX package runs on the CPU only")
    t0 = time.perf_counter()
    res = run(args)
    res["wall_s"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(res), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(res, f, indent=1)
            f.write("\n")
    return res


if __name__ == "__main__":
    main()
