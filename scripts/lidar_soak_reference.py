#!/usr/bin/env python3
"""The LiDAR soak on the CPU, from either package: LiDAR-only odometry over a
`kitti_synth` sequence, counted by `eval/lidar_soak.py`'s `Recorder`. The
JAX package's record is the reference that `chip_smoke.py` phase 21 gates
the card's runs against (`eval/lidar_soak.py`'s `JAX_RECORD`).

    python -m sqrtlm_slam_tpu_torch.eval.kitti_synth --out build/lidar_soak \\
        --frames 1000 --workers 8 --centred-scans --scans-only   # ~1 min, 8 cores
    JAX_PLATFORMS=cpu python3 scripts/lidar_soak_reference.py --package jax \\
        --root build/lidar_soak --record build/lidar_jax.json --poses build/lidar_jax.npz
    python3 scripts/lidar_soak_reference.py --package port --root build/lidar_soak \\
        --record build/lidar_port.json --poses build/lidar_port.npz

Three runs, each printing `PROGRESS ...` every `--every` scans and then
`RESULT {...}` (the recorder's record):
  (a) `slam`: the package's runner, `run_kitti --mode lidar`, over the
      first `--scans` scans (default all), `record_pose` after every scan;
  (c) `backends`: on (a)'s chain, `backend_for_loop(j, last, T_ji)` (j the
      first-lap scan nearest the last one, T_ji their true relative pose)
      and `backend_for_gnss` with true positions every 100 scans, each
      from the recorded chain: the end drift before and after, the seconds;
  (b) `mapping` over the first lap (`--mapping-scans`, default the lap's
      length read off the ground truth), then `localization`: a fresh
      odometry with `set_prior_map` of every mapping keyframe's clouds over
      the scans of (a) from frame 0; the prior map's voxels against the
      capacity.
`--jitter-ulps K` scales (b)'s scans by 1 + K x 2^-23: a rounding-level
change of the input. `--record PATH` writes the three RESULT objects there, `--poses PATH.npz`
the poses of every scan of (a), (b) and the backends' chains (T_lw, 3x4).
The JAX package runs on the CPU only; the port takes `--device` (default
cpu) and, on the card, `--eager` (every run under `disable_graphs`: the
op-by-op functions, no captured graph).

With `--package jax` the script clears JAX's caches whenever the process
holds more than `--max-maps` memory maps, as `scripts/kitti_soak_reference.py`
does (mapping mode compiles the map's build at every keyframe: its input
grows); the runner's persistent compilation cache lies where
`SQRTLM_JAX_CACHE` says.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Package:
    """One package's LiDAR odometry classes and host conversions."""

    def __init__(self, name: str, device: str):
        self.name, self.device = name, device
        if name == "jax":
            os.environ["JAX_PLATFORMS"] = "cpu"
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_platforms", "cpu")
            import run_kitti
            from sqrtlm_slam_tpu.geometry import se3
            from sqrtlm_slam_tpu.lidar import odometry
            from sqrtlm_slam_tpu.utils import kitti_sequence_config

            self.jax = jax
            self.points = jnp.asarray
            self.host = lambda x: x if isinstance(x, (int, float)) else __import__(
                "numpy").asarray(x)
            self.se3 = lambda R, t: se3.SE3(jnp.asarray(R, jnp.float32),
                                            jnp.asarray(t, jnp.float32))
            self.make = lambda: odometry.LidarOdometry(odometry.OdomConfig(),
                                                       kitti_sequence_config("00").lidar)
        else:
            import torch

            from sqrtlm_slam_tpu_torch import run_kitti
            from sqrtlm_slam_tpu_torch.geometry import se3
            from sqrtlm_slam_tpu_torch.lidar import odometry
            from sqrtlm_slam_tpu_torch.utils.config import kitti_sequence_config

            self.points = lambda p: p
            self.host = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x
            self.se3 = lambda R, t: se3.SE3(
                torch.as_tensor(R, dtype=torch.float32, device=device),
                torch.as_tensor(t, dtype=torch.float32, device=device))
            self.make = lambda: odometry.LidarOdometry(
                feat_cfg=kitti_sequence_config("00").lidar, device=device)
        self.run_kitti, self.odometry = run_kitti, odometry

    def run_runner(self, argv: list) -> dict | None:
        """The package's runner in process; its JSON summary line."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if self.name == "jax":
                sys.argv = ["run_kitti.py"] + argv
                self.run_kitti.main()
            else:
                self.run_kitti.main(argv + ["--device", self.device])
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else None


def bound_maps(pkg: Package, max_maps: int, log):
    """With the JAX package: clear its caches before a scan whenever the
    process holds more than `max_maps` memory maps."""
    if pkg.name != "jax":
        return contextlib.nullcontext()
    cls = pkg.odometry.LidarOdometry
    process = cls.process

    def bounded(self, *a, **k):
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
        if n > max_maps:
            pkg.jax.clear_caches()
            gc.collect()
            with open("/proc/self/maps") as f:
                log(f"CLEARED jax caches: {n} -> {sum(1 for _ in f)} maps")
        return process(self, *a, **k)

    @contextlib.contextmanager
    def patched():
        cls.process = bounded
        try:
            yield
        finally:
            cls.process = process
    return patched()


def run_backends(pkg: Package, odo, gt_l, lidar_soak, log) -> tuple:
    """(c) on the recorded chain: (record, {name: (K, 3, 4) chain})."""
    import numpy as np

    recorded = list(odo._chain)
    last = len(recorded) - 1
    before = lidar_soak.chain_matrices(recorded, pkg.host)
    j = lidar_soak.loop_pair(gt_l, last)
    T = lidar_soak.relative(gt_l, j, last)
    anchors = lidar_soak.gnss_anchors(gt_l, len(recorded))
    out = dict(chain_length=len(recorded), end_drift_before_m=lidar_soak.end_drift(before, gt_l))
    chains = {"recorded": before}
    for name, call in (
            ("loop", lambda: odo.backend_for_loop(j, last, pkg.se3(T[:3, :3], T[:3, 3]))),
            ("gnss", lambda: odo.backend_for_gnss(anchors))):
        odo._chain = list(recorded)
        t0 = time.perf_counter()
        chain = call()
        got = lidar_soak.chain_matrices(chain, pkg.host)
        secs = time.perf_counter() - t0
        chains[name] = got
        drift = lidar_soak.end_drift(got, gt_l)
        out[name] = dict(end_drift_after_m=drift, seconds=secs,
                         moved_max_m=float(np.abs(lidar_soak.chain_positions(got)
                                                  - lidar_soak.chain_positions(before)).max()))
        log(f"BACKEND {name}: end drift {out['end_drift_before_m']:.4f} -> {drift:.4f} m "
            f"in {secs:.1f} s")
    out["loop"].update(i=j, j=last, T_ji=T[:3].tolist())
    out["gnss"].update(anchors=[k for k, _ in anchors],
                       anchors_used=[k for k, _ in anchors[:lidar_soak.A_CAP]])
    odo._chain = recorded
    return out, chains


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--root", required=True, help="a kitti_synth sequence root")
    ap.add_argument("--scans", type=int, default=0, help="0 = all")
    ap.add_argument("--mapping-scans", type=int, default=0,
                    help="scans of the mapping run (0 = the first lap)")
    ap.add_argument("--runs", default="slam,backends,mapping",
                    help="which of slam, backends (needs slam), mapping")
    ap.add_argument("--every", type=int, default=100, help="scans between progress lines")
    ap.add_argument("--jitter-ulps", type=int, default=0,
                    help="scale the mapping and localization runs' scans by 1 + K x 2^-23 "
                         "(about K units in the last place): how far rounding alone moves them")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--eager", action="store_true",
                    help="the port without captured graphs (disable_graphs)")
    ap.add_argument("--record", default=None, help="write the RESULT objects here")
    ap.add_argument("--poses", default=None, help="write the poses here (.npz)")
    ap.add_argument("--max-maps", type=int, default=40000,
                    help="clear JAX's caches above this many memory maps (jax only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np

    from sqrtlm_slam_tpu_torch.eval import lidar_soak

    pkg = Package(args.package, args.device)
    runs = args.runs.split(",")
    stdout = sys.stdout

    def log(msg):
        print(msg, file=stdout, flush=True)

    gt_l = lidar_soak.lidar_gt(args.root)
    n = min(args.scans or len(gt_l), len(gt_l))
    n1 = args.mapping_scans or lidar_soak.first_lap(gt_l)
    results, poses = {}, {}
    cls, mod = pkg.odometry.LidarOdometry, pkg.odometry
    scale = np.float32(1.0 + args.jitter_ulps * 2.0**-23)

    def points(i):
        p = lidar_soak.scan(args.root, i)
        return pkg.points(p * scale if args.jitter_ulps else p)

    def done(name, rec, **extra):
        res = dict(rec.result(), run=name, package=args.package, **extra)
        results[name] = res
        poses[name] = rec.poses_lw()
        log("RESULT " + json.dumps(res))

    t_all = time.time()
    eager = contextlib.nullcontext()
    if args.eager:
        from sqrtlm_slam_tpu_torch.utils import cache

        eager = cache.disable_graphs()
    with bound_maps(pkg, args.max_maps, log), eager:
        if "slam" in runs:
            out = os.path.join(args.root, f"traj_lidar_{args.package}.txt")
            with lidar_soak.Recorder(cls, mod, gt_l, pkg.host, every=args.every, log=log,
                                     record_chain=True) as rec:
                summary = pkg.run_runner(["--root", args.root, "--seq", "00", "--mode", "lidar",
                                          "--frames", str(n), "--out", out, "--json"])
            done("slam", rec, runner=summary,
                 scan_digest=lidar_soak.scan_digest(args.root, n))
            if "backends" in runs:
                res, chains = run_backends(pkg, rec.odo, gt_l, lidar_soak, log)
                results["backends"] = dict(res, run="backends", package=args.package)
                poses.update({f"backend_{k}": v for k, v in chains.items() if k != "recorded"})
                log("RESULT " + json.dumps(results["backends"]))
        if "mapping" in runs:
            odo = pkg.make()
            odo.mode = "mapping"
            with lidar_soak.Recorder(cls, mod, gt_l, pkg.host, every=args.every,
                                     log=log) as rec:
                for i in range(n1):
                    odo.process(points(i))
            done("mapping", rec)
            prior = lidar_soak.prior_map(odo, pkg.host)
            loc = pkg.make()
            t0 = time.perf_counter()
            loc.set_prior_map(**prior)
            prior_s = time.perf_counter() - t0
            voxels = lidar_soak.prior_map_voxels(prior, loc._local_map, loc.cfg, pkg.host)
            log(f"PRIOR MAP {voxels}")
            with lidar_soak.Recorder(cls, mod, gt_l, pkg.host, every=args.every,
                                     log=log) as rec:
                for i in range(n):
                    loc.process(points(i))
            done("localization", rec, prior_map=voxels, set_prior_map_s=prior_s,
                 mapping_scans=n1)
    log(f"TOTAL {time.time() - t_all:.0f} s")
    if args.record:
        with open(args.record, "w") as f:
            json.dump(results, f)
    if args.poses:
        np.savez_compressed(args.poses, **poses)
    return results


if __name__ == "__main__":
    main()
