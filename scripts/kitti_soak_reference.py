#!/usr/bin/env python3
"""The fusion soak on the CPU, from either package: `run_kitti --mode fusion
--loop` over a `kitti_synth` sequence, counted by `eval/kitti_soak.py`'s
`Recorder`. The JAX package's run is the reference record that
`chip_smoke.py` phase 20 gates the card's run against.

    python -m sqrtlm_slam_tpu_torch.eval.kitti_synth --out build/kitti_soak \\
        --frames 1000 --workers 8 --centred-scans     # ~3 min on 8 cores
    JAX_PLATFORMS=cpu python3 scripts/kitti_soak_reference.py --package jax \\
        --root build/kitti_soak                       # hours on the CPU
    python3 scripts/kitti_soak_reference.py --package port --root build/kitti_soak

Prints `PROGRESS ...` every `--every` frames (the ATE so far), `LOOP ...` at
every loop correction (committed or vetoed), and last `RESULT {...}` (the
recorder's record, the runner's own summary under `runner`, the sequence's
digest). `--record PATH` also writes the RESULT object there. The JAX
package runs on the CPU only; the port takes `--device` (default cpu; on
`cuda` the progress lines add the device memory the run holds).

XLA's CPU runtime maps three memory regions for every kernel it compiles,
and a process may hold 65,530 maps (`vm.max_map_count`): the JAX package's
run over this sequence compiles new shapes frame after frame and, past
frame ~200, failed with "LLVM compilation error: Cannot allocate memory"
and a segfault. With `--package jax` the script therefore clears JAX's
caches (`jax.clear_caches()`) whenever the process holds more than
`--max-maps` maps; the next call of a cleared program reloads it from
the persistent compilation cache that `run_kitti.py` enables, and the
results do not change (a line `CLEARED ...` says when).
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--root", required=True, help="a kitti_synth sequence root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--every", type=int, default=50, help="frames between progress lines")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--out", default=None, help="trajectory file (default under the root)")
    ap.add_argument("--record", default=None, help="also write the RESULT object here")
    ap.add_argument("--max-maps", type=int, default=40000,
                    help="clear JAX's caches above this many memory maps (jax only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from sqrtlm_slam_tpu_torch.eval import kitti_soak

    if args.package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        import run_kitti
        from sqrtlm_slam_tpu.eval.ate import ate_rmse
        from sqrtlm_slam_tpu.loop.closing import LoopCloser
        from sqrtlm_slam_tpu.pipeline.system import SlamSystem
        from sqrtlm_slam_tpu.pipeline.tracking import Tracker
    else:
        from sqrtlm_slam_tpu_torch import run_kitti
        from sqrtlm_slam_tpu_torch.eval.ate import ate_rmse
        from sqrtlm_slam_tpu_torch.loop.closing import LoopCloser
        from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem
        from sqrtlm_slam_tpu_torch.pipeline.tracking import Tracker

    out = args.out or os.path.join(args.root, f"traj_{args.package}.txt")
    argv_run = ["--root", args.root, "--seq", args.seq, "--mode", "fusion", "--loop",
                "--frames", str(args.frames), "--out", out, "--json"]
    argv_run += ["--pipelined"] * args.pipelined + ["--async-mapping"] * args.async_mapping
    stdout = sys.stdout

    def log(msg):
        if args.package == "port" and args.device.startswith("cuda") and msg.startswith("PROG"):
            import torch

            msg += f" reserved_mb={torch.cuda.memory_reserved() / 2**20:.0f}"  # as held
        print(msg, file=stdout, flush=True)

    if args.package == "jax":
        track_fusion = SlamSystem.track_fusion

        def bounded_maps(self, *a, **k):
            with open("/proc/self/maps") as f:
                n = sum(1 for _ in f)
            if n > args.max_maps:
                jax.clear_caches()
                gc.collect()
                with open("/proc/self/maps") as f:
                    log(f"CLEARED jax caches before frame {self.tracker.frame_idx + 1}: "
                        f"{n} -> {sum(1 for _ in f)} maps")
            return track_fusion(self, *a, **k)
        SlamSystem.track_fusion = bounded_maps

    gt = kitti_soak.read_gt(args.root, args.seq)
    buf = io.StringIO()
    t = time.time()
    with kitti_soak.Recorder(SlamSystem, Tracker, LoopCloser, gt, ate_rmse, every=args.every,
                             log=log) as rec, contextlib.redirect_stdout(buf):
        if args.package == "jax":
            sys.argv = ["run_kitti.py"] + argv_run
            run_kitti.main()
        else:
            run_kitti.main(argv_run + ["--device", args.device])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    res = dict(rec.result(), package=args.package, args=argv_run,
               runner=json.loads(lines[-1]) if lines else None, total_s=time.time() - t,
               sequence_digest=kitti_soak.digest(args.root, args.seq, rec.result()["frames"]))
    print("RESULT", json.dumps(res), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
