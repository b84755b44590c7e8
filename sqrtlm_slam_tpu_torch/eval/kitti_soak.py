"""The fusion soak: a KITTI runner's `--mode fusion --loop` over the
`kitti_synth` sequence (1,000 frames of the street circuit at 1226x370,
2.09 laps), counted as it runs, and the gates that hold one run against
another.

`Recorder` wraps a SlamSystem class's `track_fusion`, its Tracker's
`_relocalize` and its LoopCloser's `correct_loop` / `run_global_ba` for the
length of a run. It takes the classes as arguments, so one recorder counts
the port's runner and the JAX package's alike (`scripts/kitti_soak_reference.py`
drives either on the CPU; `chip_smoke.py` phase 20 drives the port on the
card). Every `every` frames it logs a progress line with the ATE so far;
`result()` gives the record the gates read:

    frames, tracked, lost_frames, keyframes (alive), keyframes_created,
    landmarks (alive), landmarks_created, loops_closed, loops_vetoed,
    loop_events [(frame, committed, veto)], first_loop_frame,
    relocalisations {attempts, successes}, gba {completed, aborted, runs},
    ate_rmse_m, ate_m_of_first {100, 200, 300, 500}, peak_rss_mb, wall_s,
    progress [`reading()` every `every` frames: the counts and ATEs then].

Imports neither JAX nor torch: it only wraps methods and reads numpy.
"""

from __future__ import annotations

import os
import time

import numpy as np

from . import soak
from .soak import peak_rss_mb

PREFIXES = (100, 200, 300, 500)
LOST = 2  # TrackState.LOST in both packages

# The gates on a run against the reference run of the same files (PERF.md
# section 2). Tracked frames >= 0.9 x. Keyframes and landmarks created
# within 5 %: the port and the JAX package on the CPU differed by up to
# 2.3 % and 5.0 % over the first 150 frames of the fusion soak. Loops
# closed at least the reference's, unless the run's log explains the
# difference. The ATE of each prefix within PREFIX_ATE_FACTOR x the
# reference's, read before either run's first loop: the trajectory is
# chaotic in the rounding of its sums. The port on one CPU at 1 and at 2
# threads differs by 1.3e-4 m within 16 frames; at 2 and at 6 threads its
# ATE over the first 100 frames is 0.1305 and 0.2859 m, and the JAX
# package's 0.1072 m. The factor is the largest ratio of a CPU run of the
# port to the JAX run at a prefix, 0.2859 / 0.1072 (the prefixes of 200
# and 300 frames gave less; that run was stopped at its frame 400, before
# the 500th). A loop correction re-draws the prefixes
# (the port on the card closed its first loop in sync mode and in
# `--pipelined --async-mapping` and the first 100 frames then read 2.17
# and 0.113 m): after it they are not gated.
PREFIX_ATE_FACTOR = 2.667
GATES = dict(tracked_frac=0.9, keyframes_tol=0.05, landmarks_tol=0.05,
             prefix_ate_factor=PREFIX_ATE_FACTOR)


def read_gt(root: str, seq: str = "00") -> np.ndarray:
    """(F, 4, 4) camera-to-world ground truth from `<root>/poses/<seq>.txt`."""
    rows = np.loadtxt(os.path.join(root, "poses", seq + ".txt"), ndmin=2)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows.reshape(-1, 3, 4)
    return out


def digest(root: str, seq: str = "00", frames: int | None = None) -> str:
    """sha256 over the sequence's calib.txt and its first `frames` poses,
    PNGs and scans: equal digests, the same input bytes on two machines
    (a sequence written longer has the same digest over its prefix)."""
    import hashlib

    seq_dir = os.path.join(root, "sequences", seq)
    names = sorted(os.listdir(os.path.join(seq_dir, "image_0")))[:frames]
    h = hashlib.sha256()
    with open(os.path.join(root, "poses", seq + ".txt"), "rb") as f:
        h.update(b"".join(f.readlines()[: len(names)]))
    paths = [os.path.join(seq_dir, "calib.txt")]
    for n in names:
        stem = n.rsplit(".", 1)[0]
        paths += [os.path.join(seq_dir, "image_0", n),
                  os.path.join(seq_dir, "velodyne", stem + ".bin")]
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


class Recorder(soak.Recorder):
    """Counts a fusion run while it is inside the `with` block; see the
    module docstring. `ate_rmse(est, gt) -> (rmse, aligned)` is the
    package's own; `log(str)` takes the progress lines."""

    def __init__(self, system_cls, tracker_cls, closer_cls, gt: np.ndarray, ate_rmse,
                 every: int = 50, log=print):
        super().__init__(every, log)
        self.classes = (system_cls, tracker_cls, closer_cls)
        self.gt, self.ate_rmse = gt, ate_rmse
        self.frames = []  # per frame: tracked, keyframe, lost
        self.loops = []  # (frame, committed, veto)
        self.relocs = []  # (frame, relocalised)
        self.gba = []  # (frame, written back)
        self.system = None

    # -- the wrapped methods ---------------------------------------------

    def install(self):
        system_cls, tracker_cls, closer_cls = self.classes
        rec = self

        def track_fusion(fn):
            def call(self, *a, **k):
                rec.system = self
                kf0 = self.store.num_kf
                out = fn(self, *a, **k)
                rec.frames.append(dict(tracked=out is not None,
                                       keyframe=self.store.num_kf > kf0,
                                       lost=int(self.tracker.state) == LOST))
                rec.tick(len(rec.frames))
                return out
            return call

        def relocalize(fn):
            def call(self, *a, **k):
                ok = fn(self, *a, **k)
                rec.relocs.append((len(rec.frames), bool(ok)))
                return ok
            return call

        def correct_loop(fn):
            def call(self, *a, **k):
                ok = fn(self, *a, **k)
                veto = None if ok else self.last_loop_veto
                rec.loops.append((len(rec.frames), bool(ok), repr(veto) if veto else None))
                rec.log(f"LOOP frame={len(rec.frames)} committed={bool(ok)} veto={veto!r}")
                return ok
            return call

        def run_global_ba(fn):
            def call(self, *a, **k):
                ok = fn(self, *a, **k)
                rec.gba.append((len(rec.frames), bool(ok)))
                return ok
            return call

        self.patch(system_cls, "track_fusion", track_fusion)
        self.patch(tracker_cls, "_relocalize", relocalize)
        self.patch(closer_cls, "correct_loop", correct_loop)
        self.patch(closer_cls, "run_global_ba", run_global_ba)

    # -- readings ----------------------------------------------------------

    def trajectory(self):
        """(estimated (M, 4, 4), their frame ids (M,)) of the system now."""
        s = self.system
        est = np.asarray(s.get_trajectory())
        ids = np.asarray(s.trajectory_frame_ids())[: len(est)]
        return est[: len(ids)], ids

    def ate(self, est, ids, below=None) -> float | None:
        sel = ids < below if below is not None else np.ones(len(ids), bool)
        if sel.sum() < 3:
            return None
        return float(self.ate_rmse(est[sel], self.gt[ids[sel]], align_scale=False)[0])

    def reading(self) -> dict:
        """The run so far: the counts the gates read, and the ATE of the
        trajectory as it stands (whole and of each prefix), so a shorter
        run can be held against this one at its own length."""
        s = self.system
        est, ids = self.trajectory()
        return dict(
            frame=len(self.frames), tracked=int(sum(f["tracked"] for f in self.frames)),
            keyframes=int(s.num_keyframes()), keyframes_created=int(s.store.num_kf),
            landmarks=int(s.num_landmarks()),
            landmarks_created=int(s.store.num_lm) + int(getattr(s, "landmarks_reclaimed", 0)),
            loops_closed=int(sum(c for _, c, _ in self.loops)),
            loops_vetoed=int(sum(not c for _, c, _ in self.loops)),
            ate_rmse_m=self.ate(est, ids),
            ate_m_of_first={k: self.ate(est, ids, k) for k in PREFIXES
                            if len(self.frames) >= k},
            rss_mb=peak_rss_mb(), elapsed_s=self.elapsed_s())

    def progress_line(self, r: dict) -> str:
        ate = "nan" if r["ate_rmse_m"] is None else f"{r['ate_rmse_m']:.4f}"
        return (f"PROGRESS frame={r['frame']} tracked={r['tracked']} "
                f"keyframes={r['keyframes']} kf_created={r['keyframes_created']} "
                f"landmarks={r['landmarks']} lm_created={r['landmarks_created']} "
                f"loops={r['loops_closed']} vetoed={r['loops_vetoed']} ate_so_far={ate} "
                f"prefix_ate={ {k: round(v, 4) for k, v in r['ate_m_of_first'].items()} } "
                f"rss_mb={r['rss_mb']:.0f} elapsed_s={r['elapsed_s']:.0f} "
                f"{time.strftime('%H:%M:%S')}")

    def result(self) -> dict:
        s = self.system
        est, ids = self.trajectory()
        committed = [f for f, c, _ in self.loops if c]
        closer = s.loop_closer
        return dict(
            frames=len(self.frames),
            tracked=int(sum(f["tracked"] for f in self.frames)),
            lost_frames=int(sum(f["lost"] for f in self.frames)),
            keyframes=int(s.num_keyframes()),
            keyframes_created=int(s.store.num_kf),
            keyframe_frames=int(sum(f["keyframe"] for f in self.frames)),
            landmarks=int(s.num_landmarks()),
            landmarks_created=int(s.store.num_lm) + int(getattr(s, "landmarks_reclaimed", 0)),
            loops_closed=int(closer.num_loops_closed) if closer is not None else 0,
            loops_vetoed=int(closer.num_loops_rejected) if closer is not None else 0,
            loop_events=self.loops,
            first_loop_frame=committed[0] if committed else None,
            relocalisations=dict(attempts=len(self.relocs),
                                 successes=int(sum(ok for _, ok in self.relocs)),
                                 frames=[f for f, ok in self.relocs if ok]),
            gba=dict(completed=int(getattr(closer, "num_gba_completed", 0)),
                     aborted=int(getattr(closer, "num_gba_aborted", 0)),
                     runs=self.gba),
            ate_rmse_m=self.ate(est, ids),
            ate_m_of_first={k: self.ate(est, ids, k) for k in PREFIXES
                            if len(self.frames) >= k},
            peak_rss_mb=peak_rss_mb(),
            wall_s=getattr(self, "wall_s", None),
            progress=self.progress)


def gates(result: dict, ref: dict, margins: dict = GATES, loops_explained: str = "",
          ates_at=None) -> list:
    """What fails in `result` against the reference run `ref` (two `result()`
    records of the same files, or readings at the same depth); empty when
    every gate holds. The prefix ATEs are compared where both runs cover
    the prefix, in `ates_at` = (the run's reading, the reference's) at
    another depth (one before either run's first loop) where given.
    `loops_explained`: the reason, from the run's log, why fewer loops
    closed than in `ref` (no reason: fewer loops fail)."""
    bad = []
    if result["tracked"] < margins["tracked_frac"] * ref["tracked"]:
        bad.append(f"tracked {result['tracked']} < {margins['tracked_frac']} x "
                   f"{ref['tracked']}")
    for key, tol in (("keyframes_created", margins["keyframes_tol"]),
                     ("landmarks_created", margins["landmarks_tol"])):
        if not abs(result[key] - ref[key]) <= tol * ref[key]:
            bad.append(f"{key} {result[key]} not within {tol:.0%} of the reference's "
                       f"{ref[key]}")
    run_at, ref_at = ates_at if ates_at is not None else (result, ref)
    ates = {int(k): v for k, v in run_at["ate_m_of_first"].items()}  # JSON keys are text
    for k, r in ref_at["ate_m_of_first"].items():
        got = ates.get(int(k))
        if r is None or got is None and run_at["frames"] < int(k):
            continue
        if not (got is not None and got <= margins["prefix_ate_factor"] * r):
            bad.append(f"ATE of the first {k} frames {got} m > "
                       f"{margins['prefix_ate_factor']} x the reference's {r} m")
    if result["loops_closed"] < ref["loops_closed"] and not loops_explained:
        bad.append(f"{result['loops_closed']} loops closed < the reference's "
                   f"{ref['loops_closed']}")
    return bad


def at_depth(record: dict, frames: int) -> dict:
    """A whole run's record cut to its reading at `frames` (a multiple of
    its progress interval): what a run of that depth is held against.
    Raises ValueError where the record holds no reading there."""
    return soak.at_depth(record, frames, "frames", "frame")


def main(argv=None):
    """python -m sqrtlm_slam_tpu_torch.eval.kitti_soak RUN.json REFERENCE.json
    [--ates-at N]: the gates on a run's record (the soak script's RESULT
    object, or the `outcome` of chip_smoke.py phase 20's `kitti_soak` line)
    against the reference's at the run's depth, the prefix ATEs at frame N
    (both records' progress readings there: the script's RESULT holds
    them); prints each failure, exits 1 on any."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("run")
    ap.add_argument("reference")
    ap.add_argument("--loops-explained", default="")
    ap.add_argument("--ates-at", type=int, default=None,
                    help="compare the prefix ATEs at this frame (before the first loop)")
    args = ap.parse_args(argv)
    with open(args.run) as f:
        run = json.load(f)
    run = run.get("outcome", run)
    with open(args.reference) as f:
        reference = json.load(f)
    ref = at_depth(reference, run["frames"])
    ates_at = None
    if args.ates_at is not None:
        ates_at = (at_depth(run, args.ates_at), at_depth(reference, args.ates_at))
    bad = gates(run, ref, loops_explained=args.loops_explained, ates_at=ates_at)
    print(json.dumps(dict(frames=run["frames"], margins=GATES, failures=bad)))
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
