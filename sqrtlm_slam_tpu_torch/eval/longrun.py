"""Long-horizon full-system run: the KITTI-00-class operating point.

Counterpart of `sqrtlm_slam_tpu/eval/longrun.py`: 1,000+ synthetic frames
of the multi-revolution ring through `SlamSystem.track_depth` with loop
detection on, hundreds of keyframes from the real keyframe policy, culling
active, several loop events; and the place-recognition precision / recall
of the keyframe database over the run's store.

Run:  python -m sqrtlm_slam_tpu_torch.eval.longrun --frames 1000 [--device cpu]
"""

from __future__ import annotations

import argparse
import resource
import time

import numpy as np


def run_long(
    n_frames: int = 1000,
    radius: float = 42.0,
    revolutions: float = 2.3,
    n_points: int = 12000,
    seed: int = 7,
    max_keyframes: int = 1200,
    max_landmarks: int = 400000,
    max_features: int = 2000,  # the reference's KITTI setting
    progress_every: int = 50,
    device="cuda",
    log=print,
):
    """Returns (a dict of summary metrics (also logged), the system)."""
    from ..eval.ate import ate_rmse
    from ..eval.synthetic import DEFAULT_CAM, ring_trajectory, ring_world
    from ..frontend import orb
    from ..loop import LoopClosingConfig
    from ..pipeline.system import SlamSystem, SystemConfig
    from ..pipeline.tracking import TrackingConfig

    world = ring_world(seed=seed, n_points=n_points, radius=radius, band=6.0)
    poses = ring_trajectory(n_frames, radius=radius, frac=revolutions)

    cfg = SystemConfig(
        # Denser detection grid (cell 16, 6 per cell): frame-to-frame
        # keypoint repeatability limits the match count on the ring.
        orb=orb.ORBConfig(max_features=max_features, per_cell=6, cell_size=16),
        # min_inliers_local 20 (reference 30): the ring's billboard patterns
        # match about half as reliably as real texture (the JAX package's
        # setting, kept).
        tracking=TrackingConfig(min_inliers_local=20),
        loop_detection=True,
        max_keyframes=max_keyframes,
        max_landmarks=max_landmarks,
    )
    s = SlamSystem(DEFAULT_CAM, cfg, device=device, loop_cfg=LoopClosingConfig())

    tracked = 0
    t_start = time.perf_counter()
    frame_times = []
    for i, T in enumerate(poses):
        img, depth = world.render(T, DEFAULT_CAM)
        t0 = time.perf_counter()
        ok = s.track_depth(img, depth) is not None
        frame_times.append(time.perf_counter() - t0)
        tracked += ok
        if progress_every and (i + 1) % progress_every == 0:
            log(f"[longrun] frame {i + 1}/{n_frames} tracked={tracked} "
                f"kf={int(np.sum(s.store.kf_valid))} lm={int(np.sum(s.store.lm_valid))} "
                f"loops={s.loop_closer.num_loops_closed} "
                f"med_ms={np.median(frame_times[-progress_every:]) * 1e3:.0f}")
    s.shutdown()
    wall = time.perf_counter() - t_start

    est = s.get_trajectory()
    # Ground truth by the recorded frame ids: lost frames leave gaps.
    gt = []
    for fid in s.trajectory_frame_ids()[: len(est)]:
        T = poses[int(fid)]
        M = np.eye(4)
        M[:3, :3] = np.asarray(T.R)
        M[:3, 3] = np.asarray(T.t)
        gt.append(np.linalg.inv(M))
    rmse, _ = ate_rmse(est, np.stack(gt))

    out = {
        "frames": n_frames,
        "tracked": tracked,
        "keyframes": int(np.sum(s.store.kf_valid)),
        "keyframes_created": int(s.store.num_kf),
        "landmarks": int(np.sum(s.store.lm_valid)),
        # Rows `SlamSystem` reclaimed from dead landmarks count as created.
        "landmarks_created": int(s.store.num_lm) + s.landmarks_reclaimed,
        "loops_closed": int(s.loop_closer.num_loops_closed),
        "ate_rmse_m": float(rmse),
        "frames_per_s": n_frames / wall,
        "median_frame_ms": float(np.median(frame_times) * 1e3),
        "wall_s": wall,
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "device": str(s.device),
    }
    log(f"[longrun] DONE {out}")
    return out, s


def evaluate_place_recognition(system, gt_T_cw, min_gap: int = 100, dist_thresh: float = 6.0,
                               log=print):
    """Loop-candidate precision / recall over the run's store.

    Keyframes i, j are a true pair when their ground-truth camera centres
    lie within `dist_thresh` metres and their frame ids more than `min_gap`
    frames apart. Precision = returned candidates that are true pairs /
    returned; recall = queries with a true pair for which a correct
    candidate was returned (queries without one are skipped, as in the JAX
    package)."""
    from ..loop.database import KeyFrameDatabase

    store = system.store
    db = KeyFrameDatabase(store)
    kfs = np.where(store.kf_valid[: store.num_kf])[0]
    frame_ids = store.kf_frame_id[kfs]
    centers = np.stack([-np.asarray(gt_T_cw[int(f)].R).T @ np.asarray(gt_T_cw[int(f)].t)
                        for f in frame_ids])
    idx_of = {int(k): i for i, k in enumerate(kfs)}

    d = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    gap = np.abs(frame_ids[:, None] - frame_ids[None, :])
    true_pair = (d < dist_thresh) & (gap > min_gap)

    n_query = n_ret = n_ret_correct = n_recalled = 0
    for i, kf in enumerate(kfs):
        if not true_pair[i].any():
            continue
        n_query += 1
        cand = db.detect_loop_candidates(int(kf), db.min_covisible_score(int(kf)))
        cand = [c for c in cand if int(c) in idx_of]
        correct = [c for c in cand if true_pair[i, idx_of[int(c)]]]
        n_ret += len(cand)
        n_ret_correct += len(correct)
        n_recalled += bool(correct)

    out = {
        "pr_queries": n_query,
        "pr_returned": n_ret,
        "pr_precision": n_ret_correct / max(n_ret, 1),
        "pr_recall": n_recalled / max(n_query, 1),
    }
    log(f"[place-recognition] {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--radius", type=float, default=42.0)
    ap.add_argument("--revolutions", type=float, default=2.3)
    ap.add_argument("--points", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eval-pr", action="store_true",
                    help="place-recognition precision/recall over the store")
    args = ap.parse_args(argv)
    out, s = run_long(n_frames=args.frames, radius=args.radius, revolutions=args.revolutions,
                      n_points=args.points, seed=args.seed, max_features=args.features,
                      device=args.device)
    if args.eval_pr:
        from .synthetic import ring_trajectory

        evaluate_place_recognition(
            s, ring_trajectory(args.frames, radius=args.radius, frac=args.revolutions))


if __name__ == "__main__":
    main()
