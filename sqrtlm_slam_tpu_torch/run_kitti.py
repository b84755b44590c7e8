"""KITTI sequence runner on PyTorch: one command in place of the reference's
three ROS nodes (`fusion_slam`, `lidar_slam` and `kittiHelper`).

Counterpart of the repository's `run_kitti.py` (the JAX package's runner):

    python -m sqrtlm_slam_tpu_torch.run_kitti --root <kitti> --seq 04 \
        --mode fusion --out traj_04.txt [--loop] [--frames N] [--device cpu]

Modes:
    fusion  ORB tracking + LiDAR depth + tight coupling (`track_fusion`)
    depth   ORB + the LiDAR cloud projected to a depth image (`track_depth`)
    mono    monocular (two-view initialization, triangulated landmarks)
    lidar   standalone LiDAR odometry (`LidarOdometry`)

Runs on the CUDA device unless `--device` names another (the tests pass
`cpu`); there is no automatic fallback. Frames come from the native
prefetching loader where it builds (`io/native_loader.py`), else from
`io/kitti.py` (a line on stderr says which). Ends by writing the KITTI-format
trajectory and printing the Sim3 / SE3-aligned ATE against ground truth
when the sequence has it, and a per-stage timing table. `--json` prints one
summary line with the JAX runner's keys (`seq`, `mode`, `frames`,
`tracked`, `keyframes`, `landmarks`, `loops_closed`, `frames_per_s`,
`ate_rmse_m`, `peak_rss_gb`) and a few of its own.

`frames_per_s` keeps the JAX runner's meaning: frames over the summed
`track` stage. Device work is asynchronous and deferred work (the pipelined
frame, the mapping queue) lands in a later stage, so the final drain
(`shutdown`) is a stage of its own and `wall_s` is the frame loop plus the
drain. `main(argv)` can be called in process and returns the summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import sys
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sqrtlm_slam_tpu_torch.run_kitti",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--seq", default="04")
    ap.add_argument("--mode", default="fusion", choices=["fusion", "depth", "mono", "lidar"])
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--loop", action="store_true", help="enable loop closing")
    ap.add_argument("--checkpoint", default=None, help="save the map here at the end")
    ap.add_argument("--resume", default=None, help="resume from a map checkpoint")
    ap.add_argument("--max-features", type=int, default=2000)
    ap.add_argument("--max-keyframes", type=int, default=1200)
    ap.add_argument("--max-landmarks", type=int, default=400000)
    ap.add_argument("--async-mapping", action="store_true",
                    help="local mapping + loop closing on a worker thread")
    ap.add_argument("--pipelined", action="store_true",
                    help="deferred-read tracking (frame t is read after t+1 is dispatched)")
    ap.add_argument("--json", action="store_true", help="print one JSON summary line")
    ap.add_argument("--plot", default=None, help="write a top-down trajectory PNG here")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="write a SLAM-state snapshot PNG every N frames "
                         "(<plot-or-out stem>_live.png)")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace into this directory")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def _open_loader(seq, mode: str, n: int):
    """(frame reader, "native" or "python", image reader name or None)."""
    from .io import kitti
    from .io.native_loader import NativeKittiLoader, build_error

    want_image = mode != "lidar"
    if NativeKittiLoader.available():
        native = NativeKittiLoader(seq.image_dir if want_image else None, seq.velo_dir, n)
        native.prefetch(0)
        print("[io] native prefetching loader active", file=sys.stderr)

        def load(i):
            native.prefetch(i)
            return native.frame(i)
        return load, native, "native", "libpng" if want_image else None
    print(f"[io] native loader unavailable, reading with io/kitti.py: {build_error()}",
          file=sys.stderr)

    def load(i):
        return (seq.image(i) if want_image else None), seq.velodyne(i)
    return load, None, "python", kitti.image_backend() if want_image else None


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from .eval.ate import ate_rmse
    from .io import kitti
    from .utils import to_host
    from .utils.config import kitti_sequence_config
    from .utils.timing import StageTimer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_kitti: no CUDA device (pass --device cpu to run on the CPU)")

    seq = kitti.KittiSequence(args.root, args.seq)
    n = len(seq) if args.frames <= 0 else min(args.frames, len(seq))
    cfg_seq = kitti_sequence_config(args.seq)
    timer = StageTimer()
    load_frame, native, loader, image_reader = _open_loader(seq, args.mode, n)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        profiler = profile(activities=acts)

    slam = None
    resume = None
    track_s = []  # per frame: the track stage's seconds
    t_loop = time.perf_counter()
    with profiler as prof:
        if args.mode == "lidar":
            from .lidar.odometry import LidarOdometry

            odo = LidarOdometry(feat_cfg=cfg_seq.lidar, device=device)
            poses = []
            for i in range(n):
                with timer.stage("io"):
                    _, velo = load_frame(i)
                t0 = time.perf_counter()
                with timer.stage("lidar_odometry"):
                    T = odo.process(velo[:, :3])
                    R, t = to_host(T.R, T.t)
                track_s.append(time.perf_counter() - t0)
                M = np.eye(4)
                M[:3, :3], M[:3, 3] = R, t  # T_lw
                poses.append(np.linalg.inv(M))
            sync()
            wall_s = time.perf_counter() - t_loop
            est = np.stack(poses)
            est_ids = np.arange(len(est))
        else:
            from .frontend.orb import ORBConfig
            from .pipeline.frame import project_cloud_to_depth_image
            from .pipeline.system import SlamSystem, SystemConfig

            sys_cfg = SystemConfig(
                orb=ORBConfig(max_features=args.max_features),
                tracking=cfg_seq.tracking._replace(pipelined=args.pipelined),
                loop_detection=args.loop,
                lidar=cfg_seq.lidar if args.mode == "fusion" else None,
                max_keyframes=args.max_keyframes,
                max_landmarks=args.max_landmarks,
                async_mapping=args.async_mapping,
            )
            if args.resume:
                slam = SlamSystem.load(args.resume, seq.calib.cam, sys_cfg, device=device)
                resume = {"keyframes_loaded": slam.num_keyframes()}
            else:
                slam = SlamSystem(seq.calib.cam, sys_cfg, device=device)
            T_cv = seq.calib.T_cam_velo
            T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
            tracked = 0
            for i in range(n):
                with timer.stage("io"):
                    img_np, velo_np = load_frame(i)
                    img = torch.as_tensor(img_np).to(device)
                t0 = time.perf_counter()
                with timer.stage("track"):
                    if args.mode == "mono":
                        p = slam.track_monocular(img)
                    elif args.mode == "depth":
                        cloud = velo_np[:, :3] @ T_cv[:3, :3].T + T_cv[:3, 3]
                        depth = project_cloud_to_depth_image(
                            torch.as_tensor(cloud, dtype=torch.float32).to(device),
                            seq.calib.cam, img.shape[0], img.shape[1])
                        p = slam.track_depth(img, depth)
                    else:  # fusion
                        p = slam.track_fusion(img, velo_np[:, :3], T_cam_lidar=T_cl)
                track_s.append(time.perf_counter() - t0)
                tracked += p is not None
                if (i + 1) % 50 == 0:
                    print(f"[{args.seq}] frame {i + 1}/{n} tracked={tracked} "
                          f"kfs={slam.num_keyframes()} lms={slam.num_landmarks()}",
                          file=sys.stderr)
                if args.viz_every > 0 and (i + 1) % args.viz_every == 0:
                    # A snapshot overwritten in place: a viewer polling the
                    # file sees the map grow during the run.
                    from .eval.plot import render_slam_result

                    stem = (args.plot or args.out or f"viz_{args.seq}").rsplit(".", 1)[0]
                    try:
                        render_slam_result(
                            slam.get_slam_result(), stem + "_live.png",
                            gt=seq.gt_poses[: i + 1] if seq.gt_poses is not None else None)
                    except (ImportError, OSError, ValueError) as e:
                        print(f"[viz] snapshot failed: {e}", file=sys.stderr)
            with timer.stage("shutdown"):
                slam.shutdown()  # the deferred frame, the mapping queue, global BA
                sync()
            wall_s = time.perf_counter() - t_loop  # the frame loop and the drain
            est = slam.get_trajectory()
            est_ids = slam.trajectory_frame_ids()
            if args.checkpoint:
                slam.save(args.checkpoint)
            print(f"tracked {tracked}/{n} frames", file=sys.stderr)
    if native is not None:
        native.close()

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"trace_{args.seq}_{args.mode}.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace -> {trace} (chrome://tracing or Perfetto)", file=sys.stderr)

    out = args.out or f"traj_{args.seq}_{args.mode}.txt"
    kitti.write_kitti_poses(out, est)
    print(f"trajectory -> {out}", file=sys.stderr)

    if args.plot:
        from .eval.plot import plot_trajectory, render_slam_result

        lms = None
        if slam is not None:
            sel = slam.store.lm_valid[: slam.store.num_lm]
            lms = slam.store.lm_pos[: slam.store.num_lm][sel]
        plot_trajectory(args.plot, est,
                        gt=seq.gt_poses[est_ids] if seq.gt_poses is not None else None,
                        landmarks=lms, title=f"KITTI {args.seq} ({args.mode})")
        print(f"plot -> {args.plot}", file=sys.stderr)
        if slam is not None:
            snap_path = args.plot.rsplit(".", 1)[0] + "_snapshot.png"
            render_slam_result(slam.get_slam_result(), snap_path,
                               gt=seq.gt_poses[: len(est)] if seq.gt_poses is not None
                               else None)
            print(f"slam-result snapshot -> {snap_path}", file=sys.stderr)

    result = {"seq": args.seq, "mode": args.mode, "frames": int(n)}
    result["peak_rss_gb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)
    if slam is not None:
        result["tracked"] = int(tracked)
        result["keyframes"] = int(slam.num_keyframes())
        result["landmarks"] = int(slam.num_landmarks())
        if slam.loop_closer is not None:
            result["loops_closed"] = int(slam.loop_closer.num_loops_closed)
    stage = "lidar_odometry" if args.mode == "lidar" else "track"
    total_track = timer.totals.get(stage, 0.0)
    if total_track > 0:
        result["frames_per_s"] = round(n / total_track, 2)
    if seq.gt_poses is not None and len(est):
        # Ground truth by recorded frame ids: lost frames record no entry.
        rmse, _ = ate_rmse(est, seq.gt_poses[est_ids], align_scale=(args.mode == "mono"))
        result["ate_rmse_m"] = round(float(rmse), 4)
        print(f"ATE RMSE ({'Sim3' if args.mode == 'mono' else 'SE3'}-aligned): "
              f"{rmse:.4f} m", file=sys.stderr)
    if resume is not None:
        # The reference's rule: a map of more than 5 keyframes is relocalised
        # against; a smaller one is reset and the sequence re-initialises.
        resume["outcome"] = ("re-initialised" if resume["keyframes_loaded"] <= 5
                             else "relocalised" if tracked else "lost")
        result["resume"] = resume
    result.update(
        device=str(device), wall_s=wall_s, drain_s=timer.totals.get("shutdown", 0.0),
        track_ms_median=1e3 * float(np.median(track_s)) if track_s else None,
        io_ms_per_frame=1e3 * timer.totals.get("io", 0.0) / max(n, 1),
        loader=loader, image_reader=image_reader)
    print(timer.summary(), file=sys.stderr)
    if args.json:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
