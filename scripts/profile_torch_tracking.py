#!/usr/bin/env python3
"""Where the port's tracking time goes on one GPU.

    python3 scripts/profile_torch_tracking.py            # RGB-D, bench shape
    python3 scripts/profile_torch_tracking.py --fusion   # camera+LiDAR, KITTI size
    ... --eager                                          # op by op, no CUDA graphs

Runs `sqrtlm_slam_tpu_torch` SlamSystem.track_depth over the bench.py
tracking scene (240x320 synthetic world, seed 1, 1200 points, step 0.3 m)
(24 frames, 1000 features, the last 4 profiled) and prints JSON lines:
  * stage wall times per frame (frame build, tracking step, local mapping),
    each bracketed by torch.cuda.synchronize();
  * a torch.profiler window over steady-state frames: wall ms per frame,
    device (CUDA kernel) ms per frame, kernel launches per frame, the
    device's idle share, and the top kernels / host ops by time.
With `--fusion` the scene is the street circuit of `eval/planeworld.py` at
KITTI size (1226x370, KITTI 00-02 intrinsics, 2000 features, scans of 64
rings x 1800 rays centred on the range image's columns, ~114,000 points,
default LidarConfig and TrackingConfig) through
`SlamSystem.track_fusion` (20 frames, the last 4 profiled), and the stage
split also times the parts of the frame build (ORB, LiDAR features, cloud
projection, depth association) and the LiDAR stage of local BA.
The entry points replay captured CUDA graphs (`utils.cache`); `--eager`
runs them op by op (`disable_graphs`), and only then are the frame
build's parts timed (a synchronize cannot stand inside a captured graph).
Launches per frame count kernel launches and graph launches.
The first lines carry the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fusion_scene(n_frames: int):
    """(camera, SystemConfig, [(image, scan)], T_cam_lidar) at KITTI size."""
    from sqrtlm_slam_tpu_torch.eval import planeworld
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.lidar.features import LidarConfig
    from sqrtlm_slam_tpu_torch.pipeline.system import SystemConfig

    cam = Camera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)
    world = planeworld.street_circuit_world(seed=0)
    poses, _ = planeworld.circuit_trajectory(n_frames, step=0.8)
    frames = []
    for i, T in enumerate(poses):
        img, _ = world.render(T, cam, H=370, W=1226, noise_seed=i)
        scan = world.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
        frames.append((img, pts))
    T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
    cfg = SystemConfig(orb=ORBConfig(max_features=2000), lidar=LidarConfig())
    return cam, cfg, frames, T_cl


def run(fusion: bool, eager: bool) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_tracking: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sqrtlm_slam_tpu_torch.eval import synthetic
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.lidar import features as lidar_features
    from sqrtlm_slam_tpu_torch.pipeline import frame as frame_mod
    from sqrtlm_slam_tpu_torch.pipeline import local_mapping, system, tracking

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)

    stage_s = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    system.build_frame_jit = timed("build_frame", system.build_frame_jit)
    tracking.track_frame_step = timed("track_frame_step", tracking.track_frame_step)
    local_mapping.LocalMapper.process_keyframe = timed(
        "process_keyframe", local_mapping.LocalMapper.process_keyframe)
    local_mapping.LocalMapper.local_ba = timed("local_ba", local_mapping.LocalMapper.local_ba)

    n_prof = 4
    if fusion:
        if eager:
            frame_mod.orb.extract = timed("orb_extract", frame_mod.orb.extract)
            lidar_features.extract_features = timed("lidar_extract_features",
                                                    lidar_features.extract_features)
            frame_mod.project_cloud_to_depth_image = timed(
                "project_cloud_to_depth_image", frame_mod.project_cloud_to_depth_image)
            frame_mod.associate_depth = timed("associate_depth", frame_mod.associate_depth)
        local_mapping.LocalMapper._lidar_stage = timed(
            "lidar_stage", local_mapping.LocalMapper._lidar_stage)
        tracking.Tracker._gather_lidar_local_map = timed(
            "gather_lidar_local_map", tracking.Tracker._gather_lidar_local_map)
        cam, cfg, frames, T_cl = fusion_scene(20)
        s = system.SlamSystem(cam, cfg, device="cuda")

        def step(fr):
            return s.track_fusion(fr[0], fr[1], T_cam_lidar=T_cl)
    else:
        world = synthetic.SyntheticWorld(seed=1, n_points=1200)
        poses = synthetic.forward_trajectory(24, step=0.3)
        frames = [world.render(T, synthetic.DEFAULT_CAM) for T in poses]
        s = system.SlamSystem(synthetic.DEFAULT_CAM,
                              system.SystemConfig(orb=ORBConfig(max_features=1000)),
                              device="cuda")

        def step(fr):
            return s.track_depth(*fr)
    tracked = sum(step(fr) is not None for fr in frames[:-n_prof])
    print(json.dumps({
        "stages_ms_median": {k: 1e3 * float(np.median(v)) for k, v in stage_s.items()},
        "stage_calls": {k: len(v) for k, v in stage_s.items()},
        "mode": "fusion" if fusion else "rgbd", "graphs": not eager, "tracked": tracked,
        "frames": len(frames) - n_prof, "keyframes": s.num_keyframes(),
        "last_lidar_matches": s.tracker.last_lidar_matches, "card": card}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames[-n_prof:]:
            step(fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaLaunchKernelExC"))
    graph_launches = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    top_dev = sorted((e for e in events if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:12]
    top_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]
    print(json.dumps({
        "profiled_frames": n_prof, "wall_ms_per_frame": 1e3 * wall / n_prof,
        "device_ms_per_frame": dev_us / 1e3 / n_prof,
        "device_idle_share": 1.0 - (dev_us / 1e6) / wall,
        "kernel_launches_per_frame": launches / n_prof,
        "graph_launches_per_frame": graph_launches / n_prof,
        "cuda_launches_per_frame": (launches + graph_launches) / n_prof,
        "keyframes": s.num_keyframes(),
        "top_device": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top_dev],
        "top_host_self_ms": [(e.key[:60], e.count, e.self_cpu_time_total / 1e3) for e in top_cpu],
        "card": card}), flush=True)


def main() -> None:
    import contextlib

    from sqrtlm_slam_tpu_torch.utils import cache

    eager = "--eager" in sys.argv[1:]
    with cache.disable_graphs() if eager else contextlib.nullcontext():
        run(fusion="--fusion" in sys.argv[1:], eager=eager)


if __name__ == "__main__":
    main()
