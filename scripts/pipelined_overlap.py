#!/usr/bin/env python3
"""Sync against pipelined tracking on one GPU: does frame t+1's device work
overlap frame t's host bookkeeping, and what still synchronizes?

    python3 scripts/pipelined_overlap.py            # fusion, KITTI size (~2 min)
    python3 scripts/pipelined_overlap.py --rgbd     # RGB-D, KITTI size

Runs `SlamSystem.track_fusion` over the street circuit of
`eval/planeworld.py` (street_circuit_world(seed=0), 20 frames at 0.8 m from
54 m along the circuit, 1226x370 with the KITTI 00-02 intrinsics, 2000 ORB
features, scans of 64 rings x 1800 rays centred on the columns, default
LidarConfig), or `track_depth` over a synthetic RGB-D world at KITTI size
(SyntheticWorld(seed=1, 3000 points), 16 frames at 0.3 m), once in sync mode
and once with `TrackingConfig(pipelined=True)`, graphed (the default), each
frame timed to a synchronize. Per mode it prints one JSON line: ms per
frame (median, and the median over frames that inserted no keyframe),
keyframes, host reads per frame, and per read of a step's results whether
the device still had work queued when the read returned
(`torch.cuda.Stream.query`: in pipelined mode the next frame's step,
dispatched before the read). Then, with `torch.cuda.set_sync_debug_mode`,
the operations that synchronize the stream inside `Tracker._dispatch_step`
(after the warm-up frames), by call site. The first line carries the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

KITTI_INTRINSICS = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448)
KITTI_H, KITTI_W = 370, 1226
FUSION_START_S = 54.0


def frames_of(rgbd: bool):
    """(camera, system config, frames, track function) of the scene."""
    from sqrtlm_slam_tpu_torch.eval import planeworld, synthetic
    from sqrtlm_slam_tpu_torch.factors.reprojection import Camera
    from sqrtlm_slam_tpu_torch.frontend.orb import ORBConfig
    from sqrtlm_slam_tpu_torch.lidar.features import LidarConfig
    from sqrtlm_slam_tpu_torch.pipeline.system import SystemConfig

    cam = Camera(**KITTI_INTRINSICS)
    cfg = SystemConfig(orb=ORBConfig(max_features=2000))
    if rgbd:
        world = synthetic.SyntheticWorld(seed=1, n_points=3000)
        frames = [world.render(T, cam, H=KITTI_H, W=KITTI_W)
                  for T in synthetic.forward_trajectory(16, step=0.3)]
        return cam, cfg, frames, lambda s, f: s.track_depth(*f)
    street = planeworld.street_circuit_world(seed=0)
    poses, _ = planeworld.circuit_trajectory(20, step=0.8, start_s=FUSION_START_S)
    frames = []
    for i, T in enumerate(poses):
        img = street.render(T, cam, H=KITTI_H, W=KITTI_W, noise_seed=i)[0]
        scan = street.lidar_scan(T, planeworld.T_CAM_VELO, n_azimuth=1800, noise_seed=i)
        pts, T_cv = planeworld.center_scan_on_columns(scan, planeworld.T_CAM_VELO)
        frames.append((img, pts))
    T_cl = (T_cv[:3, :3].astype(np.float32), T_cv[:3, 3].astype(np.float32))
    return (cam, cfg._replace(lidar=LidarConfig()), frames,
            lambda s, f: s.track_fusion(*f, T_cam_lidar=T_cl))


def run(cam, cfg, frames, track, pipelined: bool, warm: int = 6) -> dict:
    import torch
    from sqrtlm_slam_tpu_torch import utils
    from sqrtlm_slam_tpu_torch.pipeline import tracking
    from sqrtlm_slam_tpu_torch.pipeline.system import SlamSystem

    system = SlamSystem(cam, cfg._replace(tracking=cfg.tracking._replace(pipelined=pipelined)))
    busy, sites, current = [], collections.Counter(), [0]
    wait_host, dispatch = tracking.wait_host, tracking.Tracker._dispatch_step

    def noting_wait_host(copy):
        out = wait_host(copy)
        busy.append((current[0], not torch.cuda.current_stream().query()))
        return out

    def watched_dispatch(self, frame):
        if current[0] < warm:
            return dispatch(self, frame)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return dispatch(self, frame)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def note(message, category, filename, lineno, file=None, line=None):
        stack = [f"{f.filename.split('sqrtlm_slam_tpu_torch/')[-1]}:{f.lineno} {f.name}"
                 for f in traceback.extract_stack()[:-2]
                 if "sqrtlm_slam_tpu_torch" in f.filename]
        sites[" <- ".join(reversed(stack[-3:]))] += 1

    tracking.wait_host, tracking.Tracker._dispatch_step = noting_wait_host, watched_dispatch
    ms, kf = [], []
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            utils.host_reads = 0
            for i, f in enumerate(frames):
                current[0] = i
                n_kf = system.num_keyframes()
                t = time.perf_counter()
                track(system, f)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                kf.append(system.num_keyframes() > n_kf)
            system.get_trajectory()
    finally:
        tracking.wait_host, tracking.Tracker._dispatch_step = wait_host, dispatch
    steady = range(warm, len(frames))
    later = [b for i, b in busy if i >= warm]
    return dict(
        mode="pipelined" if pipelined else "sync", frames=len(frames),
        keyframes=system.num_keyframes(), keyframe_frames=[i for i in steady if kf[i]],
        ms_per_frame=[round(x, 3) for x in ms],
        median_ms=float(np.median([ms[i] for i in steady])),
        median_ms_without_keyframe=float(np.median([ms[i] for i in steady if not kf[i]])),
        host_reads_per_frame=utils.host_reads / len(frames),
        device_busy_after_step_read=[b for _, b in busy],
        device_busy_after_step_read_share=sum(later) / max(len(later), 1),
        synchronizing_in_dispatch_by_site=dict(sites.most_common()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rgbd", action="store_true", help="RGB-D instead of fusion")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        sys.exit("pipelined_overlap: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}), flush=True)
    scene = frames_of(args.rgbd)
    for pipelined in (False, True, False, True):  # in turns, on one card
        print(json.dumps(run(*scene, pipelined=pipelined)), flush=True)


if __name__ == "__main__":
    main()
