"""Synthetic KITTI-odometry-layout sequence generator at reference
resolution, rendered with the textured-surface PlaneWorld.

Counterpart of `sqrtlm_slam_tpu/eval/kitti_synth.py` on the port's numpy
`planeworld`: with the same arguments it writes the same tree (the same PNG
pixels, `.bin` bytes, `calib.txt`, `times.txt` and pose text):

    <out>/sequences/<seq>/calib.txt
    <out>/sequences/<seq>/times.txt
    <out>/sequences/<seq>/image_0/000000.png ...    (1226x370 grayscale)
    <out>/sequences/<seq>/velodyne/000000.bin ...   (float32 x,y,z,i)
    <out>/poses/<seq>.txt                           (3x4 cam-to-world rows)

so `python -m sqrtlm_slam_tpu_torch.run_kitti` (and the native loader)
drive it like a real KITTI sequence. The default trajectory is ~2 laps of
a 390 m street circuit. PNGs are written with PIL where it is installed,
else with the port's zlib writer (`io/png.py`; the same pixels).

The scans keep the reference's 1440 rays a ring: under the default
`LidarConfig` (0.2 degree columns) they yield no LiDAR feature (a known
fault of the reference); a run that needs features rescans with
`n_azimuth=1800` and `planeworld.center_scan_on_columns`.

Usage:
    python -m sqrtlm_slam_tpu_torch.eval.kitti_synth --out <dir> \
        --frames 1000 [--seq 00] [--seed 0] [--step 0.8]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# Reference-resolution KITTI 00-02 intrinsics (cfg/KITTI00-02.yaml).
KITTI_W, KITTI_H = 1226, 370
KITTI_FX = 718.856
KITTI_FY = 718.856
KITTI_CX = 607.1928
KITTI_CY = 185.2157
KITTI_BF = 386.1448


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 image -> PNG file, with PIL where installed, else io/png.py."""
    try:
        from PIL import Image
    except ImportError:
        from ..io import png

        png.write(path, img)
        return
    Image.fromarray(img).save(path)


def generate(
    out: str,
    seq: str = "00",
    n_frames: int = 1000,
    seed: int = 0,
    step: float = 0.8,
    log=print,
) -> None:
    from ..factors.reprojection import Camera
    from .planeworld import T_CAM_VELO, circuit_trajectory, street_circuit_world

    cam = Camera(fx=KITTI_FX, fy=KITTI_FY, cx=KITTI_CX, cy=KITTI_CY, bf=KITTI_BF)
    seq_dir = os.path.join(out, "sequences", seq)
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(out, "poses"), exist_ok=True)

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(
            f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
            f"P1: {cam.fx} 0 {cam.cx} {-cam.bf} 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
            "Tr: " + " ".join(str(x) for x in T_CAM_VELO[:3].reshape(-1)) + "\n"
        )
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{i * 0.1:.6f}\n")

    t0 = time.perf_counter()
    world = street_circuit_world(seed=seed)
    log(f"[kitti_synth] world: {len(world.planes)} textured planes "
        f"({time.perf_counter() - t0:.1f}s)")
    poses, perim = circuit_trajectory(n_frames, step=step)
    log(f"[kitti_synth] trajectory: {n_frames} frames x {step} m "
        f"= {n_frames * step / perim:.2f} laps of {perim:.0f} m")

    gt_lines = []
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        img, _ = world.render(T, cam, H=KITTI_H, W=KITTI_W, noise_seed=i)
        write_png(os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
                  np.asarray(img).astype(np.uint8))
        scan = world.lidar_scan(T, T_CAM_VELO, noise_seed=i)
        scan.tofile(os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))

        M = np.eye(4)
        M[:3, :3] = np.asarray(T.R)
        M[:3, 3] = np.asarray(T.t)
        T_wc = np.linalg.inv(M)
        gt_lines.append(" ".join(f"{v:.9e}" for v in T_wc[:3].reshape(-1)))
        if (i + 1) % 50 == 0:
            rate = (i + 1) / (time.perf_counter() - t0)
            log(f"[kitti_synth] {i + 1}/{n_frames} frames "
                f"({rate:.1f} f/s, eta {(n_frames - i - 1) / rate:.0f}s)")
    with open(os.path.join(out, "poses", seq + ".txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    log(f"[kitti_synth] done -> {out} ({time.perf_counter() - t0:.0f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step", type=float, default=0.8)
    args = ap.parse_args(argv)
    generate(args.out, args.seq, args.frames, args.seed, args.step)


if __name__ == "__main__":
    main()
