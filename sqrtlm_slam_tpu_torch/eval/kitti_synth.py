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
fault of the reference). `centred=True` (`--centred-scans`) writes instead
64 x 1800-ray scans yawed onto the range image's column centres
(`planeworld.center_scan_on_columns`) and the `Tr` that goes with them: the
sequence every fusion run of the port reads (the KITTI runner's smoke
phases and the fusion soak), and the JAX package's runner with it.
`scans_only=True` (`--scans-only`) leaves out the images: `calib.txt`,
`times.txt`, the scans and the poses, the same bytes as the full write's
(what LiDAR-only odometry reads); `first_frame=k` (`--first-frame k`)
writes the frames from k on, the earlier ones being the caller's.

Each frame depends only on the world and its index (`noise_seed=i`), so
`workers > 1` writes the frames in that many processes of this module's
command line (`--slice k/n`: frames k, k + n, ...), each with its own
world and one BLAS thread: the same bytes as one process (1,000 frames
at 1226x370 take ~20 minutes in one process on one server CPU core).

Usage:
    python -m sqrtlm_slam_tpu_torch.eval.kitti_synth --out <dir> \
        --frames 1000 [--seq 00] [--seed 0] [--step 0.8] [--workers 8] \
        [--centred-scans] [--scans-only] [--first-frame K]
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


def centred_scan(world, T, i: int):
    """Frame `i`'s 64 x 1800-ray scan with every ray on a column centre of
    the default `LidarConfig`'s range image: ((N, 4) float32 x, y, z,
    intensity, the (4, 4) T_cam_velo that maps it to the camera)."""
    from .planeworld import T_CAM_VELO, center_scan_on_columns

    scan = world.lidar_scan(T, T_CAM_VELO, n_azimuth=1800, noise_seed=i)
    pts, T_cv = center_scan_on_columns(scan, T_CAM_VELO)
    return np.concatenate([pts, scan[:, 3:4]], axis=1).astype(np.float32), T_cv


def _camera():
    from ..factors.reprojection import Camera

    return Camera(fx=KITTI_FX, fy=KITTI_FY, cx=KITTI_CX, cy=KITTI_CY, bf=KITTI_BF)


def _write_frames(frames, world, poses, cam, seq_dir, centred, images=True):
    from .planeworld import T_CAM_VELO

    for i in frames:
        T = poses[i]
        if images:
            img, _ = world.render(T, cam, H=KITTI_H, W=KITTI_W, noise_seed=i)
            write_png(os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
                      np.asarray(img).astype(np.uint8))
        if centred:
            scan, _ = centred_scan(world, T, i)
        else:
            scan = world.lidar_scan(T, T_CAM_VELO, noise_seed=i)
        scan.tofile(os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))


# A worker's BLAS threads: workers of a BLAS thread a core each busy-wait
# on one another (6 of them wrote ~0.3 frames/s on 8 cores, 8 workers of
# one thread each ~5.5).
_ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")}


def _run_workers(out, seq, n_frames, seed, step, centred, workers, log, scans_only=False,
                 first_frame=0):
    """`workers` processes of this module, each writing every workers-th
    frame from `first_frame` on; their progress is read off the files
    written (the PNGs, or the scans when `scans_only`)."""
    import subprocess
    import sys
    import tempfile

    top = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, **_ONE_THREAD,
               PYTHONPATH=os.pathsep.join(p for p in (top, os.environ.get("PYTHONPATH")) if p))
    base = [sys.executable, "-m", f"{__package__}.kitti_synth", "--out", out, "--seq", seq,
            "--frames", str(n_frames), "--seed", str(seed), "--step", repr(step)]
    base += ["--centred-scans"] * centred + ["--scans-only"] * scans_only
    base += ["--first-frame", str(first_frame)]
    errs = [tempfile.TemporaryFile("w+") for _ in range(workers)]
    procs = [subprocess.Popen(base + ["--slice", f"{k}/{workers}"], env=env,
                              stdout=subprocess.DEVNULL, stderr=err)
             for k, err in enumerate(errs)]
    watched = os.path.join(out, "sequences", seq, "velodyne" if scans_only else "image_0")
    before = len(os.listdir(watched))
    t0, logged = time.perf_counter(), first_frame
    try:
        while any(p.poll() is None for p in procs):
            time.sleep(1.0)
            done = len(os.listdir(watched)) - before + first_frame
            if done // 50 > logged // 50:
                rate = (done - first_frame) / (time.perf_counter() - t0)
                log(f"[kitti_synth] ~{done}/{n_frames} frames, {workers} processes "
                    f"({rate:.1f} f/s, eta {(n_frames - done) / rate:.0f}s)")
                logged = done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = []
    for k, (p, err) in enumerate(zip(procs, errs)):
        if p.wait() != 0:
            err.seek(0)
            bad.append((k, p.returncode, err.read()[-2000:]))
        err.close()
    if bad:
        raise RuntimeError(f"kitti_synth workers failed: {bad}")


def generate(
    out: str,
    seq: str = "00",
    n_frames: int = 1000,
    seed: int = 0,
    step: float = 0.8,
    log=print,
    workers: int = 1,
    centred: bool = False,
    world=None,
    scans_only: bool = False,
    first_frame: int = 0,
) -> None:
    """Write the sequence under `out`. `workers > 1`: the frames in that
    many processes (the same bytes). `centred`: the 64 x 1800-ray scans of
    `centred_scan` and their `Tr`. `scans_only`: no images. `first_frame`:
    write frames `first_frame` .. `n_frames - 1` only (calib, times and
    poses whole). `world`: the street
    (`street_circuit_world(seed)`), if the caller has built it (used in
    this process only)."""
    from .planeworld import T_CAM_VELO, center_scan_on_columns, circuit_trajectory

    cam = _camera()
    seq_dir = os.path.join(out, "sequences", seq)
    if not scans_only:
        os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(out, "poses"), exist_ok=True)

    T_cv = center_scan_on_columns(np.zeros((0, 3)), T_CAM_VELO)[1] if centred else T_CAM_VELO
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(
            f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
            f"P1: {cam.fx} 0 {cam.cx} {-cam.bf} 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
            "Tr: " + " ".join(str(x) for x in T_cv[:3].reshape(-1)) + "\n"
        )
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write(f"{i * 0.1:.6f}\n")

    poses, perim = circuit_trajectory(n_frames, step=step)
    log(f"[kitti_synth] trajectory: {n_frames} frames x {step} m "
        f"= {n_frames * step / perim:.2f} laps of {perim:.0f} m")
    t0 = time.perf_counter()
    workers = max(1, min(workers, n_frames - first_frame))
    if workers > 1:
        _run_workers(out, seq, n_frames, seed, step, centred, workers, log, scans_only,
                     first_frame)
    else:
        from .planeworld import street_circuit_world

        if world is None:
            world = street_circuit_world(seed=seed)
            log(f"[kitti_synth] world: {len(world.planes)} textured planes "
                f"({time.perf_counter() - t0:.1f}s)")
        for lo in range(first_frame, n_frames, 50):
            _write_frames(range(lo, min(lo + 50, n_frames)), world, poses, cam, seq_dir,
                          centred, images=not scans_only)
            done = min(lo + 50, n_frames)
            rate = (done - first_frame) / (time.perf_counter() - t0)
            log(f"[kitti_synth] {done}/{n_frames} frames "
                f"({rate:.1f} f/s, eta {(n_frames - done) / rate:.0f}s)")

    gt_lines = []
    for T in poses:
        M = np.eye(4)
        M[:3, :3] = np.asarray(T.R)
        M[:3, 3] = np.asarray(T.t)
        T_wc = np.linalg.inv(M)
        gt_lines.append(" ".join(f"{v:.9e}" for v in T_wc[:3].reshape(-1)))
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
    ap.add_argument("--workers", type=int, default=1, help="processes writing frame ranges")
    ap.add_argument("--centred-scans", action="store_true",
                    help="64 x 1800-ray scans on the range image's column centres")
    ap.add_argument("--scans-only", action="store_true",
                    help="no images: calib, times, scans and poses")
    ap.add_argument("--first-frame", type=int, default=0,
                    help="write frames from this one on (the earlier ones exist)")
    ap.add_argument("--slice", default=None, metavar="K/N",
                    help="write only frames K, K+N, ... (a worker of --workers N)")
    args = ap.parse_args(argv)
    if args.slice is None:
        generate(args.out, args.seq, args.frames, args.seed, args.step,
                 workers=args.workers, centred=args.centred_scans,
                 scans_only=args.scans_only, first_frame=args.first_frame)
        return
    from .planeworld import circuit_trajectory, street_circuit_world

    k, n = (int(x) for x in args.slice.split("/"))
    poses, _ = circuit_trajectory(args.frames, step=args.step)
    _write_frames(range(args.first_frame + k, args.frames, n),
                  street_circuit_world(seed=args.seed), poses, _camera(),
                  os.path.join(args.out, "sequences", args.seq), args.centred_scans,
                  images=not args.scans_only)


if __name__ == "__main__":
    main()
