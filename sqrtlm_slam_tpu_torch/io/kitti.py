"""KITTI odometry dataset loading: images, velodyne, calibration, poses.

Counterpart of `sqrtlm_slam_tpu/io/kitti.py` (the reference's `kittiHelper`
readers and the calib.txt parsing of `FusionSystem`): a plain directory
reader that returns numpy arrays; the caller moves them to the device.

Expected layout (KITTI odometry):
    sequences/<seq>/calib.txt, times.txt, image_0/{%06d}.png, velodyne/{%06d}.bin
    poses/<seq>.txt              (ground truth, 3x4 row-major per line)
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..factors.reprojection import Camera
from . import png


class KittiCalib(NamedTuple):
    cam: Camera  # intrinsics from P0 (+ bf from the P1 baseline when present)
    T_cam_velo: np.ndarray  # (4, 4) velodyne -> camera extrinsic ("Tr")


def parse_calib(path: str) -> KittiCalib:
    """Parse a KITTI odometry calib.txt (P0..P3 + Tr rows)."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.array([float(x) for x in v.split()])
            mats[k.strip()] = vals.reshape(3, 4)
    P0 = mats["P0"]
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    bf = 0.0
    if "P1" in mats:
        # P1[0,3] = -fx * baseline for the right camera.
        bf = float(-mats["P1"][0, 3])
    T = np.eye(4)
    if "Tr" in mats:
        T[:3] = mats["Tr"]
    return KittiCalib(
        cam=Camera(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy), bf=bf),
        T_cam_velo=T,
    )


def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: float32 x, y, z, intensity records -> (N, 4)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """GT poses: (F, 4, 4) cam0-to-world."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (data.shape[0], 1, 1))
    out[:, :3, :] = data
    return out


def image_backend() -> str:
    """The PNG reader `read_image` uses here: "PIL" where it is installed,
    else "zlib" (`io/png.py`)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "zlib"
    return "PIL"


def read_image(path: str) -> np.ndarray:
    """Grayscale image as float32 (H, W) in [0, 255] (PIL, else the zlib
    decoder; both give PIL's luminance for an RGB file)."""
    if image_backend() == "PIL":
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"))
    else:
        img = png.read_gray(path)
    return img.astype(np.float32)


class KittiSequence:
    """Reader of one KITTI odometry sequence."""

    def __init__(self, root: str, seq: str, camera: str = "image_0"):
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.calib = parse_calib(os.path.join(self.seq_dir, "calib.txt"))
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = read_times(times_path) if os.path.exists(times_path) else None
        self.image_dir = os.path.join(self.seq_dir, camera)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        gt_path = os.path.join(root, "poses", seq + ".txt")
        self.gt_poses = read_poses(gt_path) if os.path.exists(gt_path) else None
        if os.path.isdir(self.image_dir):
            self.num_frames = len([f for f in os.listdir(self.image_dir) if f.endswith(".png")])
        elif os.path.isdir(self.velo_dir):
            self.num_frames = len([f for f in os.listdir(self.velo_dir) if f.endswith(".bin")])
        else:
            self.num_frames = 0

    def image(self, i: int) -> np.ndarray:
        return read_image(os.path.join(self.image_dir, f"{i:06d}.png"))

    def velodyne(self, i: int) -> np.ndarray:
        return read_velodyne_bin(os.path.join(self.velo_dir, f"{i:06d}.bin"))

    def cloud_in_cam(self, i: int) -> np.ndarray:
        """Velodyne points moved into the camera frame by Tr."""
        pts = self.velodyne(i)[:, :3]
        T = self.calib.T_cam_velo
        return pts @ T[:3, :3].T + T[:3, 3]

    def __len__(self):
        return self.num_frames


def write_kitti_poses(path: str, poses: np.ndarray):
    """(F, 4, 4) cam-to-world -> KITTI 3x4 row-major lines."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)) + "\n")
