"""The LiDAR local map of the fusion path.

Counterpart of the part of `sqrtlm_slam_tpu/lidar/odometry.py` that
camera+LiDAR fusion uses: world-frame corner and flat feature clouds are
voxel-downsampled (flat points keep the normal of their representative) and
indexed by voxel-hash grids for nearest-neighbour association. Scan-to-map
alignment (`align_scan`) and the standalone `LidarOdometry` class are not
ported yet (ROADMAP queue 1: standalone LiDAR odometry).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import voxel_map as vmap


class OdomConfig(NamedTuple):
    outer_iters: int = 5
    gn_iters: int = 3
    kf_window: int = 30
    map_cell: float = 0.8  # voxel cell of the NN grid (>= search radius)
    downsample_cell: float = 0.4  # map voxel filter leaf
    max_match_dist: float = 1.0
    corner_weight: float = 30.0
    flat_weight: float = 50.0
    kf_dist: float = 2.0
    kf_angle_deg: float = 5.0
    map_capacity: int = 8192  # downsampled local-map point budget
    damping: float = 1e-4


class LocalMap(NamedTuple):
    """Voxel-hash maps for both feature classes (world frame)."""

    corner: vmap.VoxelMap
    flat: vmap.VoxelMap  # payload = the normal (world frame)


def _voxel_downsample_payload(stacked, valid, cell, capacity):
    """voxel_downsample for points with payload columns (first 3 = xyz)."""
    return vmap.downsample_rows(stacked, valid, cell, capacity)


def build_local_map(corner_pts_w, corner_valid, flat_pts_w, flat_valid, flat_normals_w,
                    cfg: OdomConfig) -> LocalMap:
    """Downsample world-frame feature clouds and build the NN grids."""
    c_ds, c_ok = vmap.voxel_downsample(corner_pts_w, corner_valid, cfg.downsample_cell,
                                       cfg.map_capacity)
    corner = vmap.build(c_ds, c_ok, cfg.map_cell)
    f_ds6, f_ok = _voxel_downsample_payload(torch.cat([flat_pts_w, flat_normals_w], dim=-1),
                                            flat_valid, cfg.downsample_cell, cfg.map_capacity)
    flat = vmap.build(f_ds6[:, :3], f_ok, cfg.map_cell, payload=f_ds6[:, 3:])
    return LocalMap(corner=corner, flat=flat)
