"""LOAM-style LiDAR odometry: scan-to-local-map alignment + keyframe window.

Counterpart of `sqrtlm_slam_tpu/lidar/odometry.py` (`art::Odom`):
  * `build_local_map`: world-frame corner and flat feature clouds are
    voxel-downsampled (flat points keep the normal of their representative)
    and indexed by voxel-hash grids for nearest-neighbour association; the
    fusion path's tracker and LiDAR stage share it;
  * `align_scan`: 5 outer rounds of {voxel-hash NN association of the scan's
    sharp / flat features, 3 damped Gauss-Newton steps on SE(3) over the
    point-to-point and point-to-plane residuals}, with an optional DoF mask
    (`DOF_PRESETS`). The JAX package's `lax.scan` loops are Python loops;
    each 6x6 step is `solve_ex` (no error check, so no host read per step:
    the pose LM's solve, which the tracking graphs capture). As in the JAX
    package (`jax.jit`, static `cfg`), `align_scan` is the captured graph
    (`utils.cache.graphed`, one capture per `OdomConfig` and shape: the
    local map is downsampled to `map_capacity` and the features have fixed
    caps, so one capture serves every scan of a run); `align_scan.eager`
    is the op-by-op body;
  * `LidarOdometry`: the host-side loop with the keyframe policy (2 m / 5 deg),
    the 30-keyframe window (`slam`), unbounded growth (`mapping`), a fixed
    prior map (`localization`), and the SE(3) pose-graph backend over the
    recorded chain (`backend_for_loop`, `backend_for_gnss`).

The keyframe clouds stay on the device; `LidarOdometry` reads the device once
per scan (the keyframe test).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..factors import lidar as lf
from ..geometry import se3
from ..utils import cache, to_host
from . import features as feat
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


def _association(pose: se3.SE3, pts_s, valid, grid: vmap.VoxelMap, max_dist):
    """World-project sensor points and find their nearest map neighbour."""
    idx, _, ok = vmap.knn(grid, lf.point_world(pose, pts_s), k=1, max_dist=max_dist)
    return idx[:, 0], ok[:, 0] & valid


# DoF-restriction presets of the reference's per-DoF plane factors. Tangent
# order is [tx, ty, tz, rx, ry, rz] (se3.retract); a zero masks that DoF out
# of the solve.
DOF_PRESETS = {
    "z_rot_xy_trans": (1.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    "z_trans": (0.0, 0.0, 1.0, 0.0, 0.0, 0.0),
    "x_rot": (0.0, 0.0, 0.0, 1.0, 0.0, 0.0),
    "y_rot": (0.0, 0.0, 0.0, 0.0, 1.0, 0.0),
    "xy_rot_z_trans": (0.0, 0.0, 1.0, 1.0, 1.0, 0.0),
    "xyz_rot_xyz_trans": (1.0,) * 6,
}


@functools.lru_cache(maxsize=None)
def _dof_mask(mask: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A DoF mask (a `DOF_PRESETS` entry) as a (6,) tensor on `device`, made
    once per process (no host-to-device copy per scan: a captured graph
    takes none)."""
    return torch.tensor(mask, dtype=dtype, device=device)


def align_scan(pose0: se3.SE3, corner_pts: torch.Tensor, corner_valid: torch.Tensor,
               flat_pts: torch.Tensor, flat_valid: torch.Tensor, local_map: LocalMap,
               cfg: OdomConfig, dof_mask=None):
    """Scan-to-map alignment: outer re-association x inner damped GN.

    pose0: initial guess T_lw (world -> lidar). Returns (pose, {"chi2",
    "matches"}) on the device: the last GN step's chi2 (at the pose before
    that step) and the last round's associations. `dof_mask` (6,) (a
    tensor, or a `DOF_PRESETS` entry, kept on the device once per process)
    restricts the update to a DoF subset."""
    dev, dtype = pose0.t.device, pose0.t.dtype
    if isinstance(dof_mask, torch.Tensor):
        m = dof_mask.to(dtype)
    else:
        m = _dof_mask(tuple(dof_mask) if dof_mask is not None else (1.0,) * 6, dtype, dev)
    pin = torch.diag(1.0 - m)
    eye = torch.eye(6, dtype=dtype, device=dev)
    pose = pose0
    for _ in range(cfg.outer_iters):
        c_idx, c_ok = _association(pose, corner_pts, corner_valid, local_map.corner,
                                   cfg.max_match_dist)
        c_target = local_map.corner.points[c_idx]
        f_idx, f_ok = _association(pose, flat_pts, flat_valid, local_map.flat,
                                   cfg.max_match_dist)
        f_target = local_map.flat.points[f_idx]
        f_normal = local_map.flat.payload[f_idx]
        f_d = -torch.sum(f_normal * f_target, dim=-1)  # plane through the target
        wc = cfg.corner_weight * c_ok.to(dtype)
        wf = cfg.flat_weight * f_ok.to(dtype)
        for _ in range(cfg.gn_iters):
            rc, Jc = lf.point_residual_jac(pose, corner_pts, c_target)
            rf, Jf = lf.plane_residual_jac(pose, flat_pts, f_normal, f_d)
            H = (torch.einsum("eki,e,ekj->ij", Jc, wc, Jc)
                 + torch.einsum("ei,e,ej->ij", Jf, wf, Jf))
            b = (torch.einsum("eki,e,ek->i", Jc, wc, rc)
                 + torch.einsum("ei,e,e->i", Jf, wf, rf))
            chi2 = torch.sum(wc * torch.sum(rc * rc, dim=-1)) + torch.sum(wf * rf * rf)
            # DoF restriction: zero the masked rows / columns, pin their diagonal.
            H = H * m[:, None] * m[None, :] + pin
            b = b * m
            lam = cfg.damping * torch.clamp(torch.max(torch.abs(torch.diagonal(H))), min=1e-9)
            dx = torch.linalg.solve_ex(H + lam * eye, -b)[0]
            pose = se3.retract(pose, dx * m)
        matches = torch.sum(c_ok) + torch.sum(f_ok)
    return pose, {"chi2": chi2, "matches": matches}


align_scan = cache.graphed(align_scan, static_argnames=("cfg",))
# The scan's SE(3) bookkeeping around it (the constant-velocity guess, the
# velocity, the keyframe test's motion), ~100-180 operations each when
# eager, as graphs too.
_retract_jit = cache.graphed(se3.retract)
_local_delta_jit = cache.graphed(se3.local_delta)


class LidarOdometry:
    """Host side: keyframe window + scan alignment, on one device (the
    CUDA device unless the caller passes another, e.g. `device="cpu"`).

    Feed raw clouds (`process`) or pre-extracted features
    (`process_features`); get the world pose T_lw back. `mode` is `slam`
    (sliding window of `kf_window` keyframes), `mapping` (unbounded map
    growth) or `localization` (align against a fixed prior map, set with
    `set_prior_map`, never modified)."""

    def __init__(self, cfg: OdomConfig = OdomConfig(),
                 feat_cfg: feat.LidarConfig = feat.LidarConfig(), device="cuda"):
        self.cfg = cfg
        self.feat_cfg = feat_cfg
        self.device = torch.device(device)
        self.pose = se3.identity(device=self.device)  # T_lw (world -> lidar)
        self.last_kf_pose: Optional[se3.SE3] = None
        self.velocity = torch.zeros(6, device=self.device)  # constant-velocity model
        self.last_stats: Optional[dict] = None  # align_scan's stats of the last scan
        self._kf_corner: list = []  # world-frame (pts, valid) per keyframe
        self._kf_flat: list = []  # world-frame (pts, valid, normals)
        self._local_map: Optional[LocalMap] = None
        self._chain: list = []  # poses recorded for the backend
        self.num_keyframes = 0
        self.mode = "slam"

    # -- keyframe management ------------------------------------------------

    def _is_keyframe(self, pose: se3.SE3) -> bool:
        if self.last_kf_pose is None:
            return True
        d = to_host(_local_delta_jit(pose, self.last_kf_pose))
        return (float(math.hypot(*d[:3])) > self.cfg.kf_dist
                or float(math.hypot(*d[3:])) > math.radians(self.cfg.kf_angle_deg))

    def _insert_keyframe(self, pose: se3.SE3, f: feat.LidarFeatures):
        """World-frame corner (less-sharp) and flat clouds of this scan join
        the window; the local map is rebuilt from the window."""
        n_w = torch.einsum("ij,nj->ni", pose.R.transpose(-1, -2), f.flat_normal)
        self._kf_corner.append((lf.point_world(pose, f.less_sharp), f.less_sharp_valid))
        self._kf_flat.append((lf.point_world(pose, f.flat), f.flat_valid, n_w))
        if self.mode != "mapping" and len(self._kf_corner) > self.cfg.kf_window:
            self._kf_corner.pop(0)
            self._kf_flat.pop(0)
        self.last_kf_pose = pose
        self.num_keyframes += 1
        self._local_map = build_local_map(
            torch.cat([c for c, _ in self._kf_corner]), torch.cat([v for _, v in self._kf_corner]),
            torch.cat([p for p, _, _ in self._kf_flat]), torch.cat([v for _, v, _ in self._kf_flat]),
            torch.cat([n for _, _, n in self._kf_flat]), self.cfg)

    # -- main entry ---------------------------------------------------------

    def set_prior_map(self, corner_w, corner_valid, flat_w, flat_valid, flat_normals_w):
        """Load a fixed world-frame prior map (arrays or tensors) and enter
        localization mode."""
        def t(a, dtype=torch.float32):
            return torch.as_tensor(a).to(device=self.device, dtype=dtype)

        self._local_map = build_local_map(t(corner_w), t(corner_valid, torch.bool), t(flat_w),
                                          t(flat_valid, torch.bool), t(flat_normals_w), self.cfg)
        self.mode = "localization"

    def process(self, points, dof: Optional[str] = None) -> se3.SE3:
        """Track one raw LiDAR cloud (N, 3) in the sensor frame (an array or
        a tensor). The cloud is padded to a size bucket (`pad_cloud`), so
        scans of varying length replay one captured extraction graph."""
        pts = torch.as_tensor(feat.pad_cloud(points)).to(device=self.device)
        return self.process_features(feat.extract_features_jit(pts[:, :3], self.feat_cfg),
                                     dof=dof)

    def process_features(self, f: feat.LidarFeatures, dof: Optional[str] = None) -> se3.SE3:
        """Track one pre-extracted feature scan. `dof` optionally names a
        DOF_PRESETS entry restricting the solve."""
        if self._local_map is None:
            if self.mode == "localization":
                raise RuntimeError("localization mode requires set_prior_map()")
            self._insert_keyframe(self.pose, f)
            return self.pose
        guess = _retract_jit(self.pose, self.velocity)
        pose, self.last_stats = align_scan(
            guess, f.sharp, f.sharp_valid, f.flat, f.flat_valid, self._local_map, self.cfg,
            dof_mask=_dof_mask(DOF_PRESETS[dof] if dof is not None else (1.0,) * 6,
                               self.pose.t.dtype, self.device))
        self.velocity = _local_delta_jit(pose, self.pose)
        self.pose = pose
        if self.mode != "localization" and self._is_keyframe(pose):
            self._insert_keyframe(pose, f)
        return pose

    # -- backend (loop / GNSS pose graph) -----------------------------------

    def record_pose(self):
        """Append the current pose to the backend trajectory chain."""
        self._chain.append(self.pose)

    def _relax_chain(self, loop_edges, anchors, iters: int):
        from . import backend

        g = backend.build_chain_graph(self._chain, loop_edges, anchors=anchors)
        out, _ = backend.optimize_se3_graph(g, num_iters=iters)
        self._chain = [se3.SE3(out.R[k], out.t[k]) for k in range(len(self._chain))]
        self.pose = self._chain[-1]
        return self._chain

    def backend_for_loop(self, i: int, j: int, T_ji: se3.SE3, iters: int = 20):
        """Relax the recorded pose chain with a loop constraint T_ji between
        chain entries i and j. Returns the corrected chain and moves the
        current pose to its tail."""
        return self._relax_chain([(i, j, T_ji)], (), iters)

    def backend_for_gnss(self, anchors, iters: int = 20):
        """Relax the chain against world-position anchors
        [(chain index, xyz)]."""
        return self._relax_chain([], anchors, iters)
