"""Tracking: per-frame state machine driving the matching + pose stages.

Counterpart of `sqrtlm_slam_tpu/pipeline/tracking.py`:
  * depth initialization (the first frame with enough depth-carrying
    keypoints seeds the map; RGB-D, stereo, fusion);
  * `track_frame_step`: constant-velocity prediction, stage A window match
    + pose LM at `r_motion` (widened x2 when it finds too few inliers),
    stages B and C at `r_local`, the next velocity, the close-point
    keyframe counters and per-landmark visibility;
  * with LiDAR features on the frame and a LiDAR local map, stages B and C
    are `match_and_optimize_fused`: voxel-hash NN association of the
    frame's corner / flat features against the keyframe-window LiDAR map,
    then one pose optimization over reprojection, point-to-point and
    point-to-plane residuals;
  * `recover_pose_no_prior`: descriptor-only matching and the two PnP RANSAC
    banks, the seed when stage A finds too few inliers and the core of
    relocalisation (`Tracker._relocalize`: BoW candidates plus the last
    reference keyframe);
  * the LOST branch: a map of <= 5 keyframes is reset and re-initialised,
    a larger one is relocalised against;
  * keyframe policy and insertion into the shared numpy `MapStore`
    (skipped in localisation mode).

Device work stays on the frame's device; the host reads results twice per
frame in sync mode (the stage-A inlier count that decides the widened
retry, and one packed fetch of the step's results) and once in pipelined
mode (the packed fetch), once more per inserted keyframe (twice with LiDAR
features: their downsampled clouds), once per fallback, once per
relocalisation candidate tried, and, until a monocular map starts, twice
per frame (the match count, one packed read of the initializer).

On the card `track_frame_step` replays captured CUDA graphs (`utils.cache`,
the JAX package's jit): stage A, the widened stage A when the first finds
too few inliers, and stages B and C; the stage-A read sits between them.
Pipelined mode replays `_stage_a_both_jit` instead: stage A at both radii
in one graph, the result selected on the device by the inlier count (the
JAX `lax.cond`), so dispatching a step reads nothing. The packed results
are copied into pinned host memory right after the step is enqueued
(`utils.to_host_async`); consuming the step waits for that copy's event
alone, not for the work queued after it. `recover_pose_no_prior` (the
fallback and relocalisation) replays one graph, `_recover_pose_jit`, its
RANSAC uniforms drawn from the tracker's generator before it.

At every keyframe insertion the system's `vocab_hook` supplies the
keyframe's word ids and BoW vector (place recognition reads them).

A frame without any depth (monocular) initializes the map by the two-view
H/F initializer (`_initialize_mono`): a reference frame, a match, two
keyframes at median scene depth 1.

Pipelined mode (`TrackingConfig.pipelined`): in the steady state frame t's
results are read only after frame t+1's step has been dispatched
(`_track_pipelined`); pose and velocity chain on the device. LOST detection,
the no-prior fallback and keyframe insertion for frame t happen while t+1
is in flight; on a correction t+1 is dispatched again from the corrected
state. `flush` finalizes the deferred frame (the system calls it before any
read of the trajectory or the map). Frame t+1's device work runs while the
host consumes frame t.

With the system's asynchronous mapping worker, `map_lock` (a shared RLock,
a no-op context otherwise) guards the tracker's store-touching sections:
the local-map gathers, keyframe insertion, the trajectory record and the
visible / found counters.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..algorithm import pnp
from ..algorithm.ransac import top_k_sets
from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3
from ..lidar import odometry as lidar_odometry
from ..lidar import voxel_map
from ..mapstore import MapStore
from ..optim import pose_opt
from ..utils import cache, desc_to_numpy, desc_to_torch, to_host, to_host_async, wait_host
from . import initializer
from .frame import Frame


class TrackingConfig(NamedTuple):
    match_radius_motion: float = 15.0
    match_radius_local: float = 7.0
    min_matches_motion: int = 20  # the JAX package defines it and never reads it
    min_inliers_track: int = 10
    min_inliers_local: int = 30
    local_map_capacity: int = 2048
    local_kf_cap: int = 20
    init_min_depth_kp: int = 200
    kf_min_interval: int = 0
    kf_max_interval: int = 10
    kf_tracked_ratio: float = 0.75
    close_depth: float = 40.0
    kf_close_tracked: int = 100
    kf_close_untracked: int = 70
    max_landmarks_per_kf: int = 300
    # LiDAR tight coupling.
    lidar_min_map_pts: int = 100  # only couple if the local map is populated
    lidar_match_dist: float = 0.45  # NN gate (m)
    lidar_map_kfs: int = 10  # KFs aggregated into the LiDAR local map
    # Pyramid shape for the scale-aware projection search; MUST match the
    # extractor's ORBConfig (SlamSystem syncs them).
    num_levels: int = 8
    scale_factor: float = 1.2
    # Deferred-read steady-state tracking (see Tracker.track). Off by
    # default: the sync driver is deterministic and decides each frame
    # before the next.
    pipelined: bool = False


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class LocalMapBuffer(NamedTuple):
    """Fixed-capacity landmark buffer gathered from the store."""

    ids: np.ndarray  # (M,) landmark ids, host bookkeeping (-1 = empty)
    pos: torch.Tensor  # (M, 3)
    desc: torch.Tensor  # (M, 8) int32
    valid: torch.Tensor  # (M,)
    max_dist: torch.Tensor  # (M,) scale-invariance ceiling (inf = not set)


def _scale_aware_window(x_c, uv_pred, lm: LocalMapBuffer, frame: Frame, radius_px,
                        num_levels: int = 8, scale_factor: float = 1.2):
    """Projection window with scale-aware radius and a +-2 octave gate."""
    dist = torch.linalg.norm(x_c, dim=-1)
    pred = matching.predict_octave(dist, lm.max_dist, scale_factor=scale_factor,
                                   num_levels=num_levels)
    gate = torch.isfinite(lm.max_dist)
    radius = radius_px * torch.pow(scale_factor, pred.to(torch.float32))
    return matching.projection_window_mask(
        uv_pred, frame.kp.xy, radius, octave_pred=pred, octave_kp=frame.kp.octave,
        octave_gate=gate, level_slack=2,
    )


def match_and_optimize(pose_guess: se3.SE3, lm: LocalMapBuffer, frame: Frame, cam: Camera,
                       radius_px: float, num_levels: int = 8, scale_factor: float = 1.2):
    """One tracking stage: project landmarks, window-match, pose-only LM.
    Returns (pose, lm_match_idx (M,), lm_match_valid (M,), num_inliers)."""
    x_c = se3.act(pose_guess, lm.pos)
    uv_pred = cam.project(x_c)
    proj_ok = lm.valid & (x_c[..., 2] > 0.5)
    if radius_px > 0:
        window = _scale_aware_window(x_c, uv_pred, lm, frame, radius_px, num_levels,
                                     scale_factor)
        ratio, mutual, octave_t = 0.8, "claim", frame.kp.octave
    else:
        window = None
        proj_ok = lm.valid
        ratio, mutual, octave_t = 0.75, True, None
    res = matching.match_descriptors(
        lm.desc, frame.kp.desc, proj_ok, frame.kp.valid, window_mask=window,
        max_dist=matching.TH_HIGH, ratio=ratio, mutual=mutual, octave_t=octave_t,
    )
    idx = res.idx.long()
    obs = pose_opt.VisualObs(points_w=lm.pos, uvr=frame.uvr[idx],
                             inv_sigma2=frame.inv_sigma2[idx], valid=res.valid)
    result = pose_opt.optimize_pose(pose_guess, obs, cam)
    return result.pose, res.idx, res.valid & result.inlier_mask, result.num_inliers


def lidar_association(pose_guess: se3.SE3, c_pts, c_val, f_pts, f_val,
                      lidar_map: lidar_odometry.LocalMap, match_dist: float
                      ) -> pose_opt.LidarObs:
    """Associate camera-frame corner / flat features, placed in the world
    at `pose_guess`, with their nearest neighbour of the LiDAR local map
    (within `match_dist`): corners to points, flats to the neighbour's plane."""
    T_wc = se3.inverse(pose_guess)
    ci, _, cok = voxel_map.knn(lidar_map.corner, se3.act(T_wc, c_pts), k=1, max_dist=match_dist)
    fi, _, fok = voxel_map.knn(lidar_map.flat, se3.act(T_wc, f_pts), k=1, max_dist=match_dist)
    f_target = lidar_map.flat.points[fi[:, 0]]
    f_normal = lidar_map.flat.payload[fi[:, 0]]
    return pose_opt.LidarObs(
        flat_pts=f_pts, plane_n=f_normal, plane_d=-torch.sum(f_normal * f_target, dim=-1),
        flat_valid=fok[:, 0] & f_val,
        corner_pts=c_pts, corner_target=lidar_map.corner.points[ci[:, 0]],
        corner_valid=cok[:, 0] & c_val,
    )


def match_and_optimize_fused(pose_guess: se3.SE3, lm: LocalMapBuffer, frame: Frame,
                             cam: Camera, radius_px: float,
                             lidar_map: lidar_odometry.LocalMap, match_dist: float,
                             num_levels: int = 8, scale_factor: float = 1.2):
    """Tracking stage with LiDAR tight coupling: visual window matching, NN
    association of the frame's sharp / flat features against the LiDAR local
    map at the pose guess, then one fused pose optimization.
    Returns (pose, lm_match_idx, lm_match_valid, num_inliers, n_lidar)."""
    x_c = se3.act(pose_guess, lm.pos)
    uv_pred = cam.project(x_c)
    proj_ok = lm.valid & (x_c[..., 2] > 0.5)
    window = _scale_aware_window(x_c, uv_pred, lm, frame, radius_px, num_levels, scale_factor)
    res = matching.match_descriptors(
        lm.desc, frame.kp.desc, proj_ok, frame.kp.valid, window_mask=window,
        max_dist=matching.TH_HIGH, ratio=0.8, mutual="claim", octave_t=frame.kp.octave,
    )
    idx = res.idx.long()
    obs = pose_opt.VisualObs(points_w=lm.pos, uvr=frame.uvr[idx],
                             inv_sigma2=frame.inv_sigma2[idx], valid=res.valid)
    lf = frame.lidar
    lobs = lidar_association(pose_guess, lf.sharp, lf.sharp_valid, lf.flat, lf.flat_valid,
                             lidar_map, match_dist)
    n_lidar = torch.sum(lobs.flat_valid) + torch.sum(lobs.corner_valid)
    result = pose_opt.optimize_pose(pose_guess, obs, cam, lidar_obs=lobs)
    return (result.pose, res.idx, res.valid & result.inlier_mask, result.num_inliers,
            n_lidar)


def _stage_a(prev_pose: se3.SE3, velocity: torch.Tensor, lm: LocalMapBuffer, frame: Frame,
             cam: Camera, radius_px: float, num_levels: int = 8, scale_factor: float = 1.2):
    """Stage A: the constant-velocity prediction, then one tracking stage at
    `radius_px`. Returns `match_and_optimize`'s tuple."""
    guess = se3.retract(prev_pose, velocity)
    return match_and_optimize(guess, lm, frame, cam, radius_px, num_levels, scale_factor)


def _stages_bc(prev_pose: se3.SE3, poseA: se3.SE3, nA: torch.Tensor, lm: LocalMapBuffer,
               frame: Frame, cam: Camera, r_local: float, close_depth: float, lidar_map=None,
               match_dist: float = 0.45, num_levels: int = 8, scale_factor: float = 1.2):
    """Stages B and C from stage A's pose, the next velocity, the close-point
    counters and the packed results (see `track_frame_step`)."""
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    if lidar_map is not None:
        poseB = match_and_optimize_fused(poseA, lm, frame, cam, r_local, lidar_map,
                                         match_dist, **pyr)[0]
        pose, m_idx, m_valid, n_inl, n_lidar = match_and_optimize_fused(
            poseB, lm, frame, cam, r_local, lidar_map, match_dist, **pyr)
    else:
        poseB = match_and_optimize(poseA, lm, frame, cam, r_local, **pyr)[0]
        pose, m_idx, m_valid, n_inl = match_and_optimize(poseB, lm, frame, cam, r_local, **pyr)
        n_lidar = torch.zeros_like(n_inl)
    new_velocity = se3.local_delta(pose, prev_pose)

    close = (frame.depth > 0) & (frame.depth < close_depth)
    kp_tracked = torch.zeros(close.shape, dtype=torch.int32, device=close.device)
    kp_tracked = kp_tracked.scatter_reduce(0, m_idx.long(), m_valid.to(torch.int32),
                                           reduce="amax", include_self=True) > 0
    tracked_close = torch.sum(kp_tracked & close)
    total_close = torch.sum(close)

    x_vis = se3.act(pose, lm.pos)
    uv_vis = cam.project(x_vis)
    d_vis = torch.linalg.norm(x_vis, dim=-1)
    visible = (
        lm.valid
        & (x_vis[..., 2] > 0.3)
        & (uv_vis[:, 0] >= 0.0) & (uv_vis[:, 0] < 2.0 * cam.cx)
        & (uv_vis[:, 1] >= 0.0) & (uv_vis[:, 1] < 2.0 * cam.cy)
        & torch.where(torch.isfinite(lm.max_dist), d_vis < 1.25 * lm.max_dist,
                      torch.ones_like(lm.valid))
    )
    packed_i = torch.stack([m_idx.to(torch.int32), m_valid.to(torch.int32),
                            visible.to(torch.int32)])
    counts = torch.stack([n_inl, nA, n_lidar, tracked_close, total_close]).to(torch.float32)
    packed_f = torch.cat([pose.R.reshape(-1), pose.t, counts])
    return pose, new_velocity, packed_i, packed_f


def _stage_a_both(prev_pose: se3.SE3, velocity: torch.Tensor, lm: LocalMapBuffer,
                  frame: Frame, cam: Camera, radius_px: float, min_inliers: int,
                  num_levels: int = 8, scale_factor: float = 1.2):
    """Stage A at `radius_px` and at twice it, the second's result taken
    where the first finds fewer than `min_inliers` inliers: the widened
    retry decided on the device (the JAX step's `lax.cond`), at the cost of
    the wide stage A on every frame. Each output equals the retry's bits."""
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    first = _stage_a(prev_pose, velocity, lm, frame, cam, radius_px, **pyr)
    wide = _stage_a(prev_pose, velocity, lm, frame, cam, radius_px * 2, **pyr)
    retry = first[3] < min_inliers
    pose = se3.SE3(torch.where(retry, wide[0].R, first[0].R),
                   torch.where(retry, wide[0].t, first[0].t))
    return (pose,) + tuple(torch.where(retry, w, f) for f, w in zip(first[1:], wide[1:]))


# The step's device programs as captured CUDA graphs (`utils.cache`): stage
# A (captured once per radius: the retry widens it), stage A at both radii
# (pipelined mode), and stages B and C with the counters. The eager
# functions on the CPU.
_stage_a_jit = cache.graphed(_stage_a,
                             static_argnames=("cam", "radius_px", "num_levels", "scale_factor"))
_stage_a_both_jit = cache.graphed(_stage_a_both, static_argnames=(
    "cam", "radius_px", "min_inliers", "num_levels", "scale_factor"))
_stages_bc_jit = cache.graphed(_stages_bc, static_argnames=(
    "cam", "r_local", "close_depth", "match_dist", "num_levels", "scale_factor"))


def track_frame_step(prev_pose: se3.SE3, velocity: torch.Tensor, lm: LocalMapBuffer,
                     frame: Frame, cam: Camera, r_motion: float, r_local: float,
                     min_inliers: int, close_depth: float, lidar_map=None,
                     match_dist: float = 0.45, num_levels: int = 8,
                     scale_factor: float = 1.2):
    """The per-frame device computation (stages A, B, C + counters). With a
    `lidar_map`, stages B and C are the fused stage (C re-matches and
    re-associates from B's improved pose).

    Returns (pose, new_velocity, packed_i (3, M) int32 [match idx, match
    valid, frustum-visible], packed_f (17,) f32 [R.ravel(9), t(3), n_inliers,
    nA, n_lidar, tracked_close, total_close]), all on the device.

    On the card the step replays captured graphs: stage A, then, when it
    finds fewer than `min_inliers` inliers, stage A at twice the radius, then
    stages B and C. The JAX package's `lax.cond` on stage A's inlier count is
    the one host read between them; the device work is the eager step's."""
    lm = lm._replace(ids=None)  # host bookkeeping, not a graph input
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    frame_a = frame._replace(lidar=None)  # stage A matches visually only
    outA = _stage_a_jit(prev_pose, velocity, lm, frame_a, cam, r_motion, **pyr)
    if int(to_host(outA[3])) < min_inliers:
        outA = _stage_a_jit(prev_pose, velocity, lm, frame_a, cam, r_motion * 2, **pyr)
    poseA, _, _, nA = outA
    return _stages_bc_jit(prev_pose, poseA, nA, lm, frame, cam, r_local, close_depth,
                          lidar_map, match_dist, **pyr)


def _track_frame_step_no_read(prev_pose: se3.SE3, velocity: torch.Tensor, lm: LocalMapBuffer,
                              frame: Frame, cam: Camera, r_motion: float, r_local: float,
                              min_inliers: int, close_depth: float, lidar_map=None,
                              match_dist: float = 0.45, num_levels: int = 8,
                              scale_factor: float = 1.2):
    """`track_frame_step` with the retry decided on the device
    (`_stage_a_both_jit`): two graphs and no host read, for pipelined mode.
    The same results, bit for bit; stage A's device work twice."""
    lm = lm._replace(ids=None)
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    poseA, _, _, nA = _stage_a_both_jit(prev_pose, velocity, lm, frame._replace(lidar=None),
                                        cam, r_motion, min_inliers, **pyr)
    return _stages_bc_jit(prev_pose, poseA, nA, lm, frame, cam, r_local, close_depth,
                          lidar_map, match_dist, **pyr)


def recover_pose_no_prior(lm: LocalMapBuffer, frame: Frame, cam: Camera,
                          generator: Optional[torch.Generator] = None,
                          sel3: Optional[torch.Tensor] = None,
                          sel2: Optional[torch.Tensor] = None):
    """Pose recovery without a motion prior: descriptor-only matching, then
    both RANSAC banks (3D-3D Horn on depth-carrying matches, 2D-3D DLT on all
    matches), keeping the one with more inliers (3D-3D on a tie). The pose
    LM cannot pull a pose in from 50+ px of initial error; this closed-form
    estimate seeds it instead. `sel3` (H, 3) / `sel2` (H, 6) replace the
    minimal sets drawn from `generator`. Returns (pose, num_inliers), both
    on the device.

    The uniforms of the minimal sets are drawn here, outside any graph, in
    the eager order (the 3D-3D bank's, then the 2D-3D bank's); the match,
    the sets, both banks and the selection are one captured graph on the
    card (`_recover_pose_jit`, the JAX package's jit). Calls given `sel3` or
    `sel2` run eagerly."""
    shape, dev = (pnp.NUM_HYPOTHESES, lm.desc.shape[0]), lm.desc.device
    u3 = None if sel3 is not None else torch.rand(shape, generator=generator, device=dev)
    u2 = None if sel2 is not None else torch.rand(shape, generator=generator, device=dev)
    fn = _recover_pose_jit if sel3 is None and sel2 is None else _recover_pose
    return fn(lm.pos, lm.desc, lm.valid, frame.kp.xy, frame.kp.desc, frame.kp.valid,
              frame.depth, frame.inv_sigma2, u3, u2, sel3, sel2, cam)


def _recover_pose(lm_pos, lm_desc, lm_valid, kp_xy, kp_desc, kp_valid, depth_kp, inv_sigma2,
                  u3, u2, sel3, sel2, cam: Camera):
    """`recover_pose_no_prior` on the frame's and the local map's tensors,
    each bank's minimal sets from its uniforms (u3, u2) or given (sel3,
    sel2)."""
    res = matching.match_descriptors(lm_desc, kp_desc, lm_valid, kp_valid,
                                     max_dist=matching.TH_HIGH, ratio=0.9, mutual=True)
    idx = res.idx.long()
    depth = depth_kp[idx]
    uv = kp_xy[idx]
    is2 = inv_sigma2[idx]
    pts_c = torch.stack([(uv[:, 0] - cam.cx) * depth / cam.fx,
                         (uv[:, 1] - cam.cy) * depth / cam.fy, depth], dim=-1)
    valid3 = res.valid & (depth > 0)
    if sel3 is None:
        sel3 = top_k_sets(u3, valid3, k=3)
    if sel2 is None:
        sel2 = top_k_sets(u2, res.valid, k=6)
    out3 = pnp.ransac_pose_3d3d(lm_pos, pts_c, uv, valid3, is2, cam, sel=sel3)
    out2 = pnp.ransac_pnp_2d3d(lm_pos, uv, res.valid, is2, cam, sel=sel2)
    use3 = out3.num_inliers >= out2.num_inliers
    pose = se3.SE3(torch.where(use3, out3.pose.R, out2.pose.R),
                   torch.where(use3, out3.pose.t, out2.pose.t))
    return pose, torch.maximum(out3.num_inliers, out2.num_inliers)


# One capture per local-map capacity and keypoint count serves every
# recovery of a run.
_recover_pose_jit = cache.graphed(_recover_pose, static_argnames=("cam",))


def aggregate_kf_lidar(store: MapStore, kfs, n_slots: int):
    """World-frame corner / flat clouds of up to `n_slots` keyframes, from
    their stored keyframe-frame clouds and current poses, in fixed-capacity
    numpy arrays: (corner, corner_valid, flat, flat_normal, flat_valid)."""
    Nc, Nf = store.corner_per_kf, store.flat_per_kf
    corner = np.zeros((n_slots * Nc, 3), np.float32)
    corner_v = np.zeros(n_slots * Nc, bool)
    flat = np.zeros((n_slots * Nf, 3), np.float32)
    flat_n = np.zeros((n_slots * Nf, 3), np.float32)
    flat_v = np.zeros(n_slots * Nf, bool)
    for i, k in enumerate(kfs[:n_slots]):
        R, t = store.kf_R[k], store.kf_t[k]
        corner[i * Nc:(i + 1) * Nc] = (store.kf_corner[k] - t) @ R  # R^T (p - t)
        corner_v[i * Nc:(i + 1) * Nc] = store.kf_corner_valid[k]
        flat[i * Nf:(i + 1) * Nf] = (store.kf_flat[k] - t) @ R
        flat_n[i * Nf:(i + 1) * Nf] = store.kf_flat_normal[k] @ R
        flat_v[i * Nf:(i + 1) * Nf] = store.kf_flat_valid[k]
    return corner, corner_v, flat, flat_n, flat_v


def local_map_from_clouds(clouds, device) -> lidar_odometry.LocalMap:
    """Upload `aggregate_kf_lidar`'s arrays and build the voxel-hash maps."""
    corner, corner_v, flat, flat_n, flat_v = (torch.as_tensor(a, device=device)
                                              for a in clouds)
    return lidar_odometry.build_local_map(corner, corner_v, flat, flat_v, flat_n,
                                          lidar_odometry.OdomConfig())


class Tracker:
    """Host-side tracking state machine (one instance per SLAM system)."""

    def __init__(self, store: MapStore, cam: Camera, cfg: TrackingConfig = TrackingConfig(),
                 device="cuda"):
        self.store = store
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = TrackState.NOT_INITIALIZED
        self.pose = se3.identity(device=self.device)  # T_cw of the last tracked frame
        self.velocity = torch.zeros(6, device=self.device)
        self.ref_kf: int = -1
        self.frames_since_kf = 0
        self.frame_idx = -1
        self.last_inliers = 0
        self.frames_lost = 0
        self.localization_only = False  # track the frozen map, insert no keyframe
        self.last_lidar_matches = 0  # tight-coupling association count
        self.reloc_candidates_tried = 0  # by the last relocalisation attempt
        # Minimal sets of the RANSAC banks (fallback and relocalisation).
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(42)
        # (frame_id, ref_kf, R_rel, t_rel) per tracked frame.
        self.trajectory: list = []
        self.last_lm_ids: Optional[np.ndarray] = None
        self.new_kf_callback = None
        # Set by the system: (desc, valid) -> (words, bow) device tensors, or
        # (None, None) while no vocabulary exists.
        self.vocab_hook = None
        self.reloc_db = None  # KeyFrameDatabase set by the system
        self._init_ref: Optional[Frame] = None  # monocular initialization reference
        # Device-resident local map, cached until the map mutates.
        self._lm_cache_key = None
        self._lm_cache: Optional[LocalMapBuffer] = None
        self._lidar_cache_key = None
        self._lidar_cache: Optional[lidar_odometry.LocalMap] = None
        # The map lock: the system's RLock under asynchronous mapping.
        self.map_lock = contextlib.nullcontext()
        # Pipelined mode: the newest dispatched step, consumed at the next
        # track() or flush().
        self._pending = None

    # ------------------------------------------------------------------

    def _gather_local_map(self) -> LocalMapBuffer:
        """Local map = landmarks of ref KF + its best covisible KFs, cached
        on the device across frames until the store's version changes."""
        key = (self.ref_kf, self.store.version)
        if self._lm_cache_key == key:
            return self._lm_cache
        cap = self.cfg.local_map_capacity
        with self.map_lock:
            kfs = [self.ref_kf] + list(self.store.best_covisible(self.ref_kf,
                                                                 self.cfg.local_kf_cap))
            lm_ids = np.unique(self.store.kf_obs_lm[kfs])
            lm_ids = lm_ids[(lm_ids >= 0)]
            lm_ids = lm_ids[self.store.lm_valid[lm_ids]]
            if len(lm_ids) > cap:
                lm_ids = lm_ids[-cap:]  # newest landmarks: freshest descriptors
            buf = self._buffer_from_ids(lm_ids)
        self._lm_cache_key = key
        self._lm_cache = buf
        return buf

    def held_landmarks(self) -> list:
        """The arrays of landmark ids the tracker keeps across frames: the
        last frame's matches and the local map cached or of a pipelined
        step in flight (one buffer or two). Their rows are kept when the
        system compacts the store, dead or not, and `remap_landmarks`
        renumbers them in place."""
        buffers = {id(b): b.ids for b in (self._lm_cache, self._pending and self._pending[2])
                   if b is not None and b.ids is not None}
        held = list(buffers.values())
        if self.last_lm_ids is not None:
            held.append(self.last_lm_ids[:, 0])
        return held

    def remap_landmarks(self, remap: np.ndarray):
        """Renumber the held ids after `mapstore.compact_landmarks`."""
        for ids in self.held_landmarks():
            bound = ids >= 0
            ids[bound] = remap[ids[bound]]

    def _buffer_from_ids(self, lm_ids: np.ndarray) -> LocalMapBuffer:
        cap = self.cfg.local_map_capacity
        n = len(lm_ids)
        ids = np.full(cap, -1, np.int32)
        pos = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        valid = np.zeros(cap, bool)
        max_dist = np.full(cap, np.inf, np.float32)
        ids[:n] = lm_ids
        pos[:n] = self.store.lm_pos[lm_ids]
        desc[:n] = self.store.lm_desc[lm_ids]
        valid[:n] = True
        max_dist[:n] = self.store.lm_max_dist[lm_ids]
        dev = self.device
        return LocalMapBuffer(
            ids=ids,
            pos=torch.as_tensor(pos, device=dev),
            desc=desc_to_torch(desc, dev),
            valid=torch.as_tensor(valid, device=dev),
            max_dist=torch.as_tensor(max_dist, device=dev),
        )

    # ------------------------------------------------------------------

    def _gather_lidar_local_map(self) -> Optional[lidar_odometry.LocalMap]:
        """World-frame voxel-hash maps of the corner / flat clouds stored on
        the reference keyframe and its best covisible keyframes; None while
        they hold fewer than `lidar_min_map_pts` points. Cached on the
        device until the store's version changes."""
        key = (self.ref_kf, self.store.version)
        if self._lidar_cache_key == key:
            return self._lidar_cache
        store, cfg = self.store, self.cfg
        with self.map_lock:
            kfs = [self.ref_kf] + [int(x) for x in store.best_covisible(self.ref_kf,
                                                                        cfg.lidar_map_kfs)]
            kfs = [k for k in kfs if k >= 0 and store.kf_corner_valid[k].any()]
            clouds = aggregate_kf_lidar(store, kfs, cfg.lidar_map_kfs + 1) if kfs else None
        out = None
        if clouds is not None:
            if int(clouds[1].sum()) + int(clouds[4].sum()) >= cfg.lidar_min_map_pts:
                out = local_map_from_clouds(clouds, self.device)
        self._lidar_cache_key = key
        self._lidar_cache = out
        return out

    def _store_kf_lidar(self, kf: int, frame: Frame):
        """Downsample the frame's features into the keyframe's cloud slots
        (flat points keep their fitted normals); one packed read."""
        lf = frame.lidar
        store = self.store
        c_ds, c_ok = voxel_map.voxel_downsample(lf.less_sharp, lf.less_sharp_valid, 0.4,
                                                store.corner_per_kf)
        f6, f_ok = lidar_odometry._voxel_downsample_payload(
            torch.cat([lf.flat, lf.flat_normal], dim=-1), lf.flat_valid, 0.4,
            store.flat_per_kf)
        c_ds, c_ok, f6, f_ok = to_host(c_ds, c_ok, f6, f_ok)
        store.set_kf_lidar(kf, c_ds, c_ok, f6[:, :3], f6[:, 3:], f_ok)

    def _initialize(self, frame: Frame) -> bool:
        """Depth initialization: enough depth-carrying keypoints seed the map.
        A frame without any depth goes to the monocular two-view
        initialization; one with some depth but too little waits."""
        depth_ok, kp_ok = to_host(frame.depth > 0, frame.kp.valid)
        usable = depth_ok & kp_ok
        if usable.sum() < self.cfg.init_min_depth_kp:
            if depth_ok.sum() == 0:
                return self._initialize_mono(frame, int(kp_ok.sum()))
            return False
        self.pose = se3.identity(device=self.device)
        self._insert_keyframe(frame)
        self.state = TrackState.OK
        self.last_inliers = int(usable.sum())
        self._record_trajectory()
        return True

    def _initialize_mono(self, frame: Frame, n_valid: Optional[int] = None) -> bool:
        """Monocular two-view initialization: hold a reference frame (>= 100
        valid keypoints), match it (100 px window, TH_LOW, ratio 0.9, mutual,
        rotation consistency; the reference resets below 100 matches), run
        the H/F initializer, scale the map to median depth 1, and seed it
        with two keyframes and the triangulated landmarks. `n_valid` is the
        frame's valid keypoint count when the caller has read it. One host
        read for the matches, one packed read of the initializer's result."""
        if self._init_ref is None:
            if n_valid is None:
                n_valid = int(to_host(frame.kp.valid.sum()))
            if n_valid >= 100:
                self._init_ref = frame
            return False
        ref = self._init_ref
        window = matching.projection_window_mask(ref.kp.xy, frame.kp.xy, 100.0)
        res = matching.match_descriptors(
            ref.kp.desc, frame.kp.desc, ref.kp.valid, frame.kp.valid, window_mask=window,
            max_dist=matching.TH_LOW, ratio=0.9, mutual=True,
            angles=(ref.kp.angle, frame.kp.angle))
        if int(to_host(res.valid.sum())) < 100:
            self._init_ref = frame  # the reference resets when matching fails
            return False
        init = initializer.initialize_two_view(ref.kp.xy, frame.kp.xy[res.idx.long()],
                                               res.valid, self.cam, generator=self._generator)
        ok, good, pts, R, t, idx2 = to_host(init.success, init.good, init.points_w,
                                             init.T_21.R, init.T_21.t, res.idx)
        if not bool(ok):
            return False
        # Scale normalization: median scene depth -> 1.
        med = float(np.median(pts[good][:, 2]))
        if med <= 0:
            return False
        pts = pts / med
        t = t / med

        # Keyframe 1 at the identity, keyframe 2 at T21.
        self.last_lm_ids = None
        self.pose = se3.identity(device=self.device)
        kf1 = self._insert_keyframe(ref, pose_R_h=np.eye(3, dtype=np.float32),
                                    pose_t_h=np.zeros(3, np.float32))
        self.pose = se3.SE3(torch.as_tensor(R, device=self.device),
                            torch.as_tensor(t, device=self.device))
        kf2 = self._insert_keyframe(frame, pose_R_h=R, pose_t_h=t)
        store = self.store
        for i in np.where(good)[0]:
            if store.num_lm >= store.max_landmarks:
                break
            lm = store.add_landmark(pts[i], store.kf_desc[kf1][i], kf1)
            store.add_observation(lm, kf1, int(i))
            store.add_observation(lm, kf2, int(idx2[i]))
        store.update_connections(kf1)
        store.update_connections(kf2)
        new_lms = store.kf_obs_lm[kf2]
        store.update_landmark_stats(new_lms[new_lms >= 0])

        self.state = TrackState.OK
        self.last_inliers = int(good.sum())
        self.velocity = torch.zeros(6, device=self.device)
        self._init_ref = None
        self._record_trajectory(R, t)
        return True

    def _insert_keyframe(self, frame: Frame, pose_R_h=None, pose_t_h=None,
                         frame_id=None) -> int:
        """Create a keyframe + landmarks from depth (CreateNewKeyFrame): new
        landmarks come from depth-carrying keypoints not already matched to
        the map, nearest-first, capped. One packed read of the frame and its
        words and BoW vector. Holds the map lock."""
        with self.map_lock:
            return self._insert_keyframe_locked(frame, pose_R_h, pose_t_h, frame_id)

    def _insert_keyframe_locked(self, frame: Frame, pose_R_h=None, pose_t_h=None,
                                frame_id=None) -> int:
        store = self.store
        kp = frame.kp
        words = bow = None
        if self.vocab_hook is not None:
            words, bow = self.vocab_hook(kp.desc, kp.valid)
        pf = torch.cat([kp.xy, frame.uvr, frame.depth[:, None], kp.angle[:, None]], dim=-1)
        pi = torch.cat([kp.desc, kp.octave[:, None].to(torch.int32),
                        kp.valid[:, None].to(torch.int32)], dim=-1)
        ps = torch.cat([self.pose.R.reshape(-1), self.pose.t])
        if words is not None:
            pf, pi, ps, words, bow = to_host(pf, pi, ps, words, bow)
        else:
            pf, pi, ps = to_host(pf, pi, ps)
        xy, uvr, depth_a, angle = pf[:, :2], pf[:, 2:5], pf[:, 5], pf[:, 6]
        desc = desc_to_numpy(np.ascontiguousarray(pi[:, :8]))
        octave = pi[:, 8].astype(np.int32)
        kp_valid = pi[:, 9].astype(bool)
        if pose_R_h is not None:
            R, t = pose_R_h, pose_t_h
        else:
            R, t = ps[:9].reshape(3, 3), ps[9:12]
        kf = store.add_keyframe(
            R=np.asarray(R), t=np.asarray(t), xy=xy, uvr=uvr, depth=depth_a, desc=desc,
            angle=angle, octave=octave, kp_valid=kp_valid, words=words, bow=bow,
            frame_id=self.frame_idx if frame_id is None else frame_id,
        )

        matched_kp = set()
        if self.last_lm_ids is not None:
            for lm_id, kp_idx in self.last_lm_ids:
                store.add_observation(int(lm_id), kf, int(kp_idx))
                matched_kp.add(int(kp_idx))

        depth = depth_a
        valid = kp_valid & (depth > 0)
        cand = [i for i in np.argsort(np.where(valid, depth, np.inf))
                if valid[i] and i not in matched_kp]
        R = np.asarray(R)
        t = np.asarray(t)
        T_wc_R = R.T
        C = -R.T @ t
        n_new = 0
        for i in cand:
            if n_new >= self.cfg.max_landmarks_per_kf:
                break
            z = depth[i]
            x_cam = np.array(
                [(xy[i, 0] - self.cam.cx) * z / self.cam.fx,
                 (xy[i, 1] - self.cam.cy) * z / self.cam.fy, z],
                np.float32,
            )
            pos_w = T_wc_R @ x_cam + C
            lm = store.add_landmark(pos_w, desc[i], kf)
            store.add_observation(lm, kf, int(i))
            n_new += 1

        store.update_connections(kf)
        new_lms = store.kf_obs_lm[kf]
        store.update_landmark_stats(new_lms[new_lms >= 0])
        if frame.lidar is not None:
            self._store_kf_lidar(kf, frame)
        self.ref_kf = kf
        self.frames_since_kf = 0
        if self.new_kf_callback is not None:
            self.new_kf_callback(kf)
        return kf

    # ------------------------------------------------------------------

    def _need_keyframe(self, num_inliers: int, tracked_close: int,
                       untracked_close: int) -> bool:
        """Keyframe policy ((c1a||c1b||c1c)&&c2 + close-point rule)."""
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        min_obs = 3 if self.store.num_kf > 2 else 2
        ref_lms = self.store.kf_obs_lm[self.ref_kf]
        ref_lms = ref_lms[ref_lms >= 0]
        ref_obs = int((self.store.lm_n_obs[ref_lms] >= min_obs).sum())
        weak = num_inliers < self.cfg.kf_tracked_ratio * max(ref_obs, 1)
        close_rule = (tracked_close < self.cfg.kf_close_tracked
                      and untracked_close > self.cfg.kf_close_untracked)
        return (weak or close_rule) and num_inliers > 15

    def _relocalize(self, frame: Frame) -> bool:
        """Try the BoW relocalisation candidates (plus the last reference
        keyframe): recover a pose against each one's local landmarks until
        one finds `min_inliers_track` inliers (one host read per candidate
        tried). On success the pose and reference keyframe are reset and the
        normal stages refine this frame."""
        cand = [self.ref_kf]
        if self.reloc_db is not None and self.vocab_hook is not None:
            _, bow = self.vocab_hook(frame.kp.desc, frame.kp.valid)
            if bow is not None:
                cand = self.reloc_db.detect_reloc_candidates(to_host(bow))[:5] + cand
        cap = self.cfg.local_map_capacity
        self.reloc_candidates_tried = 0
        for kf in cand:
            if kf < 0 or not self.store.kf_valid[kf]:
                continue
            kfs = [kf] + [int(x) for x in self.store.best_covisible(kf, 10)]
            lm_ids = np.unique(self.store.kf_obs_lm[kfs])
            lm_ids = lm_ids[lm_ids >= 0]
            lm_ids = lm_ids[self.store.lm_valid[lm_ids]][-cap:]  # newest ids
            if len(lm_ids) < 30:
                continue
            self.reloc_candidates_tried += 1
            pose, n = recover_pose_no_prior(self._buffer_from_ids(lm_ids), frame, self.cam,
                                            generator=self._generator)
            if int(to_host(n)) >= self.cfg.min_inliers_track:
                self.pose = pose
                self.velocity = torch.zeros(6, device=self.device)
                self.ref_kf = kf
                self.state = TrackState.OK
                self.frames_lost = 0
                return True
        return False

    def _record_trajectory(self, pose_R_h=None, pose_t_h=None, frame_idx=None):
        """Store T_cur_ref = T_cw · T_ref_w^{-1} (relative to ref KF)."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        if pose_R_h is None:
            pose_R_h, pose_t_h = to_host(self.pose.R, self.pose.t)
        pose_R_h = np.asarray(pose_R_h)
        pose_t_h = np.asarray(pose_t_h)
        with self.map_lock:
            R_ref = self.store.kf_R[self.ref_kf].copy()
            t_ref = self.store.kf_t[self.ref_kf].copy()
        R_rel = pose_R_h @ R_ref.T
        t_rel = pose_t_h - R_rel @ t_ref
        self.trajectory.append((frame_idx, self.ref_kf, R_rel, t_rel))

    # ------------------------------------------------------------------

    def track(self, frame: Frame) -> Optional[se3.SE3]:
        """Track one frame; returns the frame pose T_cw (None while
        uninitialized or lost).

        With `cfg.pipelined` the steady state reads frame t's results only
        after frame t+1's step is dispatched, so the returned pose is the
        dispatched one, not yet checked: LOST, the fallback and keyframe
        insertion for a frame come one call later (see the module
        docstring)."""
        self.frame_idx += 1
        self.frames_since_kf += 1
        if self.cfg.pipelined and self.state == TrackState.OK:
            return self._track_pipelined(frame)
        self.flush()
        return self._track_sync(frame)

    def _track_sync(self, frame: Frame) -> Optional[se3.SE3]:
        if self.state == TrackState.NOT_INITIALIZED:
            return self.pose if self._initialize(frame) else None
        if self.state == TrackState.LOST:
            if self.store.num_kf <= 5:
                # Lost soon after init with a tiny map: reset and re-init.
                with self.map_lock:
                    self.store.reset()
                self.state = TrackState.NOT_INITIALIZED
                self.ref_kf = -1
                self.trajectory.clear()
                self.last_lm_ids = None
                return self.pose if self._initialize(frame) else None
            # BoW candidate keyframes -> RANSAC against their local
            # landmarks -> re-seeded tracking of this frame.
            if not self._relocalize(frame):
                self.frames_lost += 1
                return None
        return self._track_steady(frame)

    def _step(self, pose: se3.SE3, velocity: torch.Tensor, lm_buffer, lidar_map, frame):
        """The frame's step; in pipelined mode without the stage-A read."""
        cfg = self.cfg
        step = _track_frame_step_no_read if cfg.pipelined else track_frame_step
        return step(
            pose, velocity, lm_buffer, frame, self.cam, cfg.match_radius_motion,
            cfg.match_radius_local, cfg.min_inliers_track, cfg.close_depth,
            lidar_map=lidar_map, match_dist=cfg.lidar_match_dist,
            num_levels=cfg.num_levels, scale_factor=cfg.scale_factor,
        )

    def _dispatch_step(self, frame: Frame) -> tuple:
        """Launch the frame's step from the current pose and velocity, and
        the copy of its packed results to the host (`to_host_async`); returns
        what `_consume_step` needs: (frame, frame index, local map, LiDAR map,
        pose, velocity, the packed results' copy, previous pose)."""
        lm_buffer = self._gather_local_map()
        lidar_map = self._gather_lidar_local_map() if frame.lidar is not None else None
        pose, velocity, packed_i, packed_f = self._step(self.pose, self.velocity, lm_buffer,
                                                        lidar_map, frame)
        return (frame, self.frame_idx, lm_buffer, lidar_map, pose, velocity,
                to_host_async(packed_i, packed_f), self.pose)

    def _track_steady(self, frame: Frame) -> Optional[se3.SE3]:
        """Synchronous steady-state frame: dispatch, then consume at once."""
        ok, _ = self._consume_step(self._dispatch_step(frame), commit_pose=True)
        return self.pose if ok else None

    def _track_pipelined(self, frame: Frame) -> Optional[se3.SE3]:
        """Deferred-read steady state: dispatch frame t+1 first, then
        finalize frame t's step."""
        cur = self._dispatch_step(frame)
        prev, self._pending = self._pending, cur
        self.pose, self.velocity = cur[4], cur[5]  # chained on the device
        if prev is not None:
            ok, corrected = self._consume_step(prev, commit_pose=False)
            if not ok or corrected:
                # The in-flight step chained off a lost or replaced pose.
                self._pending = None
                if self.state == TrackState.OK:
                    return self._track_steady(frame)  # again, from the corrected pose
                return None  # lost at frame t; t+1 relocalises at the next call
        return self.pose

    def flush(self) -> None:
        """Finalize the deferred frame of pipelined mode (no-op otherwise, and
        when called again). Run it before reading the trajectory or state."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._consume_step(prev, commit_pose=False)

    def _consume_step(self, pending: tuple, commit_pose: bool):
        """Read + host bookkeeping of one dispatched step. Returns (ok,
        corrected): ok is False when tracking was lost at this frame;
        corrected is True when the no-prior fallback replaced the pose (a
        step chained off the original dispatch must be dispatched again).
        `commit_pose` makes the step's pose and velocity the tracker's
        (sync mode; pipelined mode has chained them already)."""
        frame, frame_idx, lm_buffer, lidar_map, pose, velocity, packed, prev_pose = pending
        packed_i, packed_f = wait_host(packed)
        corrected = False
        if int(packed_f[13]) < self.cfg.min_inliers_track:  # nA
            # No-prior fallback: descriptor-only match + RANSAC seed, then the
            # whole step again from the seed with zero velocity.
            seed_pose, n_ransac = recover_pose_no_prior(lm_buffer, frame, self.cam,
                                                        generator=self._generator)
            if int(to_host(n_ransac)) >= self.cfg.min_inliers_track:
                pose, _, packed_i, packed_f = self._step(
                    seed_pose, torch.zeros(6, device=self.device), lm_buffer, lidar_map, frame)
                # The step's own velocity is local_delta(final, seed), the LM
                # refinement only. The motion model needs the motion between
                # the last two frame poses, or the next prediction lags by
                # the whole motion and the fallback fires again.
                velocity = se3.local_delta(pose, prev_pose)
                packed_i, packed_f = to_host(packed_i, packed_f)
                corrected = True

        pose_R_h = packed_f[:9].reshape(3, 3)
        pose_t_h = packed_f[9:12]
        n = int(packed_f[12])
        tracked_close = int(packed_f[15])
        untracked_close = int(packed_f[16]) - tracked_close
        if lidar_map is not None:
            self.last_lidar_matches = int(packed_f[14])

        if n < self.cfg.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = torch.zeros(6, device=self.device)
            return False, True

        ids = lm_buffer.ids
        mi, mv = packed_i[0], packed_i[1].astype(bool)
        sel = mv & (ids >= 0)
        self.last_lm_ids = np.stack([ids[sel], mi[sel]], axis=-1)
        vis = packed_i[2].astype(bool) & (ids >= 0)
        with self.map_lock:
            self.store.lm_visible[ids[vis]] += 1
            self.store.lm_found[ids[sel]] += 1

        if commit_pose or corrected:
            self.velocity = velocity
            self.pose = pose
        self.state = TrackState.OK
        self.last_inliers = n
        if not self.localization_only and self._need_keyframe(n, tracked_close,
                                                              untracked_close):
            self._insert_keyframe(frame, pose_R_h=pose_R_h, pose_t_h=pose_t_h,
                                  frame_id=frame_idx)
        self._record_trajectory(pose_R_h, pose_t_h, frame_idx=frame_idx)
        return True, corrected
