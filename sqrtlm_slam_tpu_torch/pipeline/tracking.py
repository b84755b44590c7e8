"""Tracking: per-frame state machine driving the matching + pose stages.

Counterpart of `sqrtlm_slam_tpu/pipeline/tracking.py` in sync mode, RGB-D:
  * depth initialization (the first frame with enough depth-carrying
    keypoints seeds the map);
  * `track_frame_step`: constant-velocity prediction, stage A window match
    + pose LM at `r_motion` (widened x2 when it finds too few inliers),
    stages B and C at `r_local`, the next velocity, the close-point
    keyframe counters and per-landmark visibility;
  * keyframe policy and insertion into the shared numpy `MapStore`.

Device work stays on the frame's device; the host reads results twice per
frame (the stage-A inlier count that decides the widened retry, and one
packed fetch of the step's results) plus once per inserted keyframe.

At every keyframe insertion the system's `vocab_hook` supplies the
keyframe's word ids and BoW vector (place recognition reads them).

Not ported yet (they raise `NotImplementedError`): the no-prior pose
recovery and relocalisation, which need PnP RANSAC (ROADMAP queue 1,
item 9), monocular initialization (item 8), LiDAR coupling (item 7) and the
pipelined mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3
from ..mapstore import MapStore
from ..optim import pose_opt
from ..utils import desc_to_numpy, desc_to_torch, to_host
from .frame import Frame

_NOT_PORTED_RELOC = (
    "is not ported yet: it needs PnP RANSAC "
    "(ROADMAP queue 1, item 9: relocalisation and PnP)"
)


class TrackingConfig(NamedTuple):
    match_radius_motion: float = 15.0
    match_radius_local: float = 7.0
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
    # Pyramid shape for the scale-aware projection search; MUST match the
    # extractor's ORBConfig (SlamSystem syncs them).
    num_levels: int = 8
    scale_factor: float = 1.2


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


def track_frame_step(prev_pose: se3.SE3, velocity: torch.Tensor, lm: LocalMapBuffer,
                     frame: Frame, cam: Camera, r_motion: float, r_local: float,
                     min_inliers: int, close_depth: float, num_levels: int = 8,
                     scale_factor: float = 1.2):
    """The per-frame device computation (stages A, B, C + counters).

    Returns (pose, new_velocity, packed_i (3, M) int32 [match idx, match
    valid, frustum-visible], packed_f (17,) f32 [R.ravel(9), t(3), n_inliers,
    nA, n_lidar (0), tracked_close, total_close]), all on the device. The
    JAX package's `lax.cond` on the stage-A inlier count is one host read."""
    guess = se3.retract(prev_pose, velocity)
    pyr = dict(num_levels=num_levels, scale_factor=scale_factor)
    outA = match_and_optimize(guess, lm, frame, cam, r_motion, **pyr)
    if int(to_host(outA[3])) < min_inliers:
        outA = match_and_optimize(guess, lm, frame, cam, r_motion * 2, **pyr)
    poseA, _, _, nA = outA
    poseB, _, _, _ = match_and_optimize(poseA, lm, frame, cam, r_local, **pyr)
    pose, m_idx, m_valid, n_inl = match_and_optimize(poseB, lm, frame, cam, r_local, **pyr)
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
    counts = torch.stack([n_inl, nA, torch.zeros_like(n_inl), tracked_close,
                          total_close]).to(torch.float32)
    packed_f = torch.cat([pose.R.reshape(-1), pose.t, counts])
    return pose, new_velocity, packed_i, packed_f


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
        # (frame_id, ref_kf, R_rel, t_rel) per tracked frame.
        self.trajectory: list = []
        self.last_lm_ids: Optional[np.ndarray] = None
        self.new_kf_callback = None
        # Set by the system: (desc, valid) -> (words, bow) device tensors, or
        # (None, None) while no vocabulary exists.
        self.vocab_hook = None
        self.reloc_db = None  # KeyFrameDatabase set by the system
        # Device-resident local map, cached until the map mutates.
        self._lm_cache_key = None
        self._lm_cache: Optional[LocalMapBuffer] = None

    # ------------------------------------------------------------------

    def _gather_local_map(self) -> LocalMapBuffer:
        """Local map = landmarks of ref KF + its best covisible KFs, cached
        on the device across frames until the store's version changes."""
        key = (self.ref_kf, self.store.version)
        if self._lm_cache_key == key:
            return self._lm_cache
        cap = self.cfg.local_map_capacity
        kfs = [self.ref_kf] + list(self.store.best_covisible(self.ref_kf, self.cfg.local_kf_cap))
        lm_ids = np.unique(self.store.kf_obs_lm[kfs])
        lm_ids = lm_ids[(lm_ids >= 0)]
        lm_ids = lm_ids[self.store.lm_valid[lm_ids]]
        if len(lm_ids) > cap:
            lm_ids = lm_ids[-cap:]  # newest landmarks: freshest descriptors
        buf = self._buffer_from_ids(lm_ids)
        self._lm_cache_key = key
        self._lm_cache = buf
        return buf

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

    def _initialize(self, frame: Frame) -> bool:
        """Depth initialization: enough depth-carrying keypoints seed the map."""
        depth_ok, kp_ok = to_host(frame.depth > 0, frame.kp.valid)
        usable = depth_ok & kp_ok
        if usable.sum() < self.cfg.init_min_depth_kp:
            if depth_ok.sum() == 0:
                raise NotImplementedError(
                    "monocular initialization is not ported yet "
                    "(ROADMAP queue 1, item 8: stereo and monocular)"
                )
            return False
        self.pose = se3.identity(device=self.device)
        self._insert_keyframe(frame)
        self.state = TrackState.OK
        self._record_trajectory()
        return True

    def _insert_keyframe(self, frame: Frame, pose_R_h=None, pose_t_h=None,
                         frame_id=None) -> int:
        """Create a keyframe + landmarks from depth (CreateNewKeyFrame): new
        landmarks come from depth-carrying keypoints not already matched to
        the map, nearest-first, capped. One packed read of the frame and its
        words and BoW vector."""
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
        raise NotImplementedError(f"relocalisation {_NOT_PORTED_RELOC}")

    def _record_trajectory(self, pose_R_h=None, pose_t_h=None, frame_idx=None):
        """Store T_cur_ref = T_cw · T_ref_w^{-1} (relative to ref KF)."""
        if frame_idx is None:
            frame_idx = self.frame_idx
        if pose_R_h is None:
            pose_R_h, pose_t_h = to_host(self.pose.R, self.pose.t)
        pose_R_h = np.asarray(pose_R_h)
        pose_t_h = np.asarray(pose_t_h)
        R_ref = self.store.kf_R[self.ref_kf].copy()
        t_ref = self.store.kf_t[self.ref_kf].copy()
        R_rel = pose_R_h @ R_ref.T
        t_rel = pose_t_h - R_rel @ t_ref
        self.trajectory.append((frame_idx, self.ref_kf, R_rel, t_rel))

    # ------------------------------------------------------------------

    def track(self, frame: Frame) -> Optional[se3.SE3]:
        """Track one frame; returns the frame pose T_cw (None while
        uninitialized or lost)."""
        self.frame_idx += 1
        self.frames_since_kf += 1
        if self.state == TrackState.NOT_INITIALIZED:
            return self.pose if self._initialize(frame) else None
        if self.state == TrackState.LOST:
            if self.store.num_kf <= 5:
                # Lost soon after init with a tiny map: reset and re-init.
                self.store.reset()
                self.state = TrackState.NOT_INITIALIZED
                self.ref_kf = -1
                self.trajectory.clear()
                self.last_lm_ids = None
                return self.pose if self._initialize(frame) else None
            self._relocalize(frame)
        return self._track_steady(frame)

    def _track_steady(self, frame: Frame) -> Optional[se3.SE3]:
        lm_buffer = self._gather_local_map()
        prev_pose = self.pose
        pose, velocity, packed_i, packed_f = track_frame_step(
            self.pose, self.velocity, lm_buffer, frame, self.cam,
            self.cfg.match_radius_motion, self.cfg.match_radius_local,
            self.cfg.min_inliers_track, self.cfg.close_depth,
            num_levels=self.cfg.num_levels, scale_factor=self.cfg.scale_factor,
        )
        ok = self._consume_step(frame, self.frame_idx, lm_buffer, pose, velocity,
                                packed_i, packed_f, prev_pose)
        return self.pose if ok else None

    def _consume_step(self, frame, frame_idx, lm_buffer, pose, velocity, packed_i,
                      packed_f, prev_pose) -> bool:
        """Fetch + host bookkeeping for one step. Returns False when tracking
        was lost at this frame."""
        packed_i, packed_f = to_host(packed_i, packed_f)
        if int(packed_f[13]) < self.cfg.min_inliers_track:  # nA
            raise NotImplementedError(f"the no-prior pose recovery {_NOT_PORTED_RELOC}")

        pose_R_h = packed_f[:9].reshape(3, 3)
        pose_t_h = packed_f[9:12]
        n = int(packed_f[12])
        tracked_close = int(packed_f[15])
        untracked_close = int(packed_f[16]) - tracked_close

        if n < self.cfg.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = torch.zeros(6, device=self.device)
            return False

        ids = lm_buffer.ids
        mi, mv = packed_i[0], packed_i[1].astype(bool)
        sel = mv & (ids >= 0)
        self.last_lm_ids = np.stack([ids[sel], mi[sel]], axis=-1)
        vis = packed_i[2].astype(bool) & (ids >= 0)
        self.store.lm_visible[ids[vis]] += 1
        self.store.lm_found[ids[sel]] += 1

        self.velocity = velocity
        self.pose = pose
        self.state = TrackState.OK
        if self._need_keyframe(n, tracked_close, untracked_close):
            self._insert_keyframe(frame, pose_R_h=pose_R_h, pose_t_h=pose_t_h,
                                  frame_id=frame_idx)
        self._record_trajectory(pose_R_h, pose_t_h, frame_idx=frame_idx)
        return True
