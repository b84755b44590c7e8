"""Local mapping: keyframe processing, culling, and local bundle adjustment.

Counterpart of `sqrtlm_slam_tpu/pipeline/local_mapping.py` (synchronous,
one pass per keyframe): landmark culling, triangulation against covisible
neighbours, the two-way neighbour fuse, local BA on the bucketed
sqrt-Schur engine (kernel K2 per LM iteration; on the card one captured
CUDA graph per problem shape, replayed) with write-back and outlier
pruning, and keyframe culling. The map bookkeeping is the shared numpy
`MapStore`; device work runs on the mapper's device and is read back once
per dispatch group. The JAX package's jitted programs of local mapping are
captured CUDA graphs here (`utils.cache`): triangulation
(`triangulation.match_and_triangulate`), the neighbour fuse's
`_project_and_match` and `_project_and_match_many` (on buffers padded to
`fuse_cap` and neighbour chunks of `FUSE_BATCH`, the JAX shapes, so one
capture serves every keyframe) and the bucketed local BA. When the
keyframes carry LiDAR feature clouds, local BA
ends with the LiDAR stage: the centre keyframe's pose is refined against the
LiDAR local map rebuilt from the optimized neighbour poses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3
from ..mapstore import MapStore
from ..optim import facade, pose_opt, schur_bucketed
from ..utils import cache, desc_to_torch, to_host
from . import triangulation
from .tracking import aggregate_kf_lidar, lidar_association, local_map_from_clouds


# Neighbours per `_project_and_match_many` dispatch (the JAX package's B):
# 10 first-order + 5 x 5 second-order neighbours at most, in chunks.
FUSE_BATCH = 24


def _project_and_match(pose_R, pose_t, lm_pos, lm_desc, lm_valid, lm_normal, lm_min_dist,
                       lm_max_dist, kp_xy, kp_desc, kp_valid, cam: Camera,
                       radius_px: float):
    """Project landmarks into a keyframe and Hamming-match within a window,
    with the Fuse acceptance gates: positive depth, distance inside
    [0.8 minDist, 1.2 maxDist], viewing angle < 60 deg to the mean normal."""
    pose = se3.SE3(pose_R, pose_t)
    x_c = se3.act(pose, lm_pos)
    uv = cam.project(x_c)
    C = -torch.einsum("ji,j->i", pose_R, pose_t)
    v = lm_pos - C
    dist = torch.linalg.norm(v, dim=-1)
    dist_ok = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    n_norm = torch.linalg.norm(lm_normal, dim=-1)
    cos_view = torch.sum(v * lm_normal, dim=-1) / torch.clamp(dist * n_norm, min=1e-9)
    angle_ok = (cos_view > 0.5) | (n_norm < 1e-6)
    ok = lm_valid & (x_c[..., 2] > 0.3) & dist_ok & angle_ok
    window = matching.projection_window_mask(uv, kp_xy, radius_px)
    return matching.match_descriptors(lm_desc, kp_desc, ok, kp_valid, window_mask=window,
                                      max_dist=matching.TH_LOW, mutual=True)


def _project_and_match_many(pose_R, pose_t, lm_pos, lm_desc, lm_valid, lm_normal,
                            lm_min_dist, lm_max_dist, kp_xy, kp_desc, kp_valid,
                            cam: Camera, radius_px: float):
    """One landmark set projected into B keyframes (leading axis on the pose
    and keypoint arrays). Returns stacked (valid (B, M), idx (B, M)): the B
    matches in turn (one graph holds them all on the card)."""
    res = [
        _project_and_match(pose_R[b], pose_t[b], lm_pos, lm_desc, lm_valid, lm_normal,
                           lm_min_dist, lm_max_dist, kp_xy[b], kp_desc[b], kp_valid[b],
                           cam, radius_px)
        for b in range(pose_R.shape[0])
    ]
    return torch.stack([r.valid for r in res]), torch.stack([r.idx for r in res])


# The JAX package's two jitted programs (static `cam`, `radius_px`) as
# captured CUDA graphs; the `_many` graph calls the single function's eager
# body B times.
_project_and_match = cache.graphed(_project_and_match, static_argnames=("cam", "radius_px"))
_project_and_match_many = cache.graphed(_project_and_match_many,
                                        static_argnames=("cam", "radius_px"))


# The bucketed backend's local BA (what `facade.Optimizer("bucketed")` runs)
# as one captured CUDA graph per problem shape, `utils.cache` (the JAX
# package's `_ba_jit`): the caps of `LocalMappingConfig` fix the shapes. The
# flat and cg backends replay graphs of their own inside the facade
# (`schur._local_loop_jit`, one a phase; `schur_bucketed.LOCAL_GRAPHS`, three
# an LM iteration), on plans padded to the caps. On the CPU all run eagerly.
_bucketed_local_ba_jit = cache.graphed(
    schur_bucketed.local_ba, static_argnames=("cam", "first_iters", "second_iters"))


class LocalMappingConfig(NamedTuple):
    pose_cap: int = 32
    point_cap: int = 4096
    obs_cap: int = 8
    local_kf_cap: int = 16
    min_found_ratio: float = 0.25
    min_obs_after: int = 2
    cull_redundancy: float = 0.9
    cull_min_obs: int = 3
    triangulate: bool = True
    tri_neighbors: int = 6
    tri_max_new: int = 200
    backend: str = "bucketed"


class LocalMapper:
    def __init__(self, store: MapStore, cam: Camera,
                 cfg: LocalMappingConfig = LocalMappingConfig(), device="cuda"):
        self.store = store
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self._optimizer = facade.Optimizer(cfg.backend)
        self.recent_landmarks: list = []  # (lm_id, created_at_kf)
        self.num_local_ba = 0
        self.num_lidar_stages = 0
        # The fuse's buffers padded to the JAX shapes (`fuse_cap` landmarks,
        # FUSE_BATCH neighbours) on the card, where one captured graph then
        # serves every keyframe. On the CPU nothing is captured and the rows
        # present suffice: pad rows never match, so the results are the same
        # bits, at a fraction of the plain Hamming matrices' work.
        self._pad_fuse = self.device.type == "cuda"

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------

    def process_keyframe(self, kf: int):
        """Full local-mapping pass for a freshly inserted keyframe."""
        self.store.update_connections(kf)
        self.map_point_culling(kf)
        if self.cfg.triangulate and self.store.num_kf >= 2:
            self.create_new_map_points(kf)
        self.search_in_neighbors(kf)
        if self.store.num_kf >= 3:
            self.local_ba(kf)
        self.keyframe_culling(kf)

    # ------------------------------------------------------------------

    def search_in_neighbors(self, kf: int, fuse_cap: int = 4096):
        """Two-level neighbour fuse: project neighbours' landmarks into kf and
        kf's landmarks into each neighbour; matches onto keypoints already
        bound to a landmark merge the two, unbound matches become new
        observations."""
        store = self.store
        first = [int(x) for x in store.best_covisible(kf, 10)]
        neighbors = list(first)
        for nb in first[:5]:
            for nb2 in store.best_covisible(nb, 5):
                if int(nb2) != kf and int(nb2) not in neighbors:
                    neighbors.append(int(nb2))

        def lm_of(k):
            ids = store.kf_obs_lm[k]
            ids = np.unique(ids[ids >= 0])
            return ids[store.lm_valid[ids]][-fuse_cap:]

        def lm_buffer(lm_ids):
            # Padded to fuse_cap, as the JAX package's (see `_pad_fuse`). Pad
            # rows are invalid and never match.
            m = len(lm_ids)
            cap = fuse_cap if self._pad_fuse else m
            pos = np.zeros((cap, 3), np.float32)
            desc = np.zeros((cap, 8), np.uint32)
            val = np.zeros(cap, bool)
            normal = np.zeros((cap, 3), np.float32)
            dmin = np.zeros(cap, np.float32)
            dmax = np.full(cap, np.inf, np.float32)
            pos[:m], desc[:m], val[:m] = store.lm_pos[lm_ids], store.lm_desc[lm_ids], True
            normal[:m], dmin[:m] = store.lm_normal[lm_ids], store.lm_min_dist[lm_ids]
            dmax[:m] = store.lm_max_dist[lm_ids]
            return (self._t(pos), desc_to_torch(desc, self.device), self._t(val),
                    self._t(normal), self._t(dmin), self._t(dmax))

        def fuse_apply(target_kf, lm_ids, res_valid, res_idx):
            m = len(lm_ids)
            hits = np.where(res_valid[:m])[0]
            kp_idx = res_idx[:m]
            n_fused = 0
            for j in hits:
                lm = int(lm_ids[j])
                kp = int(kp_idx[j])
                if not store.lm_valid[lm]:
                    continue
                existing = int(store.kf_obs_lm[target_kf, kp])
                if existing == lm:
                    continue
                if existing >= 0 and store.lm_valid[existing]:
                    if store.lm_n_obs[existing] >= store.lm_n_obs[lm]:
                        store.replace_landmark(lm, existing)
                    else:
                        store.replace_landmark(existing, lm)
                else:
                    store.add_observation(lm, target_kf, kp)
                n_fused += 1
            return n_fused

        total = 0
        gathered = [lm_of(nb) for nb in neighbors]
        if gathered:
            ids = np.unique(np.concatenate(gathered))[-fuse_cap:]
            if len(ids):
                res = _project_and_match(
                    self._t(store.kf_R[kf]), self._t(store.kf_t[kf]), *lm_buffer(ids),
                    self._t(store.kf_xy[kf]), desc_to_torch(store.kf_desc[kf], self.device),
                    self._t(store.kf_kp_valid[kf]), self.cam, 3.0,
                )
                rv, ri = to_host(res.valid, res.idx)
                total += fuse_apply(kf, ids, rv, ri)
        # Reverse direction: the neighbours in chunks of FUSE_BATCH, pad rows
        # with an identity pose and no valid keypoint (see `_pad_fuse`).
        own = lm_of(kf)
        if len(own):
            buf = lm_buffer(own)
            for start in range(0, len(neighbors), FUSE_BATCH):
                nbs = neighbors[start:start + FUSE_BATCH]
                B = FUSE_BATCH if self._pad_fuse else len(nbs)
                bR = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
                bt = np.zeros((B, 3), np.float32)
                bxy = np.zeros((B,) + store.kf_xy.shape[1:], np.float32)
                bdesc = np.zeros((B,) + store.kf_desc.shape[1:], np.uint32)
                bval = np.zeros((B,) + store.kf_kp_valid.shape[1:], bool)
                n = len(nbs)
                bR[:n], bt[:n], bxy[:n] = store.kf_R[nbs], store.kf_t[nbs], store.kf_xy[nbs]
                bdesc[:n], bval[:n] = store.kf_desc[nbs], store.kf_kp_valid[nbs]
                rv, ri = to_host(*_project_and_match_many(
                    self._t(bR), self._t(bt), *buf, self._t(bxy),
                    desc_to_torch(bdesc.reshape(-1, 8), self.device).reshape(B, -1, 8),
                    self._t(bval), self.cam, 3.0,
                ))
                for i, nb in enumerate(nbs):
                    total += fuse_apply(nb, own, rv[i], ri[i])
        if total:
            touched = lm_of(kf)
            store.update_landmark_stats(touched[:512])
            store.update_connections(kf)
        return total

    # ------------------------------------------------------------------

    def create_new_map_points(self, kf: int):
        """Triangulate new landmarks against the best covisible neighbours;
        accepted pairs become landmarks observed in both keyframes."""
        store, cfg = self.store, self.cfg
        T1 = se3.SE3(self._t(store.kf_R[kf]), self._t(store.kf_t[kf]))
        free1 = store.kf_kp_valid[kf] & (store.kf_obs_lm[kf] < 0)
        sigma2 = (1.2 ** (2 * store.kf_octave[kf])).astype(np.float32)
        n_created = 0
        handles = []
        for nb in store.best_covisible(kf, cfg.tri_neighbors):
            nb = int(nb)
            base = np.linalg.norm(store.kf_center(kf) - store.kf_center(nb))
            if base < 0.05:
                continue
            T2 = se3.SE3(self._t(store.kf_R[nb]), self._t(store.kf_t[nb]))
            free2 = store.kf_kp_valid[nb] & (store.kf_obs_lm[nb] < 0)
            res = triangulation.match_and_triangulate(
                T1, T2, self.cam,
                self._t(store.kf_xy[kf]), desc_to_torch(store.kf_desc[kf], self.device),
                self._t(free1), self._t(sigma2),
                self._t(store.kf_xy[nb]), desc_to_torch(store.kf_desc[nb], self.device),
                self._t(free2),
                self._t((1.2 ** (2 * store.kf_octave[nb])).astype(np.float32)),
                angles1=self._t(store.kf_angle[kf]), angles2=self._t(store.kf_angle[nb]),
            )
            handles.append((nb, res))
        # One read for all neighbours (three arrays each, so always a tuple).
        fetched = to_host(*[x for _, r in handles for x in (r.valid, r.points_w, r.idx2)]) \
            if handles else ()
        for i, (nb, _) in enumerate(handles):
            res_valid, pts, idx2 = fetched[3 * i:3 * i + 3]
            ok = np.where(res_valid)[0]
            new_here = []
            for j in ok[: cfg.tri_max_new]:
                if store.kf_obs_lm[kf, j] >= 0 or store.kf_obs_lm[nb, idx2[j]] >= 0:
                    continue
                if store.num_lm >= store.max_landmarks:
                    break
                lm = store.add_landmark(pts[j], store.kf_desc[kf, j], kf)
                store.add_observation(lm, kf, int(j))
                store.add_observation(lm, nb, int(idx2[j]))
                new_here.append(lm)
                n_created += 1
            if new_here:
                store.update_landmark_stats(np.asarray(new_here))
                self.watch_landmarks(np.asarray(new_here), kf)
        if n_created:
            store.update_connections(kf)
        return n_created

    # ------------------------------------------------------------------

    def map_point_culling(self, current_kf: int):
        """Cull recently created landmarks that underperform (found-ratio <
        0.25, or <= min_obs after 2 KFs)."""
        store = self.store
        keep = []
        for lm, born_kf in self.recent_landmarks:
            if not store.lm_valid[lm]:
                continue
            age = current_kf - born_kf
            ratio = store.lm_found[lm] / max(store.lm_visible[lm], 1)
            if ratio < self.cfg.min_found_ratio:
                store.erase_landmark(lm)
            elif age >= 2 and store.lm_n_obs[lm] <= self.cfg.min_obs_after:
                store.erase_landmark(lm)
            elif age >= 3:
                pass
            else:
                keep.append((lm, born_kf))
        self.recent_landmarks = keep

    def remap_landmarks(self, remap: np.ndarray):
        """Renumber the recent landmarks after `mapstore.compact_landmarks`;
        dead ones are dropped, as `map_point_culling` drops them."""
        self.recent_landmarks = [(int(remap[lm]), kf) for lm, kf in self.recent_landmarks
                                 if remap[lm] >= 0 and self.store.lm_valid[remap[lm]]]

    def watch_landmarks(self, lm_ids, born_kf: int):
        for lm in np.atleast_1d(lm_ids):
            if lm >= 0:
                self.recent_landmarks.append((int(lm), born_kf))

    # ------------------------------------------------------------------

    def gather_problem(self, center_kf: int):
        """Fixed-capacity landmark-bucketed BA problem around `center_kf`:
        local KFs = center + best covisible; fixed frontier = other observers
        of the local landmarks. Returns (problem, (kf_ids, lm_ids, e_kf, e_kp))."""
        store, cfg = self.store, self.cfg
        local = [center_kf] + [
            int(x) for x in store.best_covisible(center_kf, cfg.local_kf_cap - 1)
        ]
        local_set = set(local)
        lm_ids = np.unique(store.kf_obs_lm[local])
        lm_ids = lm_ids[lm_ids >= 0]
        lm_ids = lm_ids[store.lm_valid[lm_ids]][: cfg.point_cap]

        observers = store.lm_obs_kf[lm_ids]
        obs_flat = observers[observers >= 0]
        frontier = [int(k) for k in np.unique(obs_flat) if k not in local_set]
        kf_ids = (local + frontier)[: cfg.pose_cap]
        kf_slot = {int(k): i for i, k in enumerate(kf_ids)}
        n_local_in = len([k for k in local if k in kf_slot])

        P, L, K = cfg.pose_cap, cfg.point_cap, cfg.obs_cap
        nk = len(kf_ids)
        nl = len(lm_ids)
        obs_cam = np.zeros((L, K), np.int32)
        obs_uvr = np.full((L, K, 3), -1.0, np.float32)
        obs_is2 = np.ones((L, K), np.float32)
        obs_valid = np.zeros((L, K), bool)
        e_kf = np.full((L, K), -1, np.int32)
        e_kp = np.full((L, K), -1, np.int32)
        if nl:
            slot_of = np.full(store.max_keyframes + 1, -1, np.int32)
            slot_of[np.asarray(kf_ids, np.int64)] = np.arange(nk, dtype=np.int32)
            okf = store.lm_obs_kf[lm_ids]
            oidx = store.lm_obs_idx[lm_ids]
            sel = (okf >= 0) & (slot_of[np.clip(okf, 0, None)] >= 0)
            order = np.argsort(~sel, axis=1, kind="stable")
            okf_c = np.take_along_axis(okf, order, axis=1)[:, :K]
            oidx_c = np.take_along_axis(oidx, order, axis=1)[:, :K]
            sel_c = np.take_along_axis(sel, order, axis=1)[:, :K]
            okf_c = np.where(sel_c, okf_c, 0)
            oidx_c = np.where(sel_c, oidx_c, 0)
            # The store holds obs_per_landmark slots: with obs_cap above it the
            # slots past them stay inactive (the JAX package's gather raises
            # there).
            k = okf_c.shape[1]
            obs_cam[:nl, :k] = np.where(sel_c, slot_of[okf_c], 0)
            obs_uvr[:nl, :k] = np.where(sel_c[..., None], store.kf_uvr[okf_c, oidx_c], -1.0)
            obs_is2[:nl, :k] = np.where(
                sel_c, 1.0 / (1.2 ** (2 * store.kf_octave[okf_c, oidx_c])), 1.0
            )
            obs_valid[:nl, :k] = sel_c
            e_kf[:nl, :k] = np.where(sel_c, okf_c, -1)
            e_kp[:nl, :k] = np.where(sel_c, oidx_c, -1)

        pose_R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        pose_t = np.zeros((P, 3), np.float32)
        pose_R[:nk] = store.kf_R[kf_ids]
        pose_t[:nk] = store.kf_t[kf_ids]
        pose_fixed = np.ones(P, bool)
        for i, k in enumerate(kf_ids):
            pose_fixed[i] = (i >= n_local_in) or (k == min(local))
        pose_valid = np.zeros(P, bool)
        pose_valid[:nk] = True
        points = np.zeros((L, 3), np.float32)
        points[:nl] = store.lm_pos[lm_ids]
        point_valid = np.zeros(L, bool)
        point_valid[:nl] = True

        problem = schur_bucketed.bucketed_from_numpy(
            dict(pose_R=pose_R, pose_t=pose_t, pose_fixed=pose_fixed,
                 pose_valid=pose_valid, points=points, point_valid=point_valid,
                 obs_cam=obs_cam, obs_uvr=obs_uvr, obs_inv_sigma2=obs_is2,
                 obs_valid=obs_valid),
            self.device,
        )
        return problem, (kf_ids, lm_ids, e_kf, e_kp, pose_fixed)

    def local_ba(self, center_kf: int):
        """Gather -> two-phase LM -> write back -> prune outliers, then the
        LiDAR stage when the centre keyframe carries LiDAR clouds."""
        problem, (kf_ids, lm_ids, e_kf, e_kp, pose_fixed) = self.gather_problem(center_kf)
        if self.cfg.backend == "bucketed":
            result, survivors, chi2 = _bucketed_local_ba_jit(problem, self.cam)
        else:
            result, survivors, chi2 = self._optimizer.local_bundle_adjustment(problem, self.cam)
        self.num_local_ba += 1
        store = self.store
        nk, nl = len(kf_ids), len(lm_ids)
        new_R, new_t, new_pts, surv = to_host(result.pose_R, result.pose_t, result.points,
                                              survivors)
        for i, k in enumerate(kf_ids):
            if not pose_fixed[i]:
                store.set_kf_pose(k, new_R[i], new_t[i])
        store.lm_pos[lm_ids] = new_pts[:nl]
        store.version += 1
        dropped = (e_kf >= 0) & ~surv
        for li, j in zip(*np.nonzero(dropped)):
            store.erase_observation(int(lm_ids[li]), int(e_kf[li, j]))
        if store.kf_corner_valid[center_kf].any():
            self._lidar_stage(center_kf)
        return chi2

    def _lidar_stage(self, kf: int, match_dist: float = 0.45):
        """Fused visual + LiDAR refinement of the centre keyframe's pose
        against the LiDAR local map of its (just optimized) covisible
        neighbours: one visual round of 5 iterations, then 20 fused ones."""
        store = self.store
        neighbors = [int(x) for x in store.best_covisible(kf, 10)]
        neighbors = [k for k in neighbors if store.kf_corner_valid[k].any()]
        if not neighbors:
            return
        clouds = aggregate_kf_lidar(store, neighbors, 10)
        if clouds[1].sum() + clouds[4].sum() < 100:
            return
        lmap = local_map_from_clouds(clouds, self.device)

        # Visual observations of the centre keyframe from its landmark bindings.
        pose = se3.SE3(self._t(store.kf_R[kf]), self._t(store.kf_t[kf]))
        kp_lm = store.kf_obs_lm[kf]
        cap = 1024
        pts = np.zeros((cap, 3), np.float32)
        uvr = np.full((cap, 3), -1.0, np.float32)
        is2 = np.ones(cap, np.float32)
        val = np.zeros(cap, bool)
        idx = np.where(kp_lm >= 0)[0][:cap]
        pts[: len(idx)] = store.lm_pos[kp_lm[idx]]
        uvr[: len(idx)] = store.kf_uvr[kf, idx]
        is2[: len(idx)] = 1.0 / (1.2 ** (2 * store.kf_octave[kf, idx]))
        val[: len(idx)] = True
        obs = pose_opt.VisualObs(points_w=self._t(pts), uvr=self._t(uvr),
                                 inv_sigma2=self._t(is2), valid=self._t(val))

        # Associate the keyframe's own (stored, keyframe-frame) features at its pose.
        lobs = lidar_association(pose, self._t(store.kf_corner[kf]),
                                 self._t(store.kf_corner_valid[kf]), self._t(store.kf_flat[kf]),
                                 self._t(store.kf_flat_valid[kf]), lmap, match_dist)
        result = pose_opt.optimize_pose(pose, obs, self.cam, lidar_obs=lobs, rounds=1,
                                        iters_per_round=5, lidar_iters=20)
        store.set_kf_pose(kf, *to_host(result.pose.R, result.pose.t))
        self.num_lidar_stages += 1

    # ------------------------------------------------------------------

    def keyframe_culling(self, current_kf: int):
        """Cull covisible KFs whose landmarks are >= 90% redundantly observed
        (the most recent KF and KF 0 are kept)."""
        store, cfg = self.store, self.cfg
        for kf in store.best_covisible(current_kf, cfg.local_kf_cap):
            kf = int(kf)
            if kf == 0 or kf == current_kf or not store.kf_valid[kf]:
                continue
            lms = store.kf_obs_lm[kf]
            lms = lms[lms >= 0]
            if len(lms) == 0:
                continue
            redundant = (store.lm_n_obs[lms] >= cfg.cull_min_obs + 1).sum()
            if redundant > cfg.cull_redundancy * len(lms):
                self._cull_keyframe(kf)

    def _cull_keyframe(self, kf: int):
        store = self.store
        for lm in store.kf_obs_lm[kf]:
            if lm >= 0:
                store.erase_observation(int(lm), kf)
        store.kf_valid[kf] = False
        store.covis[kf] = 0
        store.covis[:, kf] = 0
        children = np.where(store.parent == kf)[0]
        store.parent[children] = store.parent[kf]
        store.version += 1
