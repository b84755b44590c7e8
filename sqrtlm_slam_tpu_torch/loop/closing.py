"""Loop closing: detection, Sim3 verification, loop correction, global BA.

Counterpart of `sqrtlm_slam_tpu/loop/closing.py` (the reference's
`LoopClosing`):
  * `detect_loop`: BoW candidates above the worst covisible score, with
    covisibility consistency >= 3 across successive keyframes;
  * `compute_sim3`: BoW-gated 3D-3D matches, batched Sim3 RANSAC (scale
    fixed for RGB-D), SearchBySim3 growth by mutual guided reprojection,
    `optimize_sim3`, then guided projection of the loop landmark group and
    the >= 40 total-matches acceptance;
  * `correct_loop`: the drift-plausibility veto, the corrected Sim3 pushed
    through the current keyframe's covisible group and its landmarks,
    SearchAndFuse, the essential graph, the observation-tear veto (with a
    full rollback), then global BA;
  * `run_global_ba`: the matrix-free PCG global BA in chunks of LM
    iterations, abandoned when a newer loop bumps the generation counter,
    with keyframes and landmarks created meanwhile corrected through the
    spanning tree; optionally on its own thread.

The map lives in the shared numpy `MapStore`; descriptor matching (kernel
K1), RANSAC, the Sim3 refinement, the essential graph and global BA (K2, K3)
run on the closer's device, small pose algebra on CPU tensors. The JAX
package's jitted `_project_match_kernel` and `_guided_sim3_kernel` are plain
functions here, sized to the landmarks present.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..frontend import matching, vocab
from ..geometry import se3, sim3
from ..mapstore import MapStore
from ..optim import schur, schur_bucketed
from ..utils import desc_to_torch, to_host
from . import essential_graph, sim3_solver
from .database import KeyFrameDatabase


class LoopClosingConfig(NamedTuple):
    consistency_threshold: int = 3  # covisibility-consistency count
    min_ransac_inliers: int = 20  # OptimizeSim3 acceptance
    min_total_matches: int = 40  # final acceptance
    fix_scale: bool = True  # stereo/RGB-D => 6-DoF
    kf_gap: int = 10  # ignore loops to the last 10 KFs
    covis_edge_weight: int = 100  # essential-graph strong covisibility edges
    essential_iters: int = 20
    gba_iters: int = 20
    match_cap: int = 512  # fixed capacity of the 3D-3D match buffer
    edge_cap: int = 8192  # essential-graph edge capacity (a floor)
    run_gba: bool = True
    loop_points_cap: int = 4096  # loop landmark group capacity
    sim3_search_radius: float = 7.5  # SearchBySim3 window
    proj_search_radius: float = 10.0  # SearchByProjection threshold
    fuse_radius: float = 4.0  # SearchAndFuse threshold
    gba_chunk: int = 5  # LM iterations per dispatch between abort checks
    # Poisoned-constraint gates: (a) drift plausibility before any
    # mutation, (b) observation-tear veto after the essential graph.
    max_loop_rot: float = 0.6  # rad; max plausible heading drift
    drift_frac: float = 0.25  # max translation correction per chain metre
    min_drift_allow: float = 3.0  # m; always allow this much correction
    max_loop_scale_log: float = 0.35  # |log s| cap when scale is free
    max_loop_bad_obs_frac: float = 0.4  # group-observation tear veto


class LoopMatches(NamedTuple):
    """Accepted-loop evidence carried from compute_sim3 to correct_loop: the
    loop-side landmark group and their matched keypoints in the current KF."""

    loop_lms: np.ndarray  # (M,) landmark ids around the loop KF
    cur_kp: np.ndarray  # (M,) matched keypoint index in the current KF
    cur_valid: np.ndarray  # (M,) bool
    n_total: int  # distinct current-KF keypoints matched to loop landmarks


def _pow12(octave: torch.Tensor) -> torch.Tensor:
    """1.2 ** octave in float32."""
    return torch.pow(torch.tensor(1.2, dtype=torch.float32, device=octave.device),
                     octave.to(torch.float32))


def project_match(cam: Camera, S_cw: sim3.Sim3, lm_pos, lm_desc, lm_valid, lm_normal,
                  lm_mind, lm_maxd, kp_xy, kp_desc, kp_octave, kp_valid, radius: float):
    """Project world landmarks into one keyframe under S_cw and match
    descriptors in windows (SearchByProjection / Fuse): depth-range and
    viewing-angle gates, pyramid level predicted from distance, a
    per-landmark radius, mutual-best Hamming match. Returns (idx, valid)."""
    x_c = sim3.act(S_cw, lm_pos)
    front = x_c[..., 2] > 0.05
    uv = cam.project(x_c)
    center = -(S_cw.R.T @ S_cw.t) / torch.clamp(S_cw.s, min=1e-9)
    po = lm_pos - center[None, :]
    dist = torch.linalg.norm(po, dim=-1)
    d_ok = (dist >= 0.8 * lm_mind) & (dist <= 1.3 * torch.clamp(lm_maxd, max=1e6))
    nrm = lm_normal / torch.clamp(torch.linalg.norm(lm_normal, dim=-1, keepdim=True), min=1e-9)
    view_ok = torch.sum(po * nrm, dim=-1) > 0.5 * dist  # < 60 deg viewing angle
    ratio = torch.clamp(lm_maxd, min=1e-6) / torch.clamp(dist, min=1e-6)
    log12 = torch.log(torch.tensor(1.2, dtype=torch.float32, device=ratio.device))
    octv = torch.clamp(torch.ceil(torch.log(ratio) / log12), 0, 7).to(torch.int32)
    window = matching.projection_window_mask(uv, kp_xy, radius * _pow12(octv),
                                             octave_pred=octv, octave_kp=kp_octave,
                                             level_slack=1)
    res = matching.match_descriptors(lm_desc, kp_desc, lm_valid & front & d_ok & view_ok,
                                     kp_valid, window_mask=window, max_dist=matching.TH_LOW,
                                     mutual=True)
    return res.idx, res.valid


def guided_sim3_match(cam: Camera, S12: sim3.Sim3, x1, v1, desc1, xy1, oct1, x2, v2, desc2,
                      xy2, oct2, radius: float):
    """SearchBySim3: grow KF1<->KF2 landmark matches by mutual guided
    reprojection through S12 and S21, keeping only agreements. x1/x2 are
    keypoint-aligned landmark positions in each KF's own camera frame.
    Returns (idx of KF2 per KF1 keypoint, agree)."""
    S21 = sim3.inverse(S12)
    x1_in_2 = sim3.act(S21, x1)
    x2_in_1 = sim3.act(S12, x2)
    winA = matching.projection_window_mask(cam.project(x1_in_2), xy2, radius * _pow12(oct1))
    resA = matching.match_descriptors(desc1, desc2, v1 & (x1_in_2[..., 2] > 0.05), v2,
                                      window_mask=winA, max_dist=matching.TH_HIGH,
                                      mutual=False)
    winB = matching.projection_window_mask(cam.project(x2_in_1), xy1, radius * _pow12(oct2))
    resB = matching.match_descriptors(desc2, desc1, v2 & (x2_in_1[..., 2] > 0.05), v1,
                                      window_mask=winB, max_dist=matching.TH_HIGH,
                                      mutual=False)
    idxA = resA.idx.long()
    iA = torch.arange(x1.shape[0], device=x1.device)
    agree = resA.valid & resB.valid[idxA] & (resB.idx.long()[idxA] == iA)
    return resA.idx, agree


def _cpu_sim3(S: sim3.Sim3) -> sim3.Sim3:
    return sim3.Sim3(*(a.detach().to("cpu") for a in S))


def _np_sim3(s, R, t) -> sim3.Sim3:
    """Sim3 on CPU from numpy-like fields (float32)."""
    f32 = torch.float32
    return sim3.Sim3(torch.as_tensor(np.asarray(s, np.float32), dtype=f32),
                     torch.as_tensor(np.asarray(R, np.float32), dtype=f32),
                     torch.as_tensor(np.asarray(t, np.float32), dtype=f32))


class LoopCloser:
    """Sequential loop closer over the SoA map store."""

    def __init__(self, store: MapStore, cam: Camera, voc: Optional[vocab.Vocabulary] = None,
                 cfg: LoopClosingConfig = LoopClosingConfig(), device="cuda"):
        self.store = store
        self.cam = cam
        self.voc = voc
        self.cfg = cfg
        self.device = torch.device(device)
        self.db = KeyFrameDatabase(store)
        self.last_loop_kf = -1
        # Consistency groups: list of (set_of_kfs, consistency_count).
        self.consistent_groups: List = []
        self.num_loops_closed = 0
        self.num_loops_rejected = 0  # vetoed by the poisoned-constraint gates
        self.last_fused = 0  # landmarks merged by the last SearchAndFuse
        self.last_reject = None  # (stage, count) of the last compute_sim3 gate
        self.last_loop_veto = None  # (gate, value) of the last correct_loop veto
        # RANSAC minimal sets come from this generator (fixed seed, as the
        # JAX package's PRNGKey(0)).
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        # Interruptible GBA: correct_loop bumps the generation, a running GBA
        # sees the change between LM chunks and drops its stale result.
        self.gba_generation = 0
        self.map_lock = threading.RLock()
        self.async_gba = False
        self._gba_thread: Optional[threading.Thread] = None
        self._gba_tick = lambda: None  # test hook, called between chunks
        self.num_gba_completed = 0
        self.num_gba_aborted = 0

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _kf_se3(self, kf: int) -> se3.SE3:
        """Keyframe pose as a CPU float32 transform."""
        return se3.SE3(torch.as_tensor(self.store.kf_R[kf], dtype=torch.float32),
                       torch.as_tensor(self.store.kf_t[kf], dtype=torch.float32))

    def _to_device(self, S: sim3.Sim3) -> sim3.Sim3:
        return sim3.Sim3(*(a.to(self.device) for a in S))

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------

    def insert_keyframe(self, kf: int) -> bool:
        """Process one keyframe; returns True if a loop was closed."""
        for c in self.detect_loop(kf):
            ok, S12, matches = self.compute_sim3(kf, c)
            if ok and self.correct_loop(kf, c, S12, matches):
                return True
        return False

    def _fuse_point(self, lm: int, kf: int, kp: int):
        """Merge one projected loop landmark into (kf, kp): replace a
        conflicting landmark by the loop-side one or add the observation."""
        store = self.store
        if not store.lm_valid[lm]:
            return 0
        existing = int(store.kf_obs_lm[kf, kp])
        if existing == lm:
            return 0
        if existing >= 0 and store.lm_valid[existing]:
            store.replace_landmark(existing, lm)
            return 1
        store.add_observation(lm, kf, kp)
        return 0

    def detect_loop(self, kf: int) -> List[int]:
        """BoW candidates + covisibility consistency >= 3."""
        store, cfg = self.store, self.cfg
        if kf < cfg.kf_gap or kf - self.last_loop_kf < cfg.kf_gap:
            return []
        min_score = self.db.min_covisible_score(kf)
        candidates = self.db.detect_loop_candidates(kf, min_score)
        if not candidates:
            self.consistent_groups = []
            return []
        enough: List[int] = []
        new_groups = []
        for c in candidates:
            group = {c} | {int(x) for x in store.best_covisible(c, 10)}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= cfg.consistency_threshold:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    # Sim3 verification
    # ------------------------------------------------------------------

    def _matched_pairs(self, kf1: int, kf2: int):
        """BoW-gated descriptor match between the two KFs' landmark features:
        (kp1, kp2, lm1, lm2) of the 3D-3D correspondences."""
        store = self.store
        dev = self.device
        v1 = store.kf_kp_valid[kf1] & (store.kf_obs_lm[kf1] >= 0)
        v2 = store.kf_kp_valid[kf2] & (store.kf_obs_lm[kf2] >= 0)
        w1, w2 = store.kf_words[kf1], store.kf_words[kf2]
        wmask = None
        if (w1 >= 0).any() and (w2 >= 0).any():
            # Deep vocabularies gate on ancestor nodes (DBoW2 direct index).
            lvl_up = max(0, self.voc.depth - 3) if self.voc is not None else 0
            k = self.voc.k if self.voc is not None else 10
            wmask = vocab.bow_window_mask(self._t(w1, torch.int64), self._t(w2, torch.int64),
                                          levels_up=lvl_up, k=k)
        res = matching.match_descriptors(
            desc_to_torch(store.kf_desc[kf1], dev), desc_to_torch(store.kf_desc[kf2], dev),
            self._t(v1, torch.bool), self._t(v2, torch.bool), window_mask=wmask,
            max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
            angles=(self._t(store.kf_angle[kf1]), self._t(store.kf_angle[kf2])),
        )
        valid, idx = to_host(res.valid, res.idx)
        sel = np.where(valid)[0]
        idx2 = idx[sel].astype(np.int64)
        lm1 = store.kf_obs_lm[kf1, sel]
        lm2 = store.kf_obs_lm[kf2, idx2]
        good = (lm1 >= 0) & (lm2 >= 0) & store.lm_valid[lm1] & store.lm_valid[lm2]
        return sel[good], idx2[good], lm1[good], lm2[good]

    def _search_by_sim3(self, kf1: int, kf2: int, S12: sim3.Sim3):
        """Grow kf1<->kf2 matches by guided reprojection through S12.
        Returns (kp1, kp2, lm1, lm2) agreement pairs."""
        store = self.store

        def kp_points(kf):
            lms = store.kf_obs_lm[kf]
            ok = (lms >= 0) & store.kf_kp_valid[kf]
            ok[ok] &= store.lm_valid[lms[ok]]
            pos = np.zeros((len(lms), 3), np.float32)
            pos[ok] = store.lm_pos[lms[ok]]
            return se3.act(self._kf_se3(kf), torch.as_tensor(pos)).to(self.device), ok

        x1, ok1 = kp_points(kf1)
        x2, ok2 = kp_points(kf2)
        dev = self.device
        idxA, agree = guided_sim3_match(
            self.cam, self._to_device(S12),
            x1, self._t(ok1, torch.bool), desc_to_torch(store.kf_desc[kf1], dev),
            self._t(store.kf_xy[kf1]), self._t(store.kf_octave[kf1], torch.int32),
            x2, self._t(ok2, torch.bool), desc_to_torch(store.kf_desc[kf2], dev),
            self._t(store.kf_xy[kf2]), self._t(store.kf_octave[kf2], torch.int32),
            self.cfg.sim3_search_radius,
        )
        idxA, agree = to_host(idxA, agree)
        kp1 = np.where(agree)[0]
        kp2 = idxA[kp1].astype(np.int64)
        return kp1, kp2, store.kf_obs_lm[kf1, kp1], store.kf_obs_lm[kf2, kp2]

    def _loop_point_group(self, kf_loop: int) -> np.ndarray:
        """Landmarks of the loop KF + its covisible group, capacity-bounded."""
        store = self.store
        group = [kf_loop] + [int(x) for x in store.best_covisible(kf_loop, 10)]
        lms = np.unique(store.kf_obs_lm[group])
        lms = lms[lms >= 0]
        lms = lms[store.lm_valid[lms]]
        return lms[: self.cfg.loop_points_cap].astype(np.int64)

    def _project_loop_points(self, kf: int, S_cw: sim3.Sim3, loop_lms: np.ndarray,
                             radius: float):
        """Match the loop landmark group into keyframe `kf` under pose S_cw.
        Returns (kp_idx, valid) aligned with loop_lms (numpy)."""
        store = self.store
        lms = loop_lms[: self.cfg.loop_points_cap]
        dev = self.device
        idx, ok = project_match(
            self.cam, self._to_device(S_cw),
            self._t(store.lm_pos[lms]), desc_to_torch(store.lm_desc[lms], dev),
            self._t(store.lm_valid[lms], torch.bool), self._t(store.lm_normal[lms]),
            self._t(store.lm_min_dist[lms]), self._t(np.minimum(store.lm_max_dist[lms], 1e6)),
            self._t(store.kf_xy[kf]), desc_to_torch(store.kf_desc[kf], dev),
            self._t(store.kf_octave[kf], torch.int32), self._t(store.kf_kp_valid[kf], torch.bool),
            radius,
        )
        idx, ok = to_host(idx, ok)
        return idx.astype(np.int64), ok.astype(bool)

    def compute_sim3(self, kf1: int, kf2: int):
        """RANSAC + SearchBySim3 growth + refinement + guided-projection
        acceptance for S12 between the current kf1 and the candidate kf2.
        Returns (ok, S12 (CPU Sim3), LoopMatches)."""
        store, cfg, cam = self.store, self.cfg, self.cam
        kp1, kp2, lm1, lm2 = self._matched_pairs(kf1, kf2)
        self.last_reject = ("pairs", len(lm1))
        if len(lm1) < 20:
            return False, None, None

        cap = cfg.match_cap
        T1 = self._kf_se3(kf1)
        T2 = self._kf_se3(kf2)

        def build_buffers(kp1_, kp2_, lm1_, lm2_):
            n = min(len(lm1_), cap)
            x1 = np.zeros((cap, 3), np.float32)
            x2 = np.zeros((cap, 3), np.float32)
            is2_1 = np.ones(cap, np.float32)
            is2_2 = np.ones(cap, np.float32)
            valid = np.zeros(cap, bool)
            x1[:n] = se3.act(T1, torch.as_tensor(store.lm_pos[lm1_[:n]])).numpy()
            x2[:n] = se3.act(T2, torch.as_tensor(store.lm_pos[lm2_[:n]])).numpy()
            is2_1[:n] = 1.0 / (1.2 ** (2 * store.kf_octave[kf1, kp1_[:n]]))
            is2_2[:n] = 1.0 / (1.2 ** (2 * store.kf_octave[kf2, kp2_[:n]]))
            valid[:n] = True
            return [self._t(x1), self._t(x2), self._t(valid, torch.bool), self._t(is2_1),
                    self._t(is2_2)]

        x1, x2, valid, is2_1, is2_2 = build_buffers(kp1, kp2, lm1, lm2)
        res = sim3_solver.ransac_sim3(x1, x2, valid, is2_1, is2_2, cam,
                                      fix_scale=cfg.fix_scale, generator=self.generator)
        n_inl = int(to_host(res.num_inliers))
        self.last_reject = ("ransac", n_inl)
        if n_inl < cfg.min_ransac_inliers:
            return False, None, None

        # SearchBySim3 growth: union the BoW matches with guided-agreement
        # pairs (keyed by current-KF keypoint) before refinement.
        g_kp1, g_kp2, g_lm1, g_lm2 = self._search_by_sim3(kf1, kf2, res.S12)
        have = set(kp1.tolist())
        add = [i for i, k in enumerate(g_kp1) if k not in have]
        if add:
            kp1 = np.concatenate([kp1, g_kp1[add]])[:cap]
            kp2 = np.concatenate([kp2, g_kp2[add]])[:cap]
            lm1 = np.concatenate([lm1, g_lm1[add]])[:cap]
            lm2 = np.concatenate([lm2, g_lm2[add]])[:cap]
            x1, x2, valid, is2_1, is2_2 = build_buffers(kp1, kp2, lm1, lm2)
        kp1, kp2, lm1, lm2 = kp1[:cap], kp2[:cap], lm1[:cap], lm2[:cap]

        S12, inl, n_inl = sim3_solver.optimize_sim3(res.S12, x1, x2, valid, is2_1, is2_2, cam,
                                                    fix_scale=cfg.fix_scale)
        S12 = _cpu_sim3(S12)
        inl, n_inl = to_host(inl, n_inl)
        n_inl = int(n_inl)
        self.last_reject = ("optimize", n_inl)
        if n_inl < cfg.min_ransac_inliers:
            return False, None, None

        # Guided projection of the loop-side landmark group into the current
        # KF under S_cw = S12 ∘ T_loop_w, then the >= 40 total acceptance.
        loop_lms = self._loop_point_group(kf2)
        S_cw = sim3.compose(S12, sim3.from_se3(T2))
        proj_kp, proj_ok = self._project_loop_points(kf1, S_cw, loop_lms,
                                                     cfg.proj_search_radius)
        # Seed with the Sim3-inlier matches.
        inl_np = inl[: len(kp1)]
        lm2_pos = {int(lm2[i]): int(kp1[i]) for i in np.where(inl_np)[0]}
        lm_index = {int(l): j for j, l in enumerate(loop_lms)}
        for l, k in lm2_pos.items():
            j = lm_index.get(l)
            if j is not None and not proj_ok[j]:
                proj_kp[j] = k
                proj_ok[j] = True
        n_total = len(set(proj_kp[proj_ok].tolist()))
        self.last_reject = ("total", n_total)
        if n_total < cfg.min_total_matches:
            return False, None, None
        matches = LoopMatches(loop_lms=loop_lms, cur_kp=proj_kp, cur_valid=proj_ok,
                              n_total=n_total)
        return True, S12, matches

    # ------------------------------------------------------------------
    # Correction
    # ------------------------------------------------------------------

    def correct_loop(self, kf_cur: int, kf_loop: int, S12: sim3.Sim3,
                     matches: Optional[LoopMatches] = None):
        """Propagate the corrected Sim3, fuse duplicate landmarks, optimise
        the essential graph, run global BA. S12 maps kf_loop-camera
        coordinates to kf_cur-camera coordinates. Returns True iff the loop
        was committed; on a veto the map is as before the call (up to the
        store's version counter)."""
        store, cfg = self.store, self.cfg
        K = store.num_kf
        S12 = _cpu_sim3(S12)

        s_all = np.ones(K, np.float32)
        R_all = store.kf_R[:K].copy()
        t_all = store.kf_t[:K].copy()
        S_loop = _np_sim3(1.0, R_all[kf_loop], t_all[kf_loop])
        S_cur_corr = sim3.compose(S12, S_loop)

        # ---- Gate (a): drift plausibility (pre-mutation) ----
        T_new = sim3.to_se3(S_cur_corr)
        R_new = T_new.R.numpy()
        c_new = -R_new.T @ T_new.t.numpy()
        c_old = -R_all[kf_cur].T @ t_all[kf_cur]
        corr_t = float(np.linalg.norm(c_new - c_old))
        cosang = (np.trace(R_new @ R_all[kf_cur].T) - 1.0) / 2.0
        corr_rot = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
        corr_slog = abs(float(np.log(max(float(S12.s), 1e-9))))
        ids = [k for k in range(min(kf_loop, kf_cur), max(kf_loop, kf_cur) + 1)
               if store.kf_valid[k]]
        centers = np.stack([-store.kf_R[k].T @ store.kf_t[k] for k in ids])
        chain_dist = float(np.sum(np.linalg.norm(np.diff(centers, axis=0), axis=-1)))
        t_allow = max(cfg.drift_frac * chain_dist, cfg.min_drift_allow)
        if (corr_rot > cfg.max_loop_rot or corr_t > t_allow
                or (not cfg.fix_scale and corr_slog > cfg.max_loop_scale_log)):
            self.last_loop_veto = ("drift", {"rot": corr_rot, "t": corr_t,
                                             "t_allow": t_allow, "slog": corr_slog})
            self.num_loops_rejected += 1
            return False

        # A newer loop supersedes any in-flight GBA.
        self.gba_generation += 1
        snap = self._snapshot_for_rollback(K)

        # The current KF's covisible group is corrected through its relative
        # pose to the current KF: S_i_corr = (T_iw ∘ T_cur_w^-1) ∘ S_cur_corr.
        group = [kf_cur] + [int(x) for x in store.best_covisible(kf_cur, 30)]
        T_cur = se3.SE3(torch.as_tensor(R_all[kf_cur]), torch.as_tensor(t_all[kf_cur]))
        corrected = {}
        for i in group:
            T_i = se3.SE3(torch.as_tensor(R_all[i]), torch.as_tensor(t_all[i]))
            S_rel = sim3.from_se3(se3.compose(T_i, se3.inverse(T_cur)))
            corrected[i] = sim3.compose(S_rel, S_cur_corr)

        # Move the group's landmarks: p' = S_corr^-1( S_old(p) ).
        moved = set()
        for i in group:
            lms = store.kf_obs_lm[i]
            lms = np.unique(lms[lms >= 0])
            lms = [l for l in lms if l not in moved and store.lm_valid[l]]
            if not lms:
                continue
            moved.update(lms)
            p = torch.as_tensor(store.lm_pos[lms])
            S_old = _np_sim3(1.0, R_all[i], t_all[i])
            store.lm_pos[lms] = sim3.act(sim3.inverse(corrected[i]), sim3.act(S_old, p)).numpy()
            store.version += 1

        # Edge measurements come from the pre-correction snapshot.
        s_meas, R_meas, t_meas = s_all.copy(), R_all.copy(), t_all.copy()

        # Corrected group poses (scale folded into translation) are the
        # essential graph's initial values.
        for i, S in corrected.items():
            T = sim3.to_se3(S)
            store.set_kf_pose(i, T.R.numpy(), T.t.numpy())
            s_all[i] = float(S.s)
            R_all[i] = S.R.numpy()
            t_all[i] = S.t.numpy()

        # ---- SearchAndFuse: merge duplicate landmarks across the loop ----
        pre_neighbors = {i: set(np.where(store.covis[i] > 0)[0].tolist()) for i in group}
        self.last_fused = 0
        if matches is not None:
            for j in np.where(matches.cur_valid)[0]:
                self.last_fused += self._fuse_point(int(matches.loop_lms[j]), kf_cur,
                                                    int(matches.cur_kp[j]))
            loop_lms = matches.loop_lms
        else:
            loop_lms = self._loop_point_group(kf_loop)
        for i in group:
            proj_kp, proj_ok = self._project_loop_points(i, corrected[i], loop_lms,
                                                         cfg.fuse_radius)
            for j in np.where(proj_ok)[0]:
                self.last_fused += self._fuse_point(int(loop_lms[j]), i, int(proj_kp[j]))
        # New cross-loop connections get essential-graph edges measured from
        # the corrected poses.
        for i in group:
            store.update_connections(i)
        loop_connections = []
        group_set = set(group)
        for i in group:
            now = set(np.where(store.covis[i] > 0)[0].tolist())
            for j in now - pre_neighbors[i] - group_set:
                loop_connections.append((i, int(j)))

        # ---- essential graph over all keyframes ----
        problem = self._build_pose_graph(kf_cur, kf_loop, S12, s_all, R_all, t_all,
                                         s_meas, R_meas, t_meas, loop_connections)
        out, _ = essential_graph.optimize_pose_graph(problem, num_iters=cfg.essential_iters)
        self._apply_pose_graph(out, K)

        # ---- Gate (b): observation-tear veto (post-essential-graph) ----
        bad_frac = self._obs_bad_fraction(set(group))
        if bad_frac > cfg.max_loop_bad_obs_frac:
            self._restore_from_rollback(snap, K)
            self.last_loop_veto = ("tear", {"bad_frac": float(bad_frac)})
            self.num_loops_rejected += 1
            return False

        store.loop_edges.append((kf_cur, kf_loop))
        self.last_loop_kf = kf_cur
        self.num_loops_closed += 1

        if cfg.run_gba:
            gen = self.gba_generation
            if self.async_gba:
                self._gba_thread = threading.Thread(target=self.run_global_ba, args=(gen,),
                                                    daemon=True)
                self._gba_thread.start()
            else:
                self.run_global_ba(gen)
        return True

    def _build_pose_graph(self, kf_cur, kf_loop, S12, s_all, R_all, t_all, s_meas, R_meas,
                          t_meas, loop_connections=()):
        """Edges: the new loop edge, fusion-created loop connections
        (measured from the corrected poses), earlier loop edges, the
        spanning tree and strong covisibility (measured from the
        pre-correction snapshot). Initial values are the corrected poses."""
        store, cfg = self.store, self.cfg
        K = store.num_kf
        E = cfg.edge_cap
        S12 = _cpu_sim3(S12)
        pre_ij: List = []
        post_ij: List = []
        seen = set()

        def add(i, j, bucket):
            i, j = int(i), int(j)
            if i < 0 or j < 0 or i == j:
                return
            pair = (min(i, j), max(i, j))
            if pair in seen:
                return
            seen.add(pair)
            bucket.append((i, j))

        seen.add((min(kf_loop, kf_cur), max(kf_loop, kf_cur)))
        for (i, j) in loop_connections:
            add(i, j, post_ij)
        for (a, b) in store.loop_edges:
            if a < K and b < K:
                add(b, a, pre_ij)
        for k in np.where(store.kf_valid[:K])[0]:
            p = store.parent[k]
            if p >= 0 and store.kf_valid[p]:
                add(int(p), k, pre_ij)
            for c in store.covisible_above(int(k), cfg.covis_edge_weight):
                add(int(k), int(c), pre_ij)

        def batched_relatives(ij, s, R, t):
            """S_ji = S_jw ∘ S_iw^-1 for all (i, j) pairs in one compose."""
            if not ij:
                return (np.zeros(0, np.float32), np.zeros((0, 3, 3), np.float32),
                        np.zeros((0, 3), np.float32))
            idx = np.asarray(ij, np.int64)
            S_i = _np_sim3(s[idx[:, 0]], R[idx[:, 0]], t[idx[:, 0]])
            S_j = _np_sim3(s[idx[:, 1]], R[idx[:, 1]], t[idx[:, 1]])
            S = sim3.compose(S_j, sim3.inverse(S_i))
            return S.s.numpy(), S.R.numpy(), S.t.numpy()

        s_pre, R_pre, t_pre = batched_relatives(pre_ij, s_meas, R_meas, t_meas)
        s_post, R_post, t_post = batched_relatives(post_ij, s_all, R_all, t_all)

        # edge_cap is a floor: round the needed capacity up in 4096 buckets.
        needed = 1 + len(post_ij) + len(pre_ij)
        E = max(E, -(-needed // 4096) * 4096)
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        es = np.ones(E, np.float32)
        eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        et = np.zeros((E, 3), np.float32)
        ev = np.zeros(E, bool)
        all_i = np.concatenate([[kf_loop], [p[0] for p in post_ij],
                                [p[0] for p in pre_ij]]).astype(np.int32)
        all_j = np.concatenate([[kf_cur], [p[1] for p in post_ij],
                                [p[1] for p in pre_ij]]).astype(np.int32)
        all_s = np.concatenate([[float(S12.s)], s_post, s_pre]).astype(np.float32)
        all_R = np.concatenate([S12.R.numpy()[None], R_post.reshape(-1, 3, 3),
                                R_pre.reshape(-1, 3, 3)]).astype(np.float32)
        all_t = np.concatenate([S12.t.numpy()[None], t_post.reshape(-1, 3),
                                t_pre.reshape(-1, 3)]).astype(np.float32)
        ne = min(len(all_i), E)
        ei[:ne], ej[:ne], es[:ne] = all_i[:ne], all_j[:ne], all_s[:ne]
        eR[:ne], et[:ne], ev[:ne] = all_R[:ne], all_t[:ne], True

        fixed = np.zeros(K, bool)
        fixed[kf_loop] = True
        t = self._t
        return essential_graph.PoseGraphProblem(
            s=t(s_all), R=t(R_all), t=t(t_all), fixed=t(fixed, torch.bool),
            valid=t(store.kf_valid[:K], torch.bool), e_i=t(ei, torch.int32),
            e_j=t(ej, torch.int32), e_s=t(es), e_R=t(eR), e_t=t(et),
            e_valid=t(ev, torch.bool),
        )

    # Store fields correct_loop mutates before GBA.
    _ROLLBACK_KF = ("kf_R", "kf_t", "kf_obs_lm")
    _ROLLBACK_LM = (
        "lm_pos", "lm_valid", "lm_desc", "lm_normal", "lm_min_dist",
        "lm_max_dist", "lm_obs_kf", "lm_obs_idx", "lm_n_obs", "lm_visible",
        "lm_found", "lm_first_kf",
    )
    _ROLLBACK_FULL = ("covis", "parent")

    def _snapshot_for_rollback(self, K: int) -> dict:
        store = self.store
        L = store.num_lm
        snap = {f: getattr(store, f)[:K].copy() for f in self._ROLLBACK_KF}
        snap.update({f: getattr(store, f)[:L].copy() for f in self._ROLLBACK_LM})
        snap.update({f: getattr(store, f).copy() for f in self._ROLLBACK_FULL})
        snap["loop_edges"] = list(store.loop_edges)
        return snap

    def _restore_from_rollback(self, snap: dict, K: int):
        store = self.store
        L = snap["lm_pos"].shape[0]
        for f in self._ROLLBACK_KF:
            getattr(store, f)[:K] = snap[f]
        for f in self._ROLLBACK_LM:
            getattr(store, f)[:L] = snap[f]
        for f in self._ROLLBACK_FULL:
            getattr(store, f)[...] = snap[f]
        store.loop_edges = snap["loop_edges"]
        # The version counter stays monotonic: device caches key on it.
        store.version += 1

    def _obs_bad_fraction(self, kfs: Optional[set] = None) -> float:
        """Fraction of (optionally KF-restricted) landmark observations whose
        reprojection fails the chi2(0.05, 2 dof) gate: the tear metric."""
        store, cam = self.store, self.cam
        L = store.num_lm
        lm_sel = np.where(store.lm_valid[:L])[0]
        if len(lm_sel) == 0:
            return 0.0
        O = store.lm_obs_kf.shape[1]
        flat_kf = store.lm_obs_kf[lm_sel].reshape(-1)
        flat_idx = store.lm_obs_idx[lm_sel].reshape(-1)
        flat_lm = np.repeat(lm_sel, O)
        m = (flat_kf >= 0) & (flat_idx >= 0)
        if kfs is not None:
            m &= np.isin(flat_kf, np.fromiter(kfs, dtype=np.int64))
        if not m.any():
            return 0.0
        kf, idx, lm = flat_kf[m], flat_idx[m], flat_lm[m]
        p_c = np.einsum("kij,kj->ki", store.kf_R[kf], store.lm_pos[lm]) + store.kf_t[kf]
        z = p_c[:, 2]
        zs = np.maximum(z, 1e-6)
        u = cam.fx * p_c[:, 0] / zs + cam.cx
        v = cam.fy * p_c[:, 1] / zs + cam.cy
        xy = store.kf_xy[kf, idx]
        inv_s2 = 1.0 / 1.2 ** (2 * store.kf_octave[kf, idx])
        e2 = ((u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2) * inv_s2
        bad = (z <= 0.05) | (e2 > 5.991)
        return float(bad.mean())

    def _apply_pose_graph(self, out: essential_graph.PoseGraphProblem, K: int):
        """Write back optimised poses; landmarks move with their reference
        (first-observing) keyframe."""
        store = self.store
        old_R = store.kf_R[:K].copy()
        old_t = store.kf_t[:K].copy()
        new_s, new_R, new_t = to_host(out.s, out.R, out.t)
        ref_kf = store.lm_first_kf[: store.num_lm].copy()
        lm_sel = np.where(store.lm_valid[: store.num_lm] & (ref_kf >= 0) & (ref_kf < K))[0]
        if len(lm_sel):
            refs = ref_kf[lm_sel]
            p = store.lm_pos[lm_sel]
            p_cam = np.einsum("kij,kj->ki", old_R[refs], p) + old_t[refs]
            s = new_s[refs][:, None]
            p_new = np.einsum("kji,kj->ki", new_R[refs],
                              (p_cam - new_t[refs]) / np.maximum(s, 1e-9))
            store.lm_pos[lm_sel] = p_new
            store.version += 1
        for k in range(K):
            if store.kf_valid[k]:
                store.set_kf_pose(k, new_R[k], new_t[k] / max(new_s[k], 1e-9))

    # ------------------------------------------------------------------
    # Global BA
    # ------------------------------------------------------------------

    def run_global_ba(self, generation: Optional[int] = None) -> bool:
        """Interruptible whole-map BA on the matrix-free PCG engine: LM
        iterations run in chunks of `gba_chunk`, and the loop generation is
        re-checked between them; a stale run returns False without touching
        the map. Keyframes and landmarks created meanwhile are corrected
        through the spanning tree. Returns True iff written back."""
        cfg = self.cfg
        if generation is None:
            generation = self.gba_generation
        with self.map_lock:
            snap_kf = self.store.num_kf
            snap_lm = self.store.num_lm
            pre_R = self.store.kf_R[:snap_kf].copy()
            pre_t = self.store.kf_t[:snap_kf].copy()
            problem, meta = gather_global_problem_bucketed(self.store, self.device)

        survivors = None
        done = 0
        while done < cfg.gba_iters:
            if self.gba_generation != generation:
                self.num_gba_aborted += 1
                return False
            n = min(max(cfg.gba_chunk, 1), cfg.gba_iters - done)
            problem, survivors, _ = schur_bucketed.global_ba_cg(problem, self.cam, num_iters=n)
            done += n
            self._gba_tick()

        with self.map_lock:
            # Re-check inside the lock: a correct_loop holding it may have
            # superseded this run while we waited.
            if self.gba_generation != generation:
                self.num_gba_aborted += 1
                return False
            # A GBA that failed to converge can flag nearly every observation
            # as an outlier; keep the map rather than erase it.
            obs_valid, surv = to_host(problem.obs_valid, survivors)
            n_obs = int(obs_valid.sum())
            n_surv = int((surv & obs_valid).sum())
            if n_obs > 0 and n_surv < 0.5 * n_obs:
                self.num_gba_aborted += 1
                return False
            write_back_global_bucketed(self.store, problem, surv, meta)
            self._propagate_to_new_kfs(snap_kf, snap_lm, pre_R, pre_t)
        self.num_gba_completed += 1
        return True

    def wait_gba(self):
        """Join an async GBA thread."""
        t = self._gba_thread
        if t is not None:
            t.join()

    def _propagate_to_new_kfs(self, snap_kf: int, snap_lm: int, pre_R: np.ndarray,
                              pre_t: np.ndarray):
        """Correct keyframes/landmarks created during GBA via the spanning
        tree: T_k' = (T_k T_p^-1)_preGBA ∘ T_p', landmarks via their
        reference keyframe's correction."""
        store = self.store
        if store.num_kf == snap_kf and store.num_lm == snap_lm:
            return
        old_R = np.concatenate([pre_R, store.kf_R[snap_kf:store.num_kf]], axis=0)
        old_t = np.concatenate([pre_t, store.kf_t[snap_kf:store.num_kf]], axis=0)
        for k in range(snap_kf, store.num_kf):
            if not store.kf_valid[k]:
                continue
            p = int(store.parent[k])
            if p < 0:
                continue
            # Parents are older, so by ascending order p is already corrected.
            R_rel = old_R[k] @ old_R[p].T
            t_rel = old_t[k] - R_rel @ old_t[p]
            store.set_kf_pose(k, R_rel @ store.kf_R[p], R_rel @ store.kf_t[p] + t_rel)
        refs = store.lm_first_kf[snap_lm:store.num_lm]
        sel = np.where(store.lm_valid[snap_lm:store.num_lm] & (refs >= 0))[0]
        if len(sel):
            r = refs[sel]
            p = store.lm_pos[snap_lm + sel]
            p_cam = np.einsum("kij,kj->ki", old_R[r], p) + old_t[r]
            store.lm_pos[snap_lm + sel] = np.einsum("kji,kj->ki", store.kf_R[r],
                                                    p_cam - store.kf_t[r])
            store.version += 1


# ----------------------------------------------------------------------
# Whole-map problem gather / write-back
# ----------------------------------------------------------------------


def gather_global_problem(store: MapStore, device="cuda"):
    """All valid KFs + landmarks -> flat `schur.BAProblem` on `device` (the
    edge list of the store's per-landmark observation table). Returns
    (problem, meta) with meta = (kf_ids, lm_ids, edge keyframe, edge
    landmark slot, edge keypoint)."""
    K = store.num_kf
    Lc = store.num_lm
    kf_ids = np.where(store.kf_valid[:K])[0]
    lm_ids = np.where(store.lm_valid[:Lc] & (store.lm_n_obs[:Lc] > 0))[0]
    kf_slot = np.full(K, -1, np.int32)
    kf_slot[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)

    li = np.repeat(np.arange(len(lm_ids), dtype=np.int32), store.obs_per_landmark)
    kfs = store.lm_obs_kf[lm_ids].reshape(-1)
    kps = store.lm_obs_idx[lm_ids].reshape(-1)
    ok = (kfs >= 0) & (kfs < K)
    ok[ok] &= kf_slot[kfs[ok]] >= 0
    li, kfs, kps = li[ok], kfs[ok], kps[ok]
    P = len(kf_ids)
    has_lm, has_e = len(lm_ids) > 0, len(li) > 0
    arrays = dict(
        pose_R=store.kf_R[kf_ids], pose_t=store.kf_t[kf_ids],
        pose_fixed=np.arange(P) == 0,  # gauge: first KF
        pose_valid=np.ones(P, bool),
        points=store.lm_pos[lm_ids] if has_lm else np.zeros((1, 3), np.float32),
        point_valid=np.ones(len(lm_ids), bool) if has_lm else np.zeros(1, bool),
        obs_cam=kf_slot[kfs] if has_e else np.zeros(1, np.int32),
        obs_pt=li if has_e else np.zeros(1, np.int32),
        obs_uvr=store.kf_uvr[kfs, kps] if has_e else np.full((1, 3), -1.0, np.float32),
        obs_inv_sigma2=(1.0 / 1.2 ** (2 * store.kf_octave[kfs, kps])) if has_e
        else np.ones(1, np.float32),
        obs_valid=np.ones(len(li), bool) if has_e else np.zeros(1, bool),
    )
    dtypes = dict(pose_fixed=torch.bool, pose_valid=torch.bool, point_valid=torch.bool,
                  obs_cam=torch.int32, obs_pt=torch.int32, obs_valid=torch.bool)
    problem = schur.BAProblem(**{
        k: torch.as_tensor(np.array(v), device=device).to(dtypes.get(k, torch.float32))
        for k, v in arrays.items()})
    return problem, (kf_ids, lm_ids, kfs, li, kps)


def write_back_global(store: MapStore, out: schur.BAProblem, survivors, meta):
    """Flat GBA result -> store: free poses, landmark positions, and the
    observations that failed the survivor gate are erased."""
    kf_ids, lm_ids, e_kf, e_lm_slot, _ = meta
    new_R, new_t, fixed, points, surv = to_host(out.pose_R, out.pose_t, out.pose_fixed,
                                                out.points, survivors)
    for i, k in enumerate(kf_ids):
        if not fixed[i]:
            store.set_kf_pose(int(k), new_R[i], new_t[i])
    if len(lm_ids):
        store.lm_pos[lm_ids] = points[: len(lm_ids)]
        store.version += 1
    for j in np.where(~surv[: len(e_kf)])[0]:
        store.erase_observation(int(lm_ids[e_lm_slot[j]]), int(e_kf[j]))


def gather_global_problem_bucketed(store: MapStore, device="cuda"):
    """All valid KFs + landmarks -> BucketedBAProblem on `device`. The store's
    per-landmark observation table is the bucketed layout already, so the
    gather is vectorized numpy slicing (no TPU lane padding of L)."""
    K = store.num_kf
    Lc = store.num_lm
    kf_ids = np.where(store.kf_valid[:K])[0]
    lm_ids = np.where(store.lm_valid[:Lc] & (store.lm_n_obs[:Lc] > 0))[0]
    kf_slot = np.full(max(K, 1), -1, np.int32)
    kf_slot[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)
    P = max(len(kf_ids), 1)
    L = max(len(lm_ids), 1)
    O = store.obs_per_landmark

    obs_kf = store.lm_obs_kf[lm_ids] if len(lm_ids) else np.full((1, O), -1, np.int32)
    obs_idx = store.lm_obs_idx[lm_ids] if len(lm_ids) else np.full((1, O), -1, np.int32)
    okf = np.clip(obs_kf, 0, K - 1 if K else 0)
    oidx = np.clip(obs_idx, 0, store.kf_uvr.shape[1] - 1)
    valid = (obs_kf >= 0) & (kf_slot[okf] >= 0)
    obs_cam = np.where(valid, kf_slot[okf], 0).astype(np.int32)
    uvr = np.where(valid[..., None], store.kf_uvr[okf, oidx], -1.0).astype(np.float32)
    is2 = (1.0 / 1.2 ** (2 * store.kf_octave[okf, oidx])).astype(np.float32)
    pv = np.zeros(L, bool)
    pv[: len(lm_ids)] = True
    arrays = dict(
        pose_R=store.kf_R[kf_ids] if len(kf_ids) else np.eye(3, dtype=np.float32)[None],
        pose_t=store.kf_t[kf_ids] if len(kf_ids) else np.zeros((1, 3), np.float32),
        pose_fixed=np.arange(P) == 0,  # gauge: first KF
        pose_valid=np.ones(P, bool),
        points=store.lm_pos[lm_ids].astype(np.float32) if len(lm_ids)
        else np.zeros((1, 3), np.float32),
        point_valid=pv, obs_cam=obs_cam, obs_uvr=uvr, obs_inv_sigma2=is2, obs_valid=valid,
    )
    problem = schur_bucketed.bucketed_from_numpy(arrays, device)
    return problem, (kf_ids, lm_ids, obs_kf, obs_idx)


def write_back_global_bucketed(store: MapStore, out, survivors, meta):
    """GBA result -> store: free poses, landmark positions, and the
    observations that failed the survivor gate are erased."""
    kf_ids, lm_ids, e_kf, _ = meta
    new_R, new_t, fixed, points, obs_valid = to_host(out.pose_R, out.pose_t, out.pose_fixed,
                                                     out.points, out.obs_valid)
    for i, k in enumerate(kf_ids):
        if not fixed[i]:
            store.set_kf_pose(int(k), new_R[i], new_t[i])
    if len(lm_ids):
        store.lm_pos[lm_ids] = points[: len(lm_ids)]
        store.version += 1
    dropped = obs_valid & ~np.asarray(to_host(survivors))
    for li, j in zip(*np.nonzero(dropped[: len(lm_ids)])):
        store.erase_observation(int(lm_ids[li]), int(e_kf[li, j]))
