"""SoA map state: keyframes, landmarks, observations, covisibility graph.

The numpy `MapStore` of `sqrtlm_slam_tpu/mapstore/store.py`, carried into
the port unchanged so that the port (and `chip_smoke.py`) runs without
importing the JAX package. The map is host-side numpy in both packages;
`tests/test_torch_slice.py` holds the two `MapStore` classes to identical
source. `compact_landmarks` is the port's own: it reclaims the rows of dead
landmarks when the append-only rows run out (`SlamSystem` calls it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

COVIS_THRESHOLD = 15  # min shared observations for a covisibility edge
# (KeyFrame::UpdateConnections weight threshold, SURVEY §2.4)


@dataclass
class MapStore:
    """Fixed-capacity global map. All arrays preallocated; rows are recycled
    only between `reset()`s (monotonic ids, like the reference's nNextId)."""

    max_keyframes: int = 512
    max_landmarks: int = 40000
    feats_per_kf: int = 1000
    obs_per_landmark: int = 16
    num_words: int = 1000
    corner_per_kf: int = 512  # LiDAR corner cloud capacity (KeyFrame.h:437-442)
    flat_per_kf: int = 1024  # LiDAR flat cloud (+normal) capacity

    # -- keyframe arrays (filled in __post_init__) --
    kf_R: np.ndarray = field(init=False)  # (K, 3, 3) T_cw rotation
    kf_t: np.ndarray = field(init=False)  # (K, 3)
    kf_valid: np.ndarray = field(init=False)  # (K,) bool (False = culled/empty)
    kf_frame_id: np.ndarray = field(init=False)  # (K,) source frame index
    kf_xy: np.ndarray = field(init=False)  # (K, N, 2) keypoint pixels
    kf_uvr: np.ndarray = field(init=False)  # (K, N, 3) [u, v, u_right]
    kf_depth: np.ndarray = field(init=False)  # (K, N) LiDAR/stereo depth (<=0 none)
    kf_desc: np.ndarray = field(init=False)  # (K, N, 8) uint32
    kf_angle: np.ndarray = field(init=False)  # (K, N)
    kf_octave: np.ndarray = field(init=False)  # (K, N) int32
    kf_kp_valid: np.ndarray = field(init=False)  # (K, N) bool
    kf_words: np.ndarray = field(init=False)  # (K, N) int32 word ids
    kf_bow: np.ndarray = field(init=False)  # (K, W) float32 BoW vectors
    kf_obs_lm: np.ndarray = field(init=False)  # (K, N) int32 landmark id or -1
    # LiDAR feature clouds carried per keyframe (KF camera frame), feeding
    # the tracking/BA tight-coupling local maps (KeyFrame.h:437-442).
    kf_corner: np.ndarray = field(init=False)  # (K, Nc, 3)
    kf_corner_valid: np.ndarray = field(init=False)  # (K, Nc)
    kf_flat: np.ndarray = field(init=False)  # (K, Nf, 3)
    kf_flat_normal: np.ndarray = field(init=False)  # (K, Nf, 3)
    kf_flat_valid: np.ndarray = field(init=False)  # (K, Nf)

    # -- landmark arrays --
    lm_pos: np.ndarray = field(init=False)  # (L, 3)
    lm_valid: np.ndarray = field(init=False)  # (L,) bool
    lm_desc: np.ndarray = field(init=False)  # (L, 8) representative descriptor
    lm_normal: np.ndarray = field(init=False)  # (L, 3) mean viewing direction
    lm_min_dist: np.ndarray = field(init=False)  # (L,) scale-invariance range
    lm_max_dist: np.ndarray = field(init=False)
    lm_obs_kf: np.ndarray = field(init=False)  # (L, O) observing KF id or -1
    lm_obs_idx: np.ndarray = field(init=False)  # (L, O) keypoint index in that KF
    lm_n_obs: np.ndarray = field(init=False)  # (L,)
    lm_visible: np.ndarray = field(init=False)  # (L,) visibility counter
    lm_found: np.ndarray = field(init=False)  # (L,) found counter
    lm_first_kf: np.ndarray = field(init=False)  # (L,) creating keyframe

    # -- graph --
    covis: np.ndarray = field(init=False)  # (K, K) int32 shared-obs weights
    parent: np.ndarray = field(init=False)  # (K,) spanning-tree parent (-1 root)
    loop_edges: List[Tuple[int, int]] = field(default_factory=list)

    num_kf: int = 0
    num_lm: int = 0

    def __post_init__(self):
        K, N, L, O, W = (
            self.max_keyframes,
            self.feats_per_kf,
            self.max_landmarks,
            self.obs_per_landmark,
            self.num_words,
        )
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_uvr = np.full((K, N, 3), -1.0, np.float32)
        self.kf_depth = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_kp_valid = np.zeros((K, N), bool)
        self.kf_words = np.full((K, N), -1, np.int32)
        self.kf_bow = np.zeros((K, W), np.float32)
        self.kf_obs_lm = np.full((K, N), -1, np.int32)
        self.kf_corner = np.zeros((K, self.corner_per_kf, 3), np.float32)
        self.kf_corner_valid = np.zeros((K, self.corner_per_kf), bool)
        self.kf_flat = np.zeros((K, self.flat_per_kf, 3), np.float32)
        self.kf_flat_normal = np.zeros((K, self.flat_per_kf, 3), np.float32)
        self.kf_flat_valid = np.zeros((K, self.flat_per_kf), bool)

        self.lm_pos = np.zeros((L, 3), np.float32)
        self.lm_valid = np.zeros(L, bool)
        self.lm_desc = np.zeros((L, 8), np.uint32)
        self.lm_normal = np.zeros((L, 3), np.float32)
        self.lm_min_dist = np.zeros(L, np.float32)
        self.lm_max_dist = np.full(L, np.inf, np.float32)
        self.lm_obs_kf = np.full((L, O), -1, np.int32)
        self.lm_obs_idx = np.full((L, O), -1, np.int32)
        self.lm_n_obs = np.zeros(L, np.int32)
        self.lm_visible = np.ones(L, np.int32)
        self.lm_found = np.ones(L, np.int32)
        self.lm_first_kf = np.full(L, -1, np.int32)

        self.covis = np.zeros((K, K), np.int32)
        self.parent = np.full(K, -1, np.int32)

        # Monotonic mutation counter: bumped by every mutating method (and
        # manually at the few direct array-write sites in local mapping /
        # loop closing). Lets per-frame consumers (the tracker's device-
        # resident local-map buffer) cache across frames and invalidate
        # exactly when the map changed — the functional-snapshot analogue
        # of the reference's Map::mMutexMapUpdate freshness guarantee.
        self.version = 0

    # ------------------------------------------------------------------
    # Keyframes
    # ------------------------------------------------------------------

    def add_keyframe(
        self,
        R: np.ndarray,
        t: np.ndarray,
        xy: np.ndarray,
        uvr: np.ndarray,
        depth: np.ndarray,
        desc: np.ndarray,
        angle: np.ndarray,
        octave: np.ndarray,
        kp_valid: np.ndarray,
        words: Optional[np.ndarray] = None,
        bow: Optional[np.ndarray] = None,
        frame_id: int = -1,
    ) -> int:
        k = self.num_kf
        assert k < self.max_keyframes, "keyframe capacity exceeded"
        n = min(xy.shape[0], self.feats_per_kf)
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_xy[k, :n] = xy[:n]
        self.kf_uvr[k, :n] = uvr[:n]
        self.kf_depth[k, :n] = depth[:n]
        self.kf_desc[k, :n] = desc[:n]
        self.kf_angle[k, :n] = angle[:n]
        self.kf_octave[k, :n] = octave[:n]
        self.kf_kp_valid[k, :n] = kp_valid[:n]
        if words is not None:
            self.kf_words[k, :n] = words[:n]
        if bow is not None:
            self.kf_bow[k] = bow
        self.num_kf += 1
        self.version += 1
        return k

    def set_kf_pose(self, k: int, R: np.ndarray, t: np.ndarray):
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.version += 1

    def set_kf_lidar(self, k, corner, corner_valid, flat, flat_normal, flat_valid):
        """Attach (downsampled, KF-frame) LiDAR feature clouds to KF k."""
        nc = min(len(corner), self.corner_per_kf)
        nf = min(len(flat), self.flat_per_kf)
        self.kf_corner[k, :nc] = corner[:nc]
        self.kf_corner_valid[k, :nc] = corner_valid[:nc]
        self.kf_flat[k, :nf] = flat[:nf]
        self.kf_flat_normal[k, :nf] = flat_normal[:nf]
        self.kf_flat_valid[k, :nf] = flat_valid[:nf]
        self.version += 1

    # ------------------------------------------------------------------
    # Landmarks & observations
    # ------------------------------------------------------------------

    def add_landmark(self, pos: np.ndarray, desc: np.ndarray, first_kf: int) -> int:
        l = self.num_lm
        assert l < self.max_landmarks, "landmark capacity exceeded"
        self.lm_pos[l] = pos
        self.lm_valid[l] = True
        self.lm_desc[l] = desc
        self.lm_first_kf[l] = first_kf
        self.num_lm += 1
        self.version += 1
        return l

    def add_observation(self, lm: int, kf: int, kp_idx: int):
        """Register kf's keypoint kp_idx as an observation of landmark lm."""
        slots = self.lm_obs_kf[lm]
        free = np.where(slots < 0)[0]
        if len(free) == 0:
            return  # observation capacity full — drop (rare)
        s = free[0]
        self.lm_obs_kf[lm, s] = kf
        self.lm_obs_idx[lm, s] = kp_idx
        self.lm_n_obs[lm] += 1
        self.kf_obs_lm[kf, kp_idx] = lm
        self.version += 1

    def erase_observation(self, lm: int, kf: int):
        sel = self.lm_obs_kf[lm] == kf
        if sel.any():
            idxs = self.lm_obs_idx[lm, sel]
            for i in idxs:
                if i >= 0:
                    self.kf_obs_lm[kf, i] = -1
            self.lm_obs_kf[lm, sel] = -1
            self.lm_obs_idx[lm, sel] = -1
            self.lm_n_obs[lm] -= int(sel.sum())
            self.version += 1
        if self.lm_n_obs[lm] <= 0:
            self.lm_valid[lm] = False

    def erase_landmark(self, lm: int):
        """SetBadFlag: remove all back-references (MapPoint.cc:231-328)."""
        for s in range(self.obs_per_landmark):
            kf = self.lm_obs_kf[lm, s]
            if kf >= 0:
                i = self.lm_obs_idx[lm, s]
                if i >= 0 and self.kf_obs_lm[kf, i] == lm:
                    self.kf_obs_lm[kf, i] = -1
        self.lm_obs_kf[lm] = -1
        self.lm_obs_idx[lm] = -1
        self.lm_n_obs[lm] = 0
        self.version += 1
        self.lm_valid[lm] = False

    def replace_landmark(self, old: int, new: int):
        """MapPoint::Replace — re-point old's observations at new."""
        for s in range(self.obs_per_landmark):
            kf = self.lm_obs_kf[old, s]
            i = self.lm_obs_idx[old, s]
            if kf >= 0 and i >= 0:
                if (self.lm_obs_kf[new] == kf).any():
                    self.kf_obs_lm[kf, i] = -1  # new already seen there
                else:
                    self.kf_obs_lm[kf, i] = new
                    self.add_observation(new, kf, int(i))
        self.lm_found[new] += self.lm_found[old]
        self.lm_visible[new] += self.lm_visible[old]
        self.lm_obs_kf[old] = -1
        self.lm_obs_idx[old] = -1
        self.lm_n_obs[old] = 0
        self.lm_valid[old] = False
        self.version += 1

    def update_landmark_stats(self, lms: np.ndarray):
        """Recompute representative descriptor (min-median-Hamming), viewing
        normal and scale range for the given landmark ids
        (MapPoint.cc:382-580). Fully vectorized over the batch — the
        per-landmark python loop was a per-keyframe host hotspot."""
        lms = np.atleast_1d(np.asarray(lms, np.int64))
        if len(lms) == 0:
            return
        O = self.obs_per_landmark
        okf = self.lm_obs_kf[lms]  # (n, O)
        oidx = self.lm_obs_idx[lms]
        sel = okf >= 0
        rows = sel.any(1)
        if not rows.any():
            return
        lms, okf, oidx, sel = lms[rows], okf[rows], oidx[rows], sel[rows]
        kfs = np.where(sel, okf, 0)
        idxs = np.where(sel, oidx, 0)
        descs = self.kf_desc[kfs, idxs]  # (n, O, 8) uint32

        # Min-median-Hamming representative descriptor per landmark.
        x = descs[:, :, None, :] ^ descs[:, None, :, :]  # (n, O, O, 8)
        d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.float32)
        d[~sel[:, None, :].repeat(O, 1)] = np.nan  # invalid columns
        med = np.nanmedian(d, axis=2)  # (n, O)
        med[~sel] = np.inf  # invalid candidates
        best = np.argmin(med, axis=1)
        n_idx = np.arange(len(lms))
        self.lm_desc[lms] = descs[n_idx, best]

        # Viewing normal: mean unit vector from KF centers to the point.
        R = self.kf_R[kfs]  # (n, O, 3, 3)
        t = self.kf_t[kfs]
        centers = -np.einsum("nkji,nkj->nki", R, t)
        v = self.lm_pos[lms][:, None, :] - centers  # (n, O, 3)
        nv = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        cnt = np.maximum(sel.sum(1, keepdims=True), 1)
        self.lm_normal[lms] = (nv * sel[..., None]).sum(1) / cnt

        # Scale range from the LAST valid observation's octave (1.2 pyramid).
        last = O - 1 - np.argmax(sel[:, ::-1], axis=1)
        dist = np.linalg.norm(v[n_idx, last], axis=-1)
        oct_ = self.kf_octave[kfs[n_idx, last], idxs[n_idx, last]]
        scale = 1.2**oct_.astype(np.float32)
        self.lm_max_dist[lms] = dist * scale * 1.2
        self.lm_min_dist[lms] = dist * scale / (1.2**7) / 1.2
        self.version += 1

    # ------------------------------------------------------------------
    # Covisibility graph + spanning tree
    # ------------------------------------------------------------------

    def update_connections(self, kf: int):
        """Recompute covisibility row for kf: weight = #shared landmarks
        (KeyFrame::UpdateConnections). One vectorized pass over kf's
        observations; attaches the spanning-tree parent on first call."""
        lms = self.kf_obs_lm[kf]
        lms = lms[lms >= 0]
        counts = np.zeros(self.max_keyframes, np.int32)
        if len(lms):
            observers = self.lm_obs_kf[lms]  # (n, O)
            obs = observers[observers >= 0]
            np.add.at(counts, obs, 1)
        counts[kf] = 0
        # Thresholded symmetric update; always keep the single best neighbor
        # (reference keeps the max-weight edge even below threshold).
        row = np.where(counts >= COVIS_THRESHOLD, counts, 0)
        if row.max() == 0 and counts.max() > 0:
            j = int(counts.argmax())
            row[j] = counts[j]
        self.covis[kf] = row
        self.covis[:, kf] = row
        self.version += 1

        if self.parent[kf] < 0 and kf > 0:
            w = counts.copy()
            w[kf:] = 0  # parent must be an older keyframe
            if w.max() > 0:
                self.parent[kf] = int(w.argmax())
            else:
                self.parent[kf] = kf - 1

    def best_covisible(self, kf: int, n: int) -> np.ndarray:
        """Top-n covisible keyframe ids (GetBestCovisibilityKeyFrames)."""
        row = self.covis[kf].copy()
        row[~self.kf_valid] = 0
        order = np.argsort(-row)
        return order[row[order] > 0][:n]

    def covisible_above(self, kf: int, min_weight: int) -> np.ndarray:
        row = self.covis[kf]
        ids = np.where((row >= min_weight) & self.kf_valid)[0]
        return ids[ids != kf]

    # ------------------------------------------------------------------
    # Misc
    # ------------------------------------------------------------------

    def kf_center(self, k: int) -> np.ndarray:
        """Camera center in world: C = -R^T t."""
        return -self.kf_R[k].T @ self.kf_t[k]

    def reset(self):
        """Full map reset (System::Reset / Tracking::Reset semantics)."""
        v = self.version
        self.__post_init__()
        self.version = v + 1  # monotonic across resets (cache keys stay unique)
        self.num_kf = 0
        self.num_lm = 0
        self.loop_edges = []


def compact_landmarks(store: MapStore, hold=()) -> np.ndarray:
    """Reclaim the rows of dead landmarks: the rows to keep (valid
    landmarks, those a keyframe's `kf_obs_lm` still names, and the ids in
    `hold`, arrays that callers keep across the call) move down to
    0..n-1 in their order, every landmark field and `kf_obs_lm` follow,
    the freed rows get `__post_init__`'s values and `num_lm` becomes n.

    The store allocates landmark rows append-only (`add_landmark`), and
    culling leaves most of them dead: the 1,000-frame ring of
    `eval/longrun.py` creates ~470 landmarks a frame and keeps a third,
    so its 400,000 rows run out near frame 850. Ids keep their order, so
    everything that sorts or slices ids (`np.unique`, the newest landmarks
    of a local map) sees the same sequence, and a run that compacts gives
    the bits of one with room to spare (tests/test_torch_landmark_rows.py).
    Returns `remap`, (num_lm before,) int32: old id -> new id, -1 for a
    reclaimed row."""
    L = store.num_lm
    keep = store.lm_valid[:L].copy()
    named = store.kf_obs_lm[:store.num_kf]
    keep[named[named >= 0]] = True
    for ids in hold:
        ids = np.asarray(ids).reshape(-1)
        keep[ids[ids >= 0]] = True
    old = np.flatnonzero(keep)
    n = len(old)
    remap = np.full(L, -1, np.int32)
    remap[old] = np.arange(n, dtype=np.int32)
    blank = MapStore(max_keyframes=1, max_landmarks=1, feats_per_kf=1,
                     obs_per_landmark=store.obs_per_landmark, num_words=1,
                     corner_per_kf=1, flat_per_kf=1)
    for name, value in vars(store).items():
        if name.startswith("lm_") and isinstance(value, np.ndarray):
            value[:n] = value[old]
            value[n:L] = getattr(blank, name)[0]
    bound = named >= 0
    named[bound] = remap[named[bound]]
    store.num_lm = n
    store.version += 1
    return remap
