"""SLAM system facade: tracking + local mapping (+ loop closing) on one device.

Counterpart of `sqrtlm_slam_tpu/pipeline/system.py` with every sensor mode of
the reference: `track_depth` (RGB-D), `track_stereo`, `track_monocular`,
`track_fusion` (camera+LiDAR) and `track_frame` (a frame built by the caller):
`SlamSystem(cam, cfg, device)` (the CUDA device unless the caller passes
another, e.g. `device="cpu"`) builds the shared numpy `MapStore`, the
tracker, the local mapper and, with `cfg.loop_detection`, the loop closer,
and recovers the per-frame trajectory
from poses stored relative to reference keyframes, so BA and loop
corrections propagate at save time. `save` / `load` checkpoint and resume
the map (a resumed system starts LOST and relocalises); localisation mode
tracks the frozen map without inserting keyframes.

Every `track_*` entry builds its frame through the captured CUDA graphs of
`pipeline/frame.py` (`build_frame_jit`, `build_frame_stereo_jit`; a fusion
scan padded by `pad_cloud` first), as the JAX package builds through its
jitted builds; on the CPU they run eagerly.

A vocabulary is attached as in the JAX package: the one given, else the
shipped asset (`cfg.use_shipped_vocab`), else one trained lazily from the
first keyframe with enough descriptors. Every keyframe gets its word ids
and BoW vector.

Local mapping and loop closing run synchronously per keyframe, or, with
`cfg.async_mapping`, on a worker thread fed by a keyframe queue (the
reference's LocalMapping / LoopClosing threads). One RLock, `map_lock`,
then orders host access to the numpy store: the worker holds it while it
maps a keyframe, the tracker for its store-touching sections, the loop
closer (whose global BA then runs on its own thread) for its corrections.
Both threads launch on the default CUDA stream. An exception on the worker
is stored and raised in the tracking thread at the next `track_*`, `flush`
or `shutdown` (the JAX package's worker would stop and leave `flush`
waiting). A keyframe is queued only when the frame that made it is done
(`_hand_off_keyframes` at the end of each `track_*`, in `flush` and in
`shutdown`): the frame's trajectory entry is recorded against the
keyframe's pose as inserted, not against whatever local BA on the worker
has made of it by then (the JAX package queues it at insertion, so which
of the two it records depends on which thread takes the lock first).
`flush` drains the queue and waits for global BA; `shutdown`
also stops the worker. With pipelined tracking, `get_trajectory`,
`get_slam_result`, `trajectory_frame_ids` and `shutdown` finalize the
deferred frame first (`Tracker.flush`).

The store allocates landmark rows append-only and culling leaves most of
them dead; before a frame is tracked with fewer than two keyframes' worth
of rows left (a keyframe creates at most `feats_per_kf` landmarks in
tracking and as many in local mapping), `_reclaim_landmarks` compacts the
rows (`mapstore.compact_landmarks`, ids in order) and renumbers the ids the
tracker and the local mapper hold. The JAX package's store, the same class,
asserts when its rows run out; a run that compacts gives the bits of one
whose store has room to spare (synchronous mapping, or asynchronous mapping
flushed after every frame: an unflushed worker's timing varies run to run).
"""

from __future__ import annotations

import queue
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..frontend import orb, vocab as vocab_mod
from ..geometry import so3
from ..lidar.features import LidarConfig, pad_cloud
from ..loop import LoopCloser, LoopClosingConfig
from ..loop.database import KeyFrameDatabase
from ..mapstore import MapStore, checkpoint, compact_landmarks
from ..utils import desc_to_numpy, to_host
from .frame import Frame, build_frame_jit, build_frame_stereo_jit
from .local_mapping import LocalMapper, LocalMappingConfig
from .tracking import Tracker, TrackingConfig, TrackState


# Keyframes' worth of landmark rows kept free (`SlamSystem._reclaim_landmarks`):
# one keyframe creates at most `feats_per_kf` landmarks in tracking and as
# many in local mapping.
RECLAIM_KEYFRAMES = 2


class SystemConfig(NamedTuple):
    orb: orb.ORBConfig = orb.ORBConfig()
    tracking: TrackingConfig = TrackingConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    max_keyframes: int = 512
    max_landmarks: int = 60000
    loop_detection: bool = False  # attach the loop closer
    lidar: Optional[LidarConfig] = None  # LiDAR feature extraction for fusion
    use_shipped_vocab: bool = True  # load the shipped vocabulary when none is given
    # Local mapping + loop closing on a worker thread, overlapping tracking.
    # Off by default: the sequential driver is deterministic.
    async_mapping: bool = False


class SlamSystem:
    def __init__(self, cam: Camera, cfg: SystemConfig = SystemConfig(), device="cuda",
                 vocabulary: Optional[vocab_mod.Vocabulary] = None,
                 loop_cfg: Optional[LoopClosingConfig] = None):
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        if vocabulary is None and cfg.use_shipped_vocab:
            vocabulary = vocab_mod.load_default(self.device)
        self.vocabulary = vocabulary
        self.store = MapStore(
            max_keyframes=cfg.max_keyframes,
            max_landmarks=cfg.max_landmarks,
            feats_per_kf=cfg.orb.max_features,
            num_words=vocabulary.num_words if vocabulary is not None else 1000,
        )
        self.map_lock = threading.RLock() if cfg.async_mapping else None
        self._wire_tracker_and_mapper()
        self.loop_closer = None
        if cfg.loop_detection:
            self.loop_closer = LoopCloser(self.store, cam, voc=vocabulary,
                                          cfg=loop_cfg or LoopClosingConfig(),
                                          device=self.device)
            if cfg.async_mapping:
                # Global BA on its own thread under the shared lock,
                # abandoned when a newer loop closes.
                self.loop_closer.map_lock = self.map_lock
                self.loop_closer.async_gba = True
        self._kf_queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[Exception] = None
        self._shutdown = False
        self._new_keyframes = []  # made by the frame being tracked, not yet queued
        self.landmarks_reclaimed = 0  # rows given back by `_reclaim_landmarks`
        if cfg.async_mapping:
            self._kf_queue = queue.Queue()
            self._worker = threading.Thread(target=self._mapping_worker, daemon=True,
                                            name="mapping-worker")
            self._worker.start()

    def _wire_tracker_and_mapper(self):
        cfg = self.cfg
        # The tracker's scale-aware search must agree with the pyramid shape.
        tracking_cfg = cfg.tracking._replace(
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor
        )
        self.tracker = Tracker(self.store, self.cam, tracking_cfg, device=self.device)
        self.local_mapper = LocalMapper(self.store, self.cam, cfg.local_mapping,
                                        device=self.device)
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.vocab_hook = self._assign_words
        self.tracker.reloc_db = KeyFrameDatabase(self.store)
        if self.map_lock is not None:
            self.tracker.map_lock = self.map_lock

    def _assign_words(self, desc: torch.Tensor, valid: torch.Tensor):
        """Word ids (N,) and BoW vector (W,) of a new keyframe, on the
        device; trains a vocabulary from the first keyframe with >= 50 valid
        descriptors when none exists (returns (None, None) before that)."""
        if self.vocabulary is None:
            d, v = to_host(desc, valid)
            d = desc_to_numpy(d)[v.astype(bool)]
            if len(d) < 50:
                return None, None
            self.vocabulary = vocab_mod.train(d, k=10, depth=3, device=self.device)
            if self.loop_closer is not None:
                self.loop_closer.voc = self.vocabulary
        words = vocab_mod.assign_words(self.vocabulary, desc, valid)
        return words, vocab_mod.bow_vector(self.vocabulary, words)

    def _map_keyframe(self, kf: int):
        self.local_mapper.process_keyframe(kf)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf)

    def _on_new_keyframe(self, kf: int):
        if self._kf_queue is not None:
            self._new_keyframes.append(kf)
        else:
            self._map_keyframe(kf)

    def _hand_off_keyframes(self):
        """Queue the keyframes the tracker made since the last hand-off."""
        for kf in self._new_keyframes:
            self._kf_queue.put(kf)
        self._new_keyframes.clear()

    def _flush_tracker(self):
        """Finalize pipelined tracking's deferred frame and queue what it made."""
        self.tracker.flush()
        if self._kf_queue is not None:
            self._hand_off_keyframes()

    def _mapping_worker(self):
        """Map queued keyframes until the None sentinel. After a failure the
        worker keeps draining the queue without mapping, so `flush` returns
        and the tracking thread raises the stored exception."""
        while True:
            kf = self._kf_queue.get()
            try:
                if kf is None:
                    return
                if self._worker_error is None:
                    with self.map_lock:
                        self._map_keyframe(kf)
            except Exception as e:  # re-raised in the tracking thread
                self._worker_error = e
            finally:
                self._kf_queue.task_done()

    def _raise_worker_error(self):
        if self._worker_error is not None:
            raise RuntimeError("the asynchronous mapping worker failed") from self._worker_error

    def flush(self):
        """Block until every queued keyframe is mapped (asynchronous mapping)
        and any global BA of the loop closer has finished."""
        if self._kf_queue is not None:
            self._hand_off_keyframes()
            self._kf_queue.join()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        self._raise_worker_error()

    def shutdown(self):
        """Finalize the deferred frame, drain and stop the worker, wait for
        global BA (System::Shutdown). Idempotent."""
        self._flush_tracker()
        if self._kf_queue is not None and not self._shutdown:
            self._kf_queue.join()
            self._kf_queue.put(None)
            self._worker.join()
            self._shutdown = True
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        self._raise_worker_error()

    def _track(self, frame: Frame):
        self._raise_worker_error()
        if self._shutdown:
            raise RuntimeError("the mapping worker was shut down")
        self._reclaim_landmarks()
        try:
            return self.tracker.track(frame)
        finally:
            if self._kf_queue is not None:
                self._hand_off_keyframes()

    def _reclaim_landmarks(self):
        """Compact the store's landmark rows when fewer than
        `RECLAIM_KEYFRAMES` keyframes' worth remain (see the module
        docstring). The mapping queue is drained and global BA waited for
        first (`flush`): a GBA gathers the old ids, and with the worker
        idle none starts until this frame's keyframe. The ids held across
        frames keep their rows and are renumbered by their holders
        (`Tracker.held_landmarks` / `remap_landmarks`,
        `LocalMapper.remap_landmarks`)."""
        store = self.store
        if store.num_lm + RECLAIM_KEYFRAMES * store.feats_per_kf <= store.max_landmarks:
            return
        self.flush()
        with self.tracker.map_lock:
            n_before = store.num_lm
            remap = compact_landmarks(store, self.tracker.held_landmarks())
            self.tracker.remap_landmarks(remap)
            self.local_mapper.remap_landmarks(remap)
            self.landmarks_reclaimed += n_before - store.num_lm

    def track_depth(self, image, depth_img):
        """RGB-D entry: (H, W) intensity image and (H, W) depth in metres
        (numpy arrays or tensors). Returns the frame's T_cw (an `SE3` on the
        system's device) or None while uninitialized."""
        img = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        depth = torch.as_tensor(depth_img, dtype=torch.float32).to(self.device)
        frame = build_frame_jit(img, self.cam, self.cfg.orb, depth_img=depth)
        return self._track(frame)

    def track_fusion(self, image, cloud_lidar, T_cam_lidar=None):
        """Camera + LiDAR entry: (H, W) intensity image and the (N, 3) scan
        in the LiDAR frame (x forward, y left, z up; numpy arrays or
        tensors), with `T_cam_lidar` = (R, t) the extrinsics. The cloud
        gives keypoint depth and, with `cfg.lidar` set, the corner / flat
        features of the tight coupling. The scan is padded with NaN rows to
        a size bucket (`pad_cloud`), so scans of varying length share one
        captured graph; rows holding NaN are ignored. Returns the frame's
        T_cw or None while uninitialized or lost."""
        img = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        cloud = torch.as_tensor(pad_cloud(cloud_lidar)).to(self.device)
        if T_cam_lidar is not None:
            T_cam_lidar = tuple(torch.as_tensor(a, dtype=torch.float32).to(self.device)
                                for a in T_cam_lidar)
        frame = build_frame_jit(img, self.cam, self.cfg.orb, cloud_lidar=cloud[:, :3],
                                T_cam_lidar=T_cam_lidar, lidar_cfg=self.cfg.lidar)
        return self._track(frame)

    def track_stereo(self, img_left, img_right):
        """Stereo entry: a rectified (H, W) image pair (numpy arrays or
        tensors); left-right ORB matching inside a row band gives each left
        keypoint its u_right and depth. Returns the frame's T_cw or None
        while uninitialized or lost."""
        left = torch.as_tensor(img_left, dtype=torch.float32).to(self.device)
        right = torch.as_tensor(img_right, dtype=torch.float32).to(self.device)
        return self._track(build_frame_stereo_jit(left, right, self.cam, self.cfg.orb))

    def track_monocular(self, image):
        """Monocular entry: an (H, W) image. The map starts with the two-view
        H/F initialization (up to scale, median depth 1); landmarks then come
        from local mapping's triangulation. Returns the frame's T_cw or None
        while uninitialized or lost."""
        img = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        return self._track(build_frame_jit(img, self.cam, self.cfg.orb))

    def track_frame(self, frame: Frame):
        """Entry for a frame built by the caller (tests, custom front ends)."""
        return self._track(frame)

    @property
    def state(self) -> int:
        return self.tracker.state

    def num_keyframes(self) -> int:
        return int(self.store.kf_valid.sum())

    def num_landmarks(self) -> int:
        return int(self.store.lm_valid.sum())

    # ------------------------------------------------------------------
    # Checkpoint / resume, localisation mode, reset, snapshot
    # ------------------------------------------------------------------

    def save(self, path: str):
        """Write the map and the vocabulary to `path` (.npz)."""
        checkpoint.save_map(self.store, path, vocabulary=self.vocabulary)

    @classmethod
    def load(cls, path: str, cam: Camera, cfg: SystemConfig = SystemConfig(),
             device="cuda", loop_cfg: Optional[LoopClosingConfig] = None) -> "SlamSystem":
        """Resume from a map checkpoint: the system starts LOST and
        relocalises against the loaded map."""
        store, voc = checkpoint.load_map(path, device=device)
        sys_ = cls(cam, cfg, device=device, vocabulary=voc, loop_cfg=loop_cfg)
        version = sys_.store.version
        sys_.store.__dict__.update(store.__dict__)
        # The arrays were swapped in place: no cache keyed on the old store
        # may be served.
        sys_.store.version = version + 1
        sys_.tracker.state = TrackState.LOST
        sys_.tracker.ref_kf = max(store.num_kf - 1, 0)
        return sys_

    def activate_localization_mode(self):
        """Track against the frozen map without inserting keyframes."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """Clear the map and the tracking state (the store's version moves
        on, so no device cache of the old map is served). Queued keyframes
        are mapped first: they belong to the old map."""
        self.flush()
        self.store.reset()
        self._wire_tracker_and_mapper()

    def get_slam_result(self) -> dict:
        """Visualization snapshot, numpy only: keyframe poses, tracking
        state, the landmarks seen last frame, the global map cloud, the
        local-map cloud around the reference keyframe, the trajectory and,
        when it has them, the reference keyframe's LiDAR feature clouds."""
        self._flush_tracker()
        store, tracker = self.store, self.tracker
        kfs = np.where(store.kf_valid[: store.num_kf])[0]
        lms = np.where(store.lm_valid[: store.num_lm])[0]
        local_lms = np.empty(0, np.int64)
        if tracker.ref_kf >= 0:
            window = [tracker.ref_kf] + [int(x) for x in store.best_covisible(tracker.ref_kf, 10)]
            ids = np.unique(store.kf_obs_lm[window])
            ids = ids[ids >= 0]
            local_lms = ids[store.lm_valid[ids]]
        result = {
            "state": tracker.state,
            "ref_kf": tracker.ref_kf,
            "num_inliers": tracker.last_inliers,
            "kf_ids": kfs,
            "kf_R": store.kf_R[kfs].copy(),
            "kf_t": store.kf_t[kfs].copy(),
            "map_points": store.lm_pos[lms].copy(),
            "local_map_points": store.lm_pos[local_lms].copy(),
            "tracked_landmarks": (
                np.asarray([lm for lm, _ in tracker.last_lm_ids])
                if tracker.last_lm_ids is not None else np.empty(0, np.int64)
            ),
            "trajectory": self.get_trajectory(),
        }
        if tracker.ref_kf >= 0 and store.kf_corner_valid[tracker.ref_kf].any():
            k = tracker.ref_kf
            result["lidar_corner"] = store.kf_corner[k][store.kf_corner_valid[k]]
            result["lidar_flat"] = store.kf_flat[k][store.kf_flat_valid[k]]
        return result

    def get_trajectory(self) -> np.ndarray:
        """Per-frame camera-to-world 4x4 poses, T_wc = (T_rel · T_ref_w)^{-1}
        with the current (BA-corrected) reference keyframe poses."""
        self._flush_tracker()  # the deferred frame of pipelined tracking
        out = []
        for _, ref_kf, R_rel, t_rel in self.tracker.trajectory:
            R_ref = self.store.kf_R[ref_kf]
            t_ref = self.store.kf_t[ref_kf]
            R_cw = R_rel @ R_ref
            t_cw = R_rel @ t_ref + t_rel
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = R_cw.T
            T[:3, 3] = -R_cw.T @ t_cw
            out.append(T)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    def trajectory_frame_ids(self) -> np.ndarray:
        """Frame ids matching get_trajectory() rows (lost frames record none)."""
        self._flush_tracker()
        return np.asarray([fid for fid, _, _, _ in self.tracker.trajectory], np.int64)

    def save_trajectory_kitti(self, path: str):
        """KITTI 3x4 row-major format."""
        T = self.get_trajectory()
        with open(path, "w") as f:
            for P in T:
                f.write(" ".join(f"{x:.9e}" for x in P[:3].reshape(-1)) + "\n")

    def save_trajectory_tum(self, path: str, timestamps=None):
        """TUM format: `t tx ty tz qx qy qz qw`."""
        T = self.get_trajectory()
        with open(path, "w") as f:
            for i, P in enumerate(T):
                ts = timestamps[i] if timestamps is not None else float(i)
                q = so3.mat_to_quat(torch.as_tensor(P[:3, :3], dtype=torch.float32)).numpy()
                t = P[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )
