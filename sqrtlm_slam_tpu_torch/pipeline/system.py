"""SLAM system facade: tracking + local mapping (+ loop closing) on one device.

Counterpart of `sqrtlm_slam_tpu/pipeline/system.py` for the RGB-D entry
point: `SlamSystem(cam, cfg, device)` (the CUDA device unless the caller
passes another, e.g. `device="cpu"`) builds the shared numpy `MapStore`,
the tracker, the local mapper and, with `cfg.loop_detection`, the loop
closer (all run synchronously per keyframe), and recovers the per-frame
trajectory from poses stored relative to reference keyframes, so BA and
loop corrections propagate at save time.

A vocabulary is attached as in the JAX package: the one given, else the
shipped asset (`cfg.use_shipped_vocab`), else one trained lazily from the
first keyframe with enough descriptors. Every keyframe gets its word ids
and BoW vector. The asynchronous mapping worker is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..frontend import orb, vocab as vocab_mod
from ..geometry import so3
from ..loop import LoopCloser, LoopClosingConfig
from ..loop.database import KeyFrameDatabase
from ..mapstore import MapStore
from ..utils import desc_to_numpy, to_host
from .frame import build_frame
from .local_mapping import LocalMapper, LocalMappingConfig
from .tracking import Tracker, TrackingConfig


class SystemConfig(NamedTuple):
    orb: orb.ORBConfig = orb.ORBConfig()
    tracking: TrackingConfig = TrackingConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    max_keyframes: int = 512
    max_landmarks: int = 60000
    loop_detection: bool = False  # attach the loop closer
    use_shipped_vocab: bool = True  # load the shipped vocabulary when none is given


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
        # The tracker's scale-aware search must agree with the pyramid shape.
        tracking_cfg = cfg.tracking._replace(
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor
        )
        self.tracker = Tracker(self.store, cam, tracking_cfg, device=self.device)
        self.local_mapper = LocalMapper(self.store, cam, cfg.local_mapping, device=self.device)
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.vocab_hook = self._assign_words
        self.tracker.reloc_db = KeyFrameDatabase(self.store)
        self.loop_closer = None
        if cfg.loop_detection:
            self.loop_closer = LoopCloser(self.store, cam, voc=vocabulary,
                                          cfg=loop_cfg or LoopClosingConfig(),
                                          device=self.device)

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

    def _on_new_keyframe(self, kf: int):
        self.local_mapper.process_keyframe(kf)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf)

    def flush(self):
        """Wait for an asynchronous global BA of the loop closer (the
        mapping itself runs synchronously)."""
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    def shutdown(self):
        """Drain pending work (System::Shutdown)."""
        self.flush()

    def track_depth(self, image, depth_img):
        """RGB-D entry: (H, W) intensity image and (H, W) depth in metres
        (numpy arrays or tensors). Returns the frame's T_cw (an `SE3` on the
        system's device) or None while uninitialized."""
        img = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        depth = torch.as_tensor(depth_img, dtype=torch.float32).to(self.device)
        frame = build_frame(img, self.cam, self.cfg.orb, depth_img=depth)
        return self.tracker.track(frame)

    @property
    def state(self) -> int:
        return self.tracker.state

    def num_keyframes(self) -> int:
        return int(self.store.kf_valid.sum())

    def num_landmarks(self) -> int:
        return int(self.store.lm_valid.sum())

    def get_trajectory(self) -> np.ndarray:
        """Per-frame camera-to-world 4x4 poses, T_wc = (T_rel · T_ref_w)^{-1}
        with the current (BA-corrected) reference keyframe poses."""
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
