"""JAX-package objects -> port objects, through numpy.

The parity tests build inputs once and hand them to both packages; these
functions take the JAX package's NamedTuples (any field that converts with
`np.asarray`) and return the port's, on a chosen device. Descriptor words
cross as (N, 8) int32 holding the same bits as the (N, 8) uint32 words.
Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .factors.reprojection import Camera
from .frontend.orb import Keypoints, ORBConfig
from .frontend.vocab import Vocabulary
from .geometry.se3 import SE3
from .geometry.sim3 import Sim3
from .lidar.features import LidarConfig, LidarFeatures
from .lidar.odometry import LocalMap
from .lidar.voxel_map import VoxelMap
from .loop.closing import LoopClosingConfig
from .loop.essential_graph import PoseGraphProblem
from .optim.schur import BAProblem
from .optim.schur_bucketed import BucketedBAProblem, bucketed_from_numpy
from .parallel.dist_ba import ShardedBAProblem, ShardedBucketedBA
from .pipeline.frame import Frame
from .pipeline.local_mapping import LocalMappingConfig
from .pipeline.system import SystemConfig
from .pipeline.tracking import LocalMapBuffer, TrackingConfig
from .utils import desc_to_torch


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(
        dtype if dtype is not None else torch.float32)


def _fields(cls, cfg):
    """Build the port config `cls` from the same-named fields of `cfg`."""
    src = cfg._asdict()
    return cls(**{k: src[k] for k in cls._fields if k in src})


def camera(cam) -> Camera:
    return Camera(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(cam.bf))


def orb_config(cfg) -> ORBConfig:
    return _fields(ORBConfig, cfg)


def tracking_config(cfg) -> TrackingConfig:
    return _fields(TrackingConfig, cfg)


def local_mapping_config(cfg) -> LocalMappingConfig:
    return _fields(LocalMappingConfig, cfg)


def lidar_config(cfg) -> LidarConfig:
    return _fields(LidarConfig, cfg)


def system_config(cfg) -> SystemConfig:
    lidar = getattr(cfg, "lidar", None)
    return SystemConfig(
        lidar=lidar_config(lidar) if lidar is not None else None,
        orb=orb_config(cfg.orb), tracking=tracking_config(cfg.tracking),
        local_mapping=local_mapping_config(cfg.local_mapping),
        max_keyframes=cfg.max_keyframes, max_landmarks=cfg.max_landmarks,
        loop_detection=cfg.loop_detection, use_shipped_vocab=cfg.use_shipped_vocab,
        async_mapping=cfg.async_mapping,
    )


def loop_closing_config(cfg) -> LoopClosingConfig:
    return _fields(LoopClosingConfig, cfg)


def se3(T, device="cpu") -> SE3:
    return SE3(_t(T.R, device), _t(T.t, device))


def keypoints(kp, device="cpu") -> Keypoints:
    return Keypoints(
        xy=_t(kp.xy, device), score=_t(kp.score, device), angle=_t(kp.angle, device),
        octave=_t(kp.octave, device, torch.int32), valid=_t(kp.valid, device, torch.bool),
        desc=desc_to_torch(np.asarray(kp.desc), device),
    )


def lidar_features(lf, device="cpu") -> LidarFeatures:
    src = lf._asdict()
    return LidarFeatures(**{k: _t(v, device, torch.bool if k.endswith("_valid") else None)
                            for k, v in src.items()})


def voxel_map(vm, device="cpu") -> VoxelMap:
    return VoxelMap(points=_t(vm.points, device), keys=_t(vm.keys, device, torch.int32),
                    payload=_t(vm.payload, device), cell=float(vm.cell),
                    valid=_t(vm.valid, device, torch.bool))


def local_map(lm, device="cpu") -> LocalMap:
    return LocalMap(corner=voxel_map(lm.corner, device), flat=voxel_map(lm.flat, device))


def frame(fr, device="cpu") -> Frame:
    lidar = getattr(fr, "lidar", None)
    return Frame(kp=keypoints(fr.kp, device), uvr=_t(fr.uvr, device),
                 depth=_t(fr.depth, device), inv_sigma2=_t(fr.inv_sigma2, device),
                 lidar=lidar_features(lidar, device) if lidar is not None else None)


def ba_problem(prob, device="cpu") -> BucketedBAProblem:
    return bucketed_from_numpy({k: np.asarray(v) for k, v in prob._asdict().items()}, device)


_BA_DTYPES = {"pose_fixed": torch.bool, "pose_valid": torch.bool, "point_valid": torch.bool,
              "obs_cam": torch.int32, "obs_pt": torch.int32, "obs_valid": torch.bool}


def flat_ba_problem(prob, device="cpu") -> BAProblem:
    """The flat (E,) problem of `optim/schur.py`, as tensors."""
    src = prob._asdict()
    return BAProblem(**{k: _t(src[k], device, _BA_DTYPES.get(k)) for k in BAProblem._fields})


def sharded_ba_problem(sp) -> ShardedBAProblem:
    """A JAX sharded flat problem as the port's partitioner lays it out
    (host numpy, leading shard axis)."""
    return ShardedBAProblem(**{k: np.asarray(v) for k, v in sp._asdict().items()})


def sharded_bucketed(sp) -> ShardedBucketedBA:
    """A JAX sharded bucketed problem in the port's host layout."""
    return ShardedBucketedBA(**{k: np.asarray(v) for k, v in sp._asdict().items()})


def vocabulary(voc, device="cpu") -> Vocabulary:
    return Vocabulary(
        centroids=tuple(desc_to_torch(np.asarray(c), device) for c in voc.centroids),
        idf=_t(voc.idf, device), k=int(voc.k),
    )


def sim3(S, device="cpu") -> Sim3:
    return Sim3(_t(S.s, device), _t(S.R, device), _t(S.t, device))


def pose_graph_problem(p, device="cpu") -> PoseGraphProblem:
    src = p._asdict()
    dtypes = {"fixed": torch.bool, "valid": torch.bool, "e_valid": torch.bool,
              "e_i": torch.int32, "e_j": torch.int32}
    return PoseGraphProblem(**{k: _t(src[k], device, dtypes.get(k))
                               for k in PoseGraphProblem._fields})


def local_map_buffer(lm, device="cpu") -> LocalMapBuffer:
    return LocalMapBuffer(
        ids=np.asarray(lm.ids).astype(np.int32), pos=_t(lm.pos, device),
        desc=desc_to_torch(np.asarray(lm.desc), device),
        valid=_t(lm.valid, device, torch.bool), max_dist=_t(lm.max_dist, device),
    )
