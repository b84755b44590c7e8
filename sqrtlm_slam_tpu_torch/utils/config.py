"""Sequence / sensor configuration presets.

Counterpart of `sqrtlm_slam_tpu/utils/config.py`. The reference layers
OpenCV YAML files (paths and the loop flag; per-sequence intrinsics, `bf`,
`ThDepth: 125`, 2000 ORB features, pyramid 8 x 1.2, FAST 20/7; the LiDAR
ring counts and feature caps). Intrinsics come from the dataset's own
calib.txt (`io/kitti.py`); this module carries the remaining per-sequence
knobs as plain NamedTuples.
"""

from __future__ import annotations

from typing import NamedTuple

from ..frontend.orb import ORBConfig
from ..lidar.features import LidarConfig
from ..pipeline.tracking import TrackingConfig


class SequenceConfig(NamedTuple):
    orb: ORBConfig
    tracking: TrackingConfig
    lidar: LidarConfig
    th_depth_scale: float  # ThDepth of the reference's config (125)


def kitti_sequence_config(seq: str = "00") -> SequenceConfig:
    """The reference's KITTI settings: 2000 features, 8 x 1.2 pyramid, FAST
    20/7, HDL-64E LiDAR rings."""
    orb = ORBConfig(max_features=2000, num_levels=8, scale_factor=1.2, fast_threshold=20)
    return SequenceConfig(orb=orb, tracking=TrackingConfig(close_depth=40.0),
                          lidar=LidarConfig(), th_depth_scale=125.0)


def load_yaml_config(path: str, seq: str = "00") -> SequenceConfig:
    """Load a reference-style YAML config file over the sequence defaults.

    Accepts the reference's key names (`ORBextractor.nFeatures`,
    `scaleFactor`, `nLevels`, `iniThFAST`, `ThDepth`) and the snake_case
    fields of `ORBConfig` / `TrackingConfig` under `orb:` / `tracking:`
    sections. Unknown keys are ignored, as cv::FileStorage ignores them.
    Needs PyYAML (imported here, not with the module)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    base = kitti_sequence_config(seq)

    orb_kw = {}
    trk_kw = {}
    flat = {k: v for k, v in raw.items() if not isinstance(v, dict)}
    ref_orb = {
        "ORBextractor.nFeatures": "max_features",
        "ORBextractor.scaleFactor": "scale_factor",
        "ORBextractor.nLevels": "num_levels",
        "ORBextractor.iniThFAST": "fast_threshold",
    }
    for rk, ok in ref_orb.items():
        if rk in flat:
            orb_kw[ok] = type(getattr(base.orb, ok))(flat[rk])
    th_depth = float(flat["ThDepth"]) if "ThDepth" in flat else base.th_depth_scale
    for k, v in (raw.get("orb") or {}).items():
        if k in base.orb._fields:
            orb_kw[k] = type(getattr(base.orb, k))(v)
    for k, v in (raw.get("tracking") or {}).items():
        if k in base.tracking._fields:
            trk_kw[k] = type(getattr(base.tracking, k))(v)
    return SequenceConfig(
        orb=base.orb._replace(**orb_kw),
        tracking=base.tracking._replace(**trk_kw),
        lidar=base.lidar,
        th_depth_scale=th_depth,
    )
