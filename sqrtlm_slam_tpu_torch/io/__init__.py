"""Dataset IO: KITTI odometry loading, calibration, trajectory writers, the
zlib PNG codec and the native prefetching loader."""

from . import kitti
from .kitti import KittiCalib, KittiSequence

__all__ = ["kitti", "KittiCalib", "KittiSequence"]
