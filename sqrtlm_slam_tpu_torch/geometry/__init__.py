"""SO(3) / SE(3) Lie-group operations."""

from . import se3, so3
from .se3 import SE3

__all__ = ["se3", "so3", "SE3"]
