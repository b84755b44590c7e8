"""Residual + Jacobian library (reprojection)."""

from . import reprojection
from .reprojection import Camera

__all__ = ["reprojection", "Camera"]
