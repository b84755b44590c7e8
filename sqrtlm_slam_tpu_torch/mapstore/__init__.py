"""SoA map state: keyframes, landmarks, covisibility, spanning tree."""

from .store import COVIS_THRESHOLD, MapStore

__all__ = ["MapStore", "COVIS_THRESHOLD"]
