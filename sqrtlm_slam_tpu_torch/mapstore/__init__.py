"""SoA map state: keyframes, landmarks, covisibility, spanning tree."""

from .store import COVIS_THRESHOLD, MapStore, compact_landmarks

__all__ = ["MapStore", "COVIS_THRESHOLD", "compact_landmarks"]
