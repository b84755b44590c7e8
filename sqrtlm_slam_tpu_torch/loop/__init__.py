"""Loop closing: place recognition, Sim3 verification, essential graph, global BA."""

from .closing import LoopCloser, LoopClosingConfig  # noqa: F401
from .database import KeyFrameDatabase  # noqa: F401
