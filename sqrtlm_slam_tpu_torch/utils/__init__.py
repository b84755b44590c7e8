"""Host <-> device helpers, and the timing and configuration utilities.

Every read of device results by the host goes through `to_host`, which
counts the reads that wait for the device (`host_reads`): the pipeline's
host syncs per tracked frame are read off this counter (from every thread:
the asynchronous mapping worker's reads count too).

`graph_captures` and `graph_replays` count the CUDA graphs that
`utils/cache.py` (the counterpart of the JAX package's jit) captures and
replays.

`StageTimer` / `TicToc` (`utils/timing.py`) and `SequenceConfig` /
`kitti_sequence_config` (`utils/config.py`) are exported lazily, as in the
JAX package: `config.py` imports the pipeline, which imports this module.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Reads that copied device tensors to the host (reset by callers that count).
host_reads = 0
# CUDA graphs captured and replayed by `utils.cache` (reset by callers that count).
graph_captures = 0
graph_replays = 0
_reads_lock = threading.Lock()

_LAZY = {
    "StageTimer": ".timing",
    "TicToc": ".timing",
    "SequenceConfig": ".config",
    "kitti_sequence_config": ".config",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(name)


def to_host(*xs):
    """Copy tensors to host numpy arrays: one counted read for the call when
    any of them lies on an accelerator. Returns one array or a tuple."""
    global host_reads
    if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in xs):
        with _reads_lock:
            host_reads += 1
    out = tuple(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in xs)
    return out[0] if len(out) == 1 else out


def desc_to_torch(desc_u32: np.ndarray, device) -> torch.Tensor:
    """(N, 8) uint32 descriptor words -> (N, 8) int32 tensor of the same bits."""
    return torch.as_tensor(np.array(desc_u32, np.uint32).view(np.int32),
                           device=device)


def desc_to_numpy(desc_i32) -> np.ndarray:
    """(N, 8) int32 descriptor bits (tensor or array) -> (N, 8) uint32 words."""
    a = desc_i32.detach().cpu().numpy() if isinstance(desc_i32, torch.Tensor) else desc_i32
    return np.ascontiguousarray(a, np.int32).view(np.uint32)
