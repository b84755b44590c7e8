"""ctypes binding of the native prefetching KITTI loader.

Counterpart of `sqrtlm_slam_tpu/io/native_loader.py`: a C++ thread pool
(`native/dataloader/kitti_loader.cpp`, libpng) decodes PNG images and
velodyne scans ahead of the SLAM loop. The port builds its own shared
object from that source at first use,

    g++ -O3 -shared -fPIC -std=c++17 kitti_loader.cpp -lpng -lz -pthread

into `build/native/` at the repository root (git-ignored), keyed on a hash
of the source and the flags; it never writes into `native/dataloader/`.
`NativeKittiLoader.available()` is False where no compiler or libpng is
present (the runner then reads with `io/kitti.py`). Nothing is built when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dataloader" / "kitti_loader.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lpng", "-lz", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def _build() -> Path:
    """Compile the loader unless this source and these flags are built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    so = BUILD_DIR / f"libkittiloader-{digest[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at first use; None when it cannot be
    built or loaded (`build_error()` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        p_int, p_float = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.kl_open.restype = c_void_p
        lib.kl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, c_int, c_int, c_int]
        lib.kl_close.restype = None
        lib.kl_close.argtypes = [c_void_p]
        lib.kl_prefetch.restype = None
        lib.kl_prefetch.argtypes = [c_void_p, c_int]
        lib.kl_frame_info.restype = c_int
        lib.kl_frame_info.argtypes = [c_void_p, c_int, p_int, p_int, p_int]
        lib.kl_copy_image.restype = c_int
        lib.kl_copy_image.argtypes = [c_void_p, c_int, p_float]
        lib.kl_copy_velodyne.restype = c_int
        lib.kl_copy_velodyne.argtypes = [c_void_p, c_int, p_float]
        _lib = lib
        return lib


def build_error() -> Optional[str]:
    """Why the loader is unavailable, or None."""
    return _build_error


class NativeKittiLoader:
    """Background-prefetching frame reader for one KITTI sequence."""

    def __init__(self, image_dir: Optional[str], velo_dir: Optional[str], num_frames: int,
                 n_threads: int = 4, window: int = 8):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.kl_open((image_dir or "").encode(), (velo_dir or "").encode(),
                              num_frames, n_threads, window)
        self.num_frames = num_frames

    @staticmethod
    def available() -> bool:
        return _load_lib() is not None

    def prefetch(self, idx: int):
        """Decode frames [idx, idx + window) in the background; drop older ones."""
        self._lib.kl_prefetch(self._h, idx)

    def frame(self, idx: int):
        """(image (H, W) float32 or None, velodyne (N, 4) float32 or None);
        decodes on the calling thread a frame not prefetched."""
        if not 0 <= idx < self.num_frames:
            raise IndexError(f"frame {idx} outside [0, {self.num_frames})")
        h, w, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._lib.kl_frame_info(self._h, idx, h, w, n)
        img = None
        if h.value > 0:
            img = np.empty((h.value, w.value), np.float32)
            self._lib.kl_copy_image(self._h, idx,
                                    img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        velo = None
        if n.value > 0:
            velo = np.empty((n.value, 4), np.float32)
            self._lib.kl_copy_velodyne(self._h, idx,
                                       velo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return img, velo

    def close(self):
        if self._h:
            self._lib.kl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, OSError):
            pass
