"""Build-at-first-use for the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so
nvcc compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The shared object is keyed on a hash of the source and the flags, written
under `build/kernels/` at the repository root (git-ignored), and loaded with
ctypes. Nothing is built when a module is imported: `load()` runs inside the
wrapper that launches the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (ctypes.CDLL, build seconds (0.0 when the .so was already built),
# ptxas report). One entry per kernel source for the life of the process.
_LOADED: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def load(name: str) -> ctypes.CDLL:
    """Return the loaded kernel library `name`, compiling it if needed."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    seconds, report = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc {res.returncode}):\n{res.stderr}"
            )
        os.replace(tmp, so)
        report = res.stderr
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = (lib, seconds, report)
    return lib


def load_all(names) -> None:
    """Load several kernel libraries, running their nvcc builds in parallel
    (one compiler process per source, all started together)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for _ in pool.map(load, names):
            pass


def build_info(name: str) -> dict:
    """Build seconds and the ptxas register/shared-memory report of `name`."""
    _, seconds, report = _LOADED[name]
    return {"build_s": seconds, "ptxas": report}


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
