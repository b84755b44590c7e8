"""K1: pairwise Hamming distances of packed ORB descriptors.

Counterpart of `sqrtlm_slam_tpu/ops/hamming.py`. Descriptors are (N, 8)
int32 tensors holding the bits of the JAX package's (N, 8) uint32 words
(`np.uint32 -> .view(np.int32)`): torch has no unsigned 32-bit shift on the
CPU, and XOR/popcount do not care about the sign bit.

`hamming_matrix` dispatches by tensor device only: a CPU tensor takes the
plain PyTorch version (XOR + byte-LUT popcount); a CUDA tensor launches the
hand-written tensor-core kernel `csrc/hamming.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cache
from . import build

_WORDS = 8
# Rows of the query processed per step of the plain version: bounds its
# (rows, T, 32) byte intermediate.
_PLAIN_ROWS = 256

# Number of K1 launches in this process (reset by callers that count; a
# captured graph adds its launches at each replay, `utils.cache`).
launch_count = 0


@functools.lru_cache(maxsize=None)
def _popcount_lut(device: torch.device) -> torch.Tensor:
    """Set bits of every byte value, kept on `device` once per process."""
    return torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.uint8,
                        device=device)


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits summed over the last axis of int32 words: (..., W) -> (...)
    int32 (byte-table popcount; elementwise, no pairing)."""
    lut = _popcount_lut(x.device)
    nbits = lut[x.contiguous().view(torch.uint8).to(torch.int32)]
    return nbits.sum(dim=-1, dtype=torch.int32)


def hamming_matrix_plain(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (Q, 8) x (T, 8) int32 -> (Q, T) int32."""
    Q, T = desc_q.shape[0], desc_t.shape[0]
    out = torch.empty((Q, T), dtype=torch.int32, device=desc_q.device)
    for s in range(0, Q, _PLAIN_ROWS):
        out[s:s + _PLAIN_ROWS] = popcount_words(
            torch.bitwise_xor(desc_q[s:s + _PLAIN_ROWS, None, :], desc_t[None, :, :]))
    return out


def _check_desc(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 descriptors, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != _WORDS:
        raise ValueError(f"{name}: expected shape (N, {_WORDS}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor (the kernel loads "
                         "rows with 16-byte loads)")


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C launch function (built at first use), typed once."""
    fn = build.load("hamming").hamming_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hamming_matrix_cuda(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream: (Q, 8) x (T, 8) int32 -> (Q, T) int32."""
    _check_desc(desc_q, "desc_q")
    _check_desc(desc_t, "desc_t")
    if desc_q.device != desc_t.device:
        raise ValueError("desc_q and desc_t lie on different devices")
    fn = _launch_fn()
    Q, T = desc_q.shape[0], desc_t.shape[0]
    out = torch.empty((Q, T), dtype=torch.int32, device=desc_q.device)
    if Q == 0 or T == 0:
        return out
    with torch.cuda.device(desc_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(desc_q.data_ptr(), desc_t.data_ptr(), out.data_ptr(), Q, T, stream)
    build.check(rc, "hamming_launch")
    cache.count_launch(__name__, "launch_count")
    return out


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances, (Q, 8) x (T, 8) int32 -> (Q, T) int32."""
    if desc_q.device.type == "cuda":
        return hamming_matrix_cuda(desc_q, desc_t)
    if desc_q.device.type == "cpu":
        return hamming_matrix_plain(desc_q, desc_t)
    raise ValueError(f"no Hamming implementation for device {desc_q.device}")
