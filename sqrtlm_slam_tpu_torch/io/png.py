"""PNG decoding and encoding on Python's `zlib`, for machines without PIL.

`read_image` (io/kitti.py) and `kitti_synth.generate` use PIL where it is
installed, as the JAX package does; where it is not, they use this module.
It reads what KITTI and the generator write: 8-bit grayscale and 8-bit RGB,
not interlaced, with each row under any of the five PNG filter types. RGB
converts to luminance by PIL's integer formula (ITU-R 601-2, 16-bit fixed
point, rounded), so `read_gray` gives PIL's `convert("L")` bit for bit.
`encode` writes every row unfiltered (filter type 0): other bytes than
PIL's encoder, the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> channels (gray, RGB)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_sequential(kind: int, raw: bytearray, prior: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) rows: each byte depends on the decoded byte
    `bpp` to its left, so the row is undone left to right."""
    out = raw
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
        return out
    for i in range(n):
        if i >= bpp:
            a, c = out[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array, (H, W) for grayscale or (H, W, 3) for RGB."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit gray or RGB, not interlaced)")
    ch = _CHANNELS[color]
    stride = W * ch
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != H * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = flat.reshape(H, stride + 1)
    kinds, img = rows[:, 0], rows[:, 1:].copy()
    if int(kinds.max(initial=0)) > 4:
        raise ValueError("PNG row with an unknown filter type")
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind = int(kinds[y])
        row = img[y]
        if kind == 1:  # Sub: a running sum per channel
            r = row.reshape(W, ch).astype(np.int64)
            row[:] = (np.cumsum(r, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row += prior
        elif kind in (3, 4):
            row[:] = np.frombuffer(
                _unfilter_sequential(kind, bytearray(row.tobytes()), prior.tobytes(), ch),
                np.uint8)
        prior = row
    return img if ch == 1 else img.reshape(H, W, 3)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) uint8 by PIL's formula:
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    r = rgb.astype(np.uint32)
    return ((r[..., 0] * 19595 + r[..., 1] * 38470 + r[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """A grayscale or RGB PNG file as (H, W) uint8 luminance."""
    with open(path, "rb") as f:
        img = decode(f.read())
    return img if img.ndim == 2 else rgb_to_gray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes, every row unfiltered."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                         and img.shape[2] != 3):
        raise ValueError(f"encode takes (H, W) or (H, W, 3) uint8, not {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
