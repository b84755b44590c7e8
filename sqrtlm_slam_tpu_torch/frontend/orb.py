"""ORB feature extraction — pyramid FAST + oriented BRIEF on tensors.

Counterpart of `sqrtlm_slam_tpu/frontend/orb.py`, same algorithm and the
same fixed-capacity output:
  * dense FAST-9/16 at two thresholds from one circle-difference stack,
    3x3 non-maximum suppression, border kill;
  * grid-bucketed top-k (per-cell best corners, then a global top-N) with
    the per-cell fallback to the low-threshold map; ties break toward the
    lower index (a stable descending sort reproduces `lax.top_k`);
  * intensity-centroid orientation from row-prefix-sum moment maps;
  * steered BRIEF on a 7x7 sigma-2 blurred level with the identical seeded
    pattern table, packed to (N, 8) int32 words.

The pyramid reproduces `jax.image.resize(method="linear")`, which
antialiases when it downsamples: its triangle-kernel weight matrices are
built in numpy exactly as JAX builds them and applied as two separable
matrix products. The blur is written as shifted sums (no convolution
library, so no TF32 path on the GPU).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (level-0 pixel coordinates)."""

    xy: torch.Tensor  # (N, 2) float32
    score: torch.Tensor  # (N,)
    angle: torch.Tensor  # (N,) radians
    octave: torch.Tensor  # (N,) int32
    valid: torch.Tensor  # (N,) bool
    desc: torch.Tensor  # (N, 8) int32 — the bits of the 256-bit descriptor

    @property
    def capacity(self):
        return self.xy.shape[0]


class ORBConfig(NamedTuple):
    max_features: int = 2000
    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20
    fast_min_threshold: int = 7
    cell_size: int = 32
    per_cell: int = 4
    patch_size: int = 31


def scale_factors(cfg: ORBConfig) -> np.ndarray:
    return np.array([cfg.scale_factor**i for i in range(cfg.num_levels)], dtype=np.float32)


def level_sigma2(cfg: ORBConfig) -> np.ndarray:
    s = scale_factors(cfg)
    return (s * s).astype(np.float32)


def features_per_level(cfg: ORBConfig) -> List[int]:
    """Geometric distribution of the feature budget over levels."""
    factor = 1.0 / cfg.scale_factor
    n_first = cfg.max_features * (1 - factor) / (1 - factor**cfg.num_levels)
    counts = []
    acc = 0
    for i in range(cfg.num_levels - 1):
        c = int(round(n_first * factor**i))
        counts.append(c)
        acc += c
    counts.append(max(cfg.max_features - acc, 0))
    return counts


# ----------------------------------------------------------------------------
# FAST corner detection (dense, whole image)
# ----------------------------------------------------------------------------


def _score_from_diff(diff: torch.Tensor, threshold: float) -> torch.Tensor:
    """(16, H, W) neighbor-minus-center stack -> (H, W) NMS'd FAST scores."""
    _, H, W = diff.shape
    brighter = diff > threshold
    darker = diff < -threshold

    def arc_any(mask):
        m2 = torch.cat([mask, mask], dim=0)
        acc = m2[0:16]
        for j in range(1, 9):
            acc = acc & m2[j:j + 16]
        return torch.any(acc, dim=0)

    is_corner = arc_any(brighter) | arc_any(darker)
    score = torch.sum(
        torch.where(brighter | darker, torch.abs(diff) - threshold, torch.zeros_like(diff)),
        dim=0,
    )
    score = torch.where(is_corner, score, torch.zeros_like(score))

    padded = torch.nn.functional.pad(score, (1, 1, 1, 1), value=-1.0)
    neigh = torch.stack(
        [
            padded[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        dim=0,
    )
    is_max = score > torch.amax(neigh, dim=0) - 1e-6
    score = torch.where(is_max, score, torch.zeros_like(score))

    border = 19
    ys = torch.arange(H, device=diff.device)[:, None]
    xs = torch.arange(W, device=diff.device)[None, :]
    in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    return torch.where(in_border, score, torch.zeros_like(score))


def _circle_diff(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) Bresenham-circle neighbor-minus-center difference stack."""
    neigh = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in _FAST_OFFSETS],
        dim=0,
    )
    return neigh - img[None]


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    return _score_from_diff(_circle_diff(img), threshold)


def fast_scores_dual(
    img: torch.Tensor, threshold: float, min_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score maps at both detection thresholds from one difference stack."""
    diff = _circle_diff(img)
    return _score_from_diff(diff, threshold), _score_from_diff(diff, min_threshold)


def _topk_low_index(x: torch.Tensor, k: int):
    """Top-k along the last dim, ties toward the lower index (`lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score: torch.Tensor, cell: int, per_cell: int, n_out: int,
              score_lo: torch.Tensor | None = None):
    """Spatially balanced keypoint selection: per-cell top-k, then global
    top-n. Returns (xy (n_out, 2) float32 [x, y], scores (n_out,))."""
    H, W = score.shape
    Hc, Wc = H // cell, W // cell

    def cells_of(sc):
        c = sc[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell)
        return c.permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)

    s = cells_of(score)
    if score_lo is not None:
        s_lo = cells_of(score_lo)
        cell_has_hi = torch.amax(s, dim=1, keepdim=True) > 0
        s = torch.where(cell_has_hi, s, s_lo)
    top_s, top_i = _topk_low_index(s, per_cell)

    cid = torch.arange(Hc * Wc, device=score.device)
    cy, cx = cid // Wc, cid % Wc
    py = top_i // cell + (cy * cell)[:, None]
    px = top_i % cell + (cx * cell)[:, None]

    flat_s = top_s.reshape(-1)
    k = min(n_out, flat_s.shape[0])
    best_s, best_i = _topk_low_index(flat_s, k)
    xy = torch.stack([px.reshape(-1)[best_i], py.reshape(-1)[best_i]], dim=-1).to(torch.float32)
    if k < n_out:
        xy = torch.nn.functional.pad(xy, (0, 0, 0, n_out - k))
        best_s = torch.nn.functional.pad(best_s, (0, n_out - k))
    return xy, best_s


# ----------------------------------------------------------------------------
# Orientation + BRIEF
# ----------------------------------------------------------------------------


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, size: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """7x7 sigma-2 separable blur with zero padding (SAME), as shifted sums."""
    k2 = _gaussian_kernel(size, sigma)
    ky = k2[:, size // 2]
    kx = k2[size // 2, :] / max(ky[size // 2], 1e-20)
    half = size // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img, (half, half))
    out = float(kx[0]) * x[:, 0:W]
    for j in range(1, size):
        out = out + float(kx[j]) * x[:, j:j + W]
    y = torch.nn.functional.pad(out, (0, 0, half, half))
    res = float(ky[0]) * y[0:H]
    for j in range(1, size):
        res = res + float(ky[j]) * y[j:j + H]
    return res


@functools.lru_cache(maxsize=None)
def _brief_pattern(seed: int = 0, n_bits: int = 256, patch: int = 31) -> np.ndarray:
    """Seeded Gaussian BRIEF pattern: (n_bits, 4) = (y1, x1, y2, x2) — the
    same numpy table as the JAX package."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    pts = rng.randn(n_bits, 4) * sigma
    lim = patch // 2 - 1
    return np.clip(np.round(pts), -lim, lim).astype(np.float32)


_SCAN_BLOCK = 16


def _cumsum_rows(a: torch.Tensor) -> torch.Tensor:
    """Row prefix sums in the summation order of XLA's CPU cumsum: a
    sequential scan inside blocks of 16, the block totals scanned the same
    way recursively, and each block offset by the exclusive prefix of the
    totals. Written out so it gives the same bits on every device
    (`torch.cumsum` is sequential on the CPU and a parallel scan on CUDA)."""
    R, n = a.shape
    if n <= _SCAN_BLOCK:
        cols = [a[:, 0]]
        for j in range(1, n):
            cols.append(cols[-1] + a[:, j])
        return torch.stack(cols, dim=1)
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(a, (0, nb * _SCAN_BLOCK - n)).reshape(R, nb, _SCAN_BLOCK)
    cols = [blocks[:, :, 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blocks[:, :, j])
    inc = _cumsum_rows(cols[-1])
    exc = torch.nn.functional.pad(inc[:, :-1], (1, 0))
    out = torch.stack(cols, dim=2) + exc[:, :, None]
    return out.reshape(R, nb * _SCAN_BLOCK)[:, :n]


def _orientation_maps(img: torch.Tensor, patch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense m10 / m01 moment maps over a circular patch via row prefix sums
    (same span decomposition and summation order as the JAX package)."""
    half = patch // 2
    H, W = img.shape
    f = img.to(torch.float32)
    x = torch.arange(W, dtype=torch.float32, device=img.device)

    def prefix(a):
        p = torch.cat([torch.zeros((H, 1), dtype=torch.float32, device=a.device),
                       _cumsum_rows(a)], dim=1)
        return torch.cat([p[:, :1].expand(H, half + 1), p,
                          p[:, -1:].expand(H, half + 1)], dim=1)

    S = prefix(f)
    Uw = prefix(f * x[None, :])
    base = half + 1

    def spans(Pm, w):
        return Pm[:, base + w + 1:base + w + 1 + W] - Pm[:, base - w:base - w + W]

    widths = [int(math.floor(math.sqrt(half * half - dy * dy))) for dy in range(-half, half + 1)]
    padded = {}
    for w in set(widths):
        rs = spans(S, w)
        rxs = spans(Uw, w) - x[None, :] * rs
        padded[w] = (torch.nn.functional.pad(rs, (0, 0, half, half)),
                     torch.nn.functional.pad(rxs, (0, 0, half, half)))

    m10 = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    m01 = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for i, dy in enumerate(range(-half, half + 1)):
        prs, prxs = padded[widths[i]]
        m10 = m10 + prxs[half + dy:half + dy + H]
        if dy:
            m01 = m01 + float(dy) * prs[half + dy:half + dy + H]
    return m10, m01


# Bit weights 2^b of one descriptor word, as the int32 values of those bits.
_BIT_WEIGHTS = np.array([1 << b for b in range(32)], dtype=np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _brief_tables(device: torch.device):
    """The BRIEF pattern and the bit weights, uploaded once per device."""
    return (torch.as_tensor(_brief_pattern(), device=device),
            torch.as_tensor(_BIT_WEIGHTS.astype(np.int64), device=device))


def compute_descriptors(img_blur: torch.Tensor, xy: torch.Tensor,
                        angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF: sample rotated point pairs, pack 256 bits to (N, 8)
    int32. img_blur: (H, W) blurred level; xy: (N, 2) level coords."""
    H, W = img_blur.shape
    pat, weights = _brief_tables(img_blur.device)
    ca, sa = torch.cos(angle), torch.sin(angle)

    def rot(y, x):
        ry = y[None, :] * ca[:, None] + x[None, :] * sa[:, None]
        rx = -y[None, :] * sa[:, None] + x[None, :] * ca[:, None]
        return ry, rx

    y1, x1 = rot(pat[:, 0], pat[:, 1])
    y2, x2 = rot(pat[:, 2], pat[:, 3])

    def sample(yy, xx):
        # torch.round rounds half to even, as jnp.round does.
        iy = torch.clamp(torch.round(xy[:, 1:2] + yy), 0, H - 1).to(torch.int64)
        ix = torch.clamp(torch.round(xy[:, 0:1] + xx), 0, W - 1).to(torch.int64)
        return img_blur[iy, ix]

    bits = (sample(y1, x1) < sample(y2, x2)).to(torch.int64).reshape(-1, 8, 32)
    # Distinct powers of two (bit 31 as -2^31) sum to the packed word exactly.
    return torch.sum(bits * weights, dim=-1).to(torch.int32)


# ----------------------------------------------------------------------------
# Pyramid + full extractor
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of `jax.image.resize(method="linear")` along
    one axis: triangle kernel widened by the downscale factor (antialias),
    columns normalised, samples outside the input zeroed."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.zeros((1, out_size), f32)
    for i in range(in_size):  # sequential column sums
        total[0] += weights[i]
    weights = np.where(
        np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_resize_weights(in_size, out_size), device=device)


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Antialiased bilinear resize matching `jax.image.resize(..., "linear")`."""
    H, W = img.shape
    wy = _resize_weights_on(H, h, img.device)
    wx = _resize_weights_on(W, w, img.device)
    return wy.T @ (img @ wx)


def _extract_level(img_l: torch.Tensor, n_feats: int, cfg: ORBConfig):
    """Single-level extraction: scores -> grid top-k -> angle -> BRIEF."""
    if cfg.fast_min_threshold and cfg.fast_min_threshold < cfg.fast_threshold:
        score, score_lo = fast_scores_dual(
            img_l, float(cfg.fast_threshold), float(cfg.fast_min_threshold)
        )
    else:
        score, score_lo = fast_scores(img_l, float(cfg.fast_threshold)), None
    xy, s = grid_topk(score, cfg.cell_size, cfg.per_cell, n_feats, score_lo)
    valid = s > 0
    m10, m01 = _orientation_maps(img_l, cfg.patch_size)
    iy = xy[:, 1].to(torch.int64)
    ix = xy[:, 0].to(torch.int64)
    angle = torch.atan2(m01[iy, ix], m10[iy, ix])
    desc = compute_descriptors(gaussian_blur(img_l), xy, angle)
    return xy, s, angle, valid, desc


def extract(img: torch.Tensor, cfg: ORBConfig = ORBConfig()) -> Keypoints:
    """Extract ORB keypoints + descriptors from a (H, W) float32 image on
    its device; levels are concatenated into `max_features` slots with
    coordinates mapped back to level 0."""
    counts = features_per_level(cfg)
    scales = scale_factors(cfg)
    H, W = img.shape
    img = img.to(torch.float32)
    all_xy, all_s, all_a, all_v, all_d, all_o = [], [], [], [], [], []
    img_l = img
    for lvl in range(cfg.num_levels):
        if lvl > 0:
            h = int(round(H / scales[lvl]))
            w = int(round(W / scales[lvl]))
            img_l = resize_linear(img, h, w)
        xy, s, a, v, d = _extract_level(img_l, counts[lvl], cfg)
        all_xy.append(xy * float(scales[lvl]))
        all_s.append(s)
        all_a.append(a)
        all_v.append(v)
        all_d.append(d)
        all_o.append(torch.full((counts[lvl],), lvl, dtype=torch.int32, device=img.device))
    return Keypoints(
        xy=torch.cat(all_xy),
        score=torch.cat(all_s),
        angle=torch.cat(all_a),
        octave=torch.cat(all_o),
        valid=torch.cat(all_v),
        desc=torch.cat(all_d),
    )
