"""LiDAR feature extraction on the range image, as tensor operations.

Counterpart of `sqrtlm_slam_tpu/lidar/features.py`: virtual-ring assignment
by elevation, a (rings x columns) range image keeping the nearest point per
cell, segmentation by iterated min-label propagation, LOAM curvature along
each ring, corner / flat picks per (ring, subregion), and plane normals from
a 3-ring x 7-column neighbourhood fit. Outputs are fixed-capacity feature
sets with validity masks.

`extract_features` takes clouds of any length as they are; rows holding
NaN are inert: `ring_and_azimuth` keeps only finite ranges. The captured
entry `extract_features_jit` (`utils.cache`) is paired with `pad_cloud`,
which pads a scan with NaN rows to a size bucket, so that one graph serves
scans of varying length; the padding changes no feature.

Where the JAX package leaves a tie to the backend, the port fixes the rule
so that every device gives the same result:
  * the point that represents a range-image cell is, among the cell's
    points within 1e-6 of its minimal range, the one latest in the cloud;
  * per-subregion picks are a stable descending sort, so among equal values
    the lowest column wins (what `jax.lax.top_k` does).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..optim.schur_bucketed import chol3x3, trinv_lower3x3
from ..utils import cache


class LidarConfig(NamedTuple):
    num_rings: int = 64
    horizon_res_deg: float = 0.2  # -> 1800 columns
    elev_min_deg: float = -24.8  # HDL-64E vertical field of view
    elev_max_deg: float = 2.0
    ground_z: float = -1.2  # ground flag threshold (z < ground_z)
    min_range: float = 2.5
    max_range: float = 80.0
    num_subregions: int = 8  # curvature subregions per ring
    curv_window: int = 5  # +/- neighbours for curvature
    corner_thresh: float = 0.1  # curvature above -> corner candidate
    flat_thresh: float = 0.1  # curvature below -> flat candidate
    sharp_per_sub: int = 3
    less_sharp_per_sub: int = 30
    flat_per_sub: int = 4
    seg_angle_thresh: float = 1.0  # rad, segmentation gate
    seg_prop_iters: int = 24  # label-propagation sweeps
    seg_min_size: int = 30
    seg_min_rings: int = 3
    plane_res_thresh: float = 0.1  # |plane residual| validity

    @property
    def num_cols(self) -> int:
        return int(round(360.0 / self.horizon_res_deg))


def pad_cloud(points, bucket: int = 16384):
    """Pad an (N, D) cloud with NaN rows to the next multiple of `bucket`
    rows (at least one bucket), so that scans of varying length share one
    captured graph per size bucket. NaN rows are inert in every consumer:
    `ring_and_azimuth` keeps only finite ranges and
    `project_cloud_to_depth_image` rejects them (NaN fails z > 0.1).
    A numpy array (or anything numpy takes) comes back as a float32 numpy
    array, as the JAX package pads it; a tensor is padded on its device."""
    n = points.shape[0]
    cap = max(bucket, -(-n // bucket) * bucket)
    if isinstance(points, torch.Tensor):
        pts = points.to(torch.float32)
        nan = torch.full((cap - n, pts.shape[1]), math.nan, dtype=torch.float32,
                         device=pts.device)
        return torch.cat([pts, nan]) if cap != n else pts
    pts = np.asarray(points, np.float32)
    if cap != n:
        pts = np.concatenate([pts, np.full((cap - n, pts.shape[1]), np.nan, np.float32)])
    return pts


class RangeImage(NamedTuple):
    depth: torch.Tensor  # (R, C) range, 0 where empty
    xyz: torch.Tensor  # (R, C, 3) point coords (sensor frame)
    valid: torch.Tensor  # (R, C) bool
    ground: torch.Tensor  # (R, C) bool


class LidarFeatures(NamedTuple):
    """Fixed-capacity feature sets (sensor-frame points + masks)."""

    sharp: torch.Tensor  # (Ns, 3) corner points
    sharp_valid: torch.Tensor
    less_sharp: torch.Tensor  # (Nls, 3)
    less_sharp_valid: torch.Tensor
    flat: torch.Tensor  # (Nf, 3)
    flat_normal: torch.Tensor  # (Nf, 3) local plane normals
    flat_d: torch.Tensor  # (Nf,) plane offsets (n.p + d = 0 locally)
    flat_valid: torch.Tensor
    less_flat: torch.Tensor  # (Nlf, 3) downsampled smooth points
    less_flat_valid: torch.Tensor


def ring_and_azimuth(points: torch.Tensor, cfg: LidarConfig):
    """Virtual ring + column assignment by elevation / azimuth.

    points: (N, 3) in the LiDAR frame (x forward, y left, z up).
    Returns (ring (N,) int32, col (N,) int32, range (N,), keep (N,)); ring
    and col are 0 where the range is not finite."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = torch.sqrt(x * x + y * y + z * z)
    finite = torch.isfinite(rng)
    horiz = torch.sqrt(x * x + y * y)
    elev = torch.rad2deg(torch.atan2(z, torch.clamp(horiz, min=1e-6)))
    ring_f = ((elev - cfg.elev_min_deg) / (cfg.elev_max_deg - cfg.elev_min_deg)
              * (cfg.num_rings - 1))
    zero = torch.zeros_like(rng)
    ring = torch.round(torch.where(finite, ring_f, zero)).to(torch.int32)
    az = torch.rad2deg(torch.atan2(y, x))  # (-180, 180]
    col = torch.floor((torch.where(finite, az, zero) + 180.0) / cfg.horizon_res_deg)
    col = torch.clamp(col.to(torch.int32), 0, cfg.num_cols - 1)
    keep = ((ring >= 0) & (ring < cfg.num_rings) & (rng > cfg.min_range)
            & (rng < cfg.max_range) & finite)
    return ring, col, rng, keep


def build_range_image(points: torch.Tensor, cfg: LidarConfig) -> RangeImage:
    """Scatter points into the (R, C) grid keeping the nearest per cell."""
    R, C = cfg.num_rings, cfg.num_cols
    dev = points.device
    ring, col, rng, keep = ring_and_azimuth(points, cfg)
    spill = torch.full((points.shape[0],), R * C, dtype=torch.int64, device=dev)
    flat = torch.where(keep, ring.long() * C + col.long(), spill)

    big = 1e9
    depth = torch.full((R * C + 1,), big, dtype=points.dtype, device=dev)
    depth = depth.scatter_reduce(0, flat, torch.where(keep, rng, torch.full_like(rng, big)),
                                 reduce="amin", include_self=True)[: R * C]
    valid = depth < big
    depth = torch.where(valid, depth, torch.zeros_like(depth))

    # The cell's point: the latest of those within 1e-6 of the minimal range.
    is_winner = keep & (rng <= depth[torch.clamp(flat, 0, R * C - 1)] + 1e-6)
    winner = torch.full((R * C + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, torch.where(is_winner, flat, spill),
                                   torch.arange(points.shape[0], device=dev),
                                   reduce="amax", include_self=True)[: R * C]
    xyz = torch.where((winner >= 0)[:, None], points[torch.clamp(winner, min=0)][:, :3],
                      torch.zeros((), dtype=points.dtype, device=dev))

    ground = valid & (xyz[:, 2] < cfg.ground_z)
    return RangeImage(depth=depth.reshape(R, C), xyz=xyz.reshape(R, C, 3),
                      valid=valid.reshape(R, C), ground=ground.reshape(R, C))


def segment_labels(img: RangeImage, cfg: LidarConfig) -> torch.Tensor:
    """Range-image segmentation via iterated min-label propagation.

    Neighbours (4-connectivity on the ring/column grid, columns wrap) are
    connected when the LeGO-LOAM angle criterion exceeds `seg_angle_thresh`:
    beta = atan2(d2 sin(alpha), d1 - d2 cos(alpha)) with d1 >= d2 and alpha
    the angular step. Returns (R, C) int32 labels (-1 for invalid cells)."""
    R, C = img.depth.shape
    alpha_h = math.radians(cfg.horizon_res_deg)
    alpha_v = math.radians((cfg.elev_max_deg - cfg.elev_min_deg) / (cfg.num_rings - 1))

    def connected(shift, axis, alpha):
        d = img.depth
        dn = torch.roll(d, shift, dims=axis)
        vn = torch.roll(img.valid, shift, dims=axis)
        d1 = torch.maximum(d, dn)
        d2 = torch.minimum(d, dn)
        beta = torch.atan2(d2 * math.sin(alpha), d1 - d2 * math.cos(alpha))
        ok = img.valid & vn & (beta > cfg.seg_angle_thresh)
        if axis == 0:  # the ring axis does not wrap
            ok = ok.clone()
            if shift > 0:
                ok[:shift] = False
            else:
                ok[shift:] = False
        return ok

    conn_up = connected(1, 0, alpha_v)
    conn_dn = connected(-1, 0, alpha_v)
    conn_lf = connected(1, 1, alpha_h)
    conn_rt = connected(-1, 1, alpha_h)

    lab = torch.arange(R * C, dtype=torch.int32, device=img.depth.device).reshape(R, C)
    lab = torch.where(img.valid, lab, torch.full_like(lab, R * C))
    for _ in range(cfg.seg_prop_iters):
        up = torch.where(conn_up, torch.roll(lab, 1, 0), lab)
        dn = torch.where(conn_dn, torch.roll(lab, -1, 0), lab)
        lf = torch.where(conn_lf, torch.roll(lab, 1, 1), lab)
        rt = torch.where(conn_rt, torch.roll(lab, -1, 1), lab)
        lab = torch.minimum(torch.minimum(torch.minimum(lab, up), torch.minimum(dn, lf)), rt)
    return torch.where(img.valid, lab, torch.full_like(lab, -1))


def segment_valid_mask(labels: torch.Tensor, cfg: LidarConfig) -> torch.Tensor:
    """Segment validity: size >= seg_min_size or spans >= seg_min_rings rings."""
    R, C = labels.shape
    dev = labels.device
    flat = torch.where(labels >= 0, labels, torch.full_like(labels, R * C)).reshape(-1).long()
    sizes = torch.zeros(R * C + 1, dtype=torch.int64, device=dev)
    sizes = sizes.scatter_add(0, flat, torch.ones_like(flat))
    ring_idx = torch.arange(R, device=dev)[:, None].expand(R, C).reshape(-1)
    rmin = torch.full((R * C + 1,), R, dtype=torch.int64, device=dev)
    rmin = rmin.scatter_reduce(0, flat, ring_idx, reduce="amin", include_self=True)
    rmax = torch.zeros(R * C + 1, dtype=torch.int64, device=dev)
    rmax = rmax.scatter_reduce(0, flat, ring_idx, reduce="amax", include_self=True)
    ok = (sizes >= cfg.seg_min_size) | (rmax - rmin + 1 >= cfg.seg_min_rings)
    return (labels >= 0) & ok[torch.clamp(labels, 0, R * C).long()]


def curvature(img: RangeImage, cfg: LidarConfig) -> torch.Tensor:
    """LOAM curvature per cell over the +/- `curv_window` same-ring
    neighbours; -1 where the cell is invalid or its window incomplete."""
    d = img.depth
    W = cfg.curv_window
    acc = torch.zeros_like(d)
    cnt = torch.zeros_like(d)
    for j in range(-W, W + 1):
        if j == 0:
            continue
        dj = torch.roll(d, j, dims=1)
        vj = torch.roll(img.valid, j, dims=1)
        acc = acc + torch.where(vj, dj - d, torch.zeros_like(d))
        cnt = cnt + vj.to(d.dtype)
    c = (acc * acc) / torch.clamp(d * d, min=1e-6)
    return torch.where(img.valid & (cnt >= 2 * W), c, torch.full_like(c, -1.0))


def _neighborhood_plane_fit(img: RangeImage, cfg: LidarConfig):
    """Batched plane fit over a 3-ring x 7-column window around every cell.

    Solves min ||A n - 1|| per cell (the LOAM norm trick) through the normal
    equations, which are SPD after the 1e-6 ridge: a closed-form 3x3 Cholesky
    per cell, all elementwise (no batched LU, no library GEMM). The normal
    equations of a thin window metres from the sensor have a condition
    number of 1e5-1e6, so they are summed and solved in float64: in float32
    the normals would move by ~1e-4 with the summation order, which differs
    between devices. Returns (normal (R, C, 3), offset d = -1/|n| (R, C),
    ok (R, C)); ok asks for >= 5 window points, all within
    `plane_res_thresh` of the plane."""
    offs = [(dr, dc) for dr in (-1, 0, 1) for dc in (-3, -2, -1, 0, 1, 2, 3)]
    pts = torch.stack([torch.roll(img.xyz, (dr, dc), dims=(0, 1)) for dr, dc in offs], dim=2)
    val = torch.stack([torch.roll(img.valid, (dr, dc), dims=(0, 1)) for dr, dc in offs], dim=2)
    w = val.to(pts.dtype)  # (R, C, K)

    p64 = pts.double()
    wp = p64 * w[..., None]
    rows = []
    for i in range(3):
        rows.append(torch.stack([torch.sum(wp[..., i] * p64[..., j], dim=-1)
                                 + (1e-6 if i == j else 0.0) for j in range(3)], dim=-1))
    AtA = torch.stack(rows, dim=-2)  # (R, C, 3, 3)
    At1 = torch.sum(wp, dim=2)  # (R, C, 3)
    Li = trinv_lower3x3(chol3x3(AtA))  # AtA^-1 = Li^T Li
    y = torch.sum(Li * At1[..., None, :], dim=-1)
    n = torch.sum(Li * y[..., :, None], dim=-2).to(pts.dtype)
    norm = torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    normal = n / norm
    d_off = -1.0 / norm[..., 0]

    res = torch.abs(torch.sum(pts * normal[..., None, :], dim=-1) + d_off[..., None])
    good = torch.all(~val | (res < cfg.plane_res_thresh), dim=-1)
    enough = torch.sum(w, dim=-1) >= 5
    return normal, d_off, good & enough & img.valid


def _subregion_topk(values, mask, cfg: LidarConfig, k, largest=True):
    """Per (ring, subregion) top-k by value -> flat cell indices + validity.
    Among equal values the lowest column comes first."""
    R, C = values.shape
    S = cfg.num_subregions
    w = C // S
    v = values[:, : S * w].reshape(R, S, w)
    m = mask[:, : S * w].reshape(R, S, w)
    vv = torch.where(m, v if largest else -v, torch.full_like(v, -math.inf))
    top_v, top_i = torch.sort(vv, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :k], top_i[..., :k]
    ok = torch.isfinite(top_v)
    dev = values.device
    cols = top_i + (torch.arange(S, device=dev) * w)[None, :, None]
    rows = torch.arange(R, device=dev)[:, None, None].expand_as(cols)
    return (rows * C + cols).reshape(-1), ok.reshape(-1)


def extract_features(points: torch.Tensor, cfg: LidarConfig = LidarConfig()) -> LidarFeatures:
    """Full feature extraction: range image -> segmentation -> curvature ->
    corner / flat picks -> plane normals. Fixed capacities from cfg caps."""
    img = build_range_image(points, cfg)
    labels = segment_labels(img, cfg)
    seg_ok = segment_valid_mask(labels, cfg)
    c = curvature(img, cfg)
    normal, d_off, plane_ok = _neighborhood_plane_fit(img, cfg)

    C = img.depth.shape[1]
    xyz_flat = img.xyz.reshape(-1, 3)
    corner_mask = img.valid & seg_ok & (~img.ground) & (c > cfg.corner_thresh)
    flat_mask = img.valid & (c >= 0) & (c < cfg.flat_thresh)

    # One sort serves both corner sets: the sharp picks are the first of the
    # less-sharp picks of each subregion.
    ls_idx, ls_ok = _subregion_topk(c, corner_mask, cfg, cfg.less_sharp_per_sub)
    n_sub = ls_idx.shape[0] // cfg.less_sharp_per_sub
    head = (slice(None), slice(0, cfg.sharp_per_sub))
    sharp_idx = ls_idx.reshape(n_sub, -1)[head].reshape(-1)
    sharp_ok = ls_ok.reshape(n_sub, -1)[head].reshape(-1)
    flat_idx, flat_ok = _subregion_topk(c, flat_mask & plane_ok, cfg, cfg.flat_per_sub,
                                        largest=False)
    # Less-flat: all smooth cells, column-downsampled by 4.
    lf_mask = flat_mask & (torch.arange(C, device=c.device)[None, :] % 4 == 0)
    lf_idx, lf_ok = _subregion_topk(-c, lf_mask, cfg, cfg.less_sharp_per_sub)

    return LidarFeatures(
        sharp=xyz_flat[sharp_idx], sharp_valid=sharp_ok,
        less_sharp=xyz_flat[ls_idx], less_sharp_valid=ls_ok,
        flat=xyz_flat[flat_idx], flat_normal=normal.reshape(-1, 3)[flat_idx],
        flat_d=d_off.reshape(-1)[flat_idx], flat_valid=flat_ok,
        less_flat=xyz_flat[lf_idx], less_flat_valid=lf_ok,
    )


def transform_features(feat: LidarFeatures, R: torch.Tensor, t: torch.Tensor) -> LidarFeatures:
    """Rigidly transform feature clouds (and plane normals / offsets) by
    p' = R p + t. The plane n.p + d = 0 maps to n' = R n, d' = d - n'.t.
    Elementwise sums, so no library GEMM is reached."""

    def rot(p):
        return torch.sum(p[:, None, :] * R[None, :, :], dim=-1)

    n_new = rot(feat.flat_normal)
    return feat._replace(
        sharp=rot(feat.sharp) + t, less_sharp=rot(feat.less_sharp) + t,
        flat=rot(feat.flat) + t, flat_normal=n_new,
        flat_d=feat.flat_d - torch.sum(n_new * t, dim=-1),
        less_flat=rot(feat.less_flat) + t,
    )


# The extraction as a captured CUDA graph per cloud shape and configuration
# (the JAX package's jit entry): pair it with `pad_cloud` so that scans of
# varying length replay one graph. The eager function on the CPU.
extract_features_jit = cache.graphed(extract_features, static_argnames=("cfg",))
