"""Voxel-hash nearest-neighbour search + voxel downsampling.

Counterpart of `sqrtlm_slam_tpu/lidar/voxel_map.py`: points sorted by a
packed voxel key (10 bits per axis); a query gathers bounded candidate runs
from its 27 neighbouring cells and reduces them. Recall is exact for any
query whose true neighbours lie within one cell, so pick cell >= search
radius.

Ties are decided as the JAX package decides them, and the same way on every
device: the sort is stable (the first point in input order represents its
voxel), and among equally distant candidates the lowest candidate slot wins
(`torch.min` returns the first minimum; for k > 1 a stable sort).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

_COORD_BITS = 10
_COORD_MASK = (1 << _COORD_BITS) - 1
_COORD_OFF = 1 << (_COORD_BITS - 1)
_INVALID_KEY = 2**31 - 1

_NEIGHBOR_OFFSETS = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


@functools.lru_cache(maxsize=None)
def _neighbor_offsets(device: torch.device) -> torch.Tensor:
    """(27, 3) int32 cell offsets, kept on `device` once per process (no
    host-to-device copy per query: a captured graph takes none)."""
    return torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=device)


def _voxel_key(ijk: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3) int32 voxel coords into one int32 key (10 bits/axis)."""
    q = torch.clamp(ijk + _COORD_OFF, 0, _COORD_MASK)
    return (q[..., 0] << (2 * _COORD_BITS)) | (q[..., 1] << _COORD_BITS) | q[..., 2]


def _keys(points: torch.Tensor, valid: torch.Tensor, cell: float) -> torch.Tensor:
    """Voxel key per point; invalid (and non-finite) points get the sentinel."""
    ok = valid & torch.isfinite(points).all(dim=-1)
    ijk = torch.floor(torch.where(ok[:, None], points, torch.zeros_like(points)) / cell)
    return torch.where(ok, _voxel_key(ijk.to(torch.int32)),
                       torch.full_like(ok, _INVALID_KEY, dtype=torch.int32))


class VoxelMap(NamedTuple):
    points: torch.Tensor  # (M, 3) sorted by voxel key
    keys: torch.Tensor  # (M,) int32 sorted
    payload: torch.Tensor  # (M, D) extra per-point data (e.g. normals), sorted
    cell: float  # cell size
    valid: torch.Tensor  # (M,) bool, sorted (invalid sink to the end)


def build(points: torch.Tensor, valid: torch.Tensor, cell: float,
          payload: Optional[torch.Tensor] = None) -> VoxelMap:
    """Sort points by voxel key (stable). Invalid points get the sentinel key."""
    if payload is None:
        payload = torch.zeros((points.shape[0], 0), dtype=points.dtype, device=points.device)
    skeys, order = torch.sort(_keys(points, valid, cell), stable=True)
    return VoxelMap(points=points[order], keys=skeys, payload=payload[order],
                    cell=float(cell), valid=valid[order])


def knn(vm: VoxelMap, queries: torch.Tensor, k: int = 1, max_per_cell: int = 8,
        max_dist: float = math.inf):
    """k nearest neighbours for each query among the 27 adjacent voxels.

    queries: (Q, 3). Returns (idx (Q, k) into vm.points, dist2 (Q, k),
    ok (Q, k) bool). Neighbours further than `max_dist` (or absent) have
    ok=False. Candidate runs are capped at `max_per_cell` per voxel."""
    M = vm.points.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    finite = torch.isfinite(queries).all(dim=-1)
    q = torch.where(finite[:, None], queries, torch.zeros_like(queries))
    qijk = torch.floor(q / vm.cell).to(torch.int32)
    offsets = _neighbor_offsets(dev)
    nkeys = _voxel_key(qijk[:, None, :] + offsets[None, :, :])  # (Q, 27)

    lo = torch.searchsorted(vm.keys, nkeys.contiguous())  # left side, (Q, 27)
    cand = lo[..., None] + torch.arange(max_per_cell, device=dev)  # (Q, 27, B)
    cand_clipped = torch.clamp(cand, 0, M - 1)
    in_run = ((cand < M) & (vm.keys[cand_clipped] == nkeys[..., None])
              & vm.valid[cand_clipped] & finite[:, None, None])

    d = vm.points[cand_clipped] - queries[:, None, None, :]
    dist2 = torch.sum(d * d, dim=-1)
    dist2 = torch.where(in_run, dist2, torch.full_like(dist2, math.inf))

    flat_d = dist2.reshape(Q, -1)
    flat_i = cand_clipped.reshape(Q, -1)
    if k == 1:
        best_d, pos = torch.min(flat_d, dim=1, keepdim=True)  # first minimum
    else:
        best_d, pos = torch.sort(flat_d, dim=1, stable=True)
        best_d, pos = best_d[:, :k], pos[:, :k]
    best_i = torch.gather(flat_i, 1, pos)
    ok = torch.isfinite(best_d) & (best_d <= max_dist * max_dist)
    return best_i, best_d, ok


def downsample_rows(rows: torch.Tensor, valid: torch.Tensor, cell: float, capacity: int):
    """Grid downsample of (N, D) rows whose first three columns are xyz: one
    representative per occupied voxel (the first in key order, input order
    within a voxel), compacted to the front, up to `capacity` outputs.
    Returns (rows (capacity, D), valid (capacity,) bool).

    Every output slot below `capacity` has exactly one writer; the rest of
    the points (and representatives past the capacity) all land on one spill
    row, which is dropped, so the result does not depend on write order."""
    skeys, order = torch.sort(_keys(rows[:, :3], valid, cell), stable=True)
    srows = rows[order]
    first = torch.ones_like(valid)
    first[1:] = skeys[1:] != skeys[:-1]
    first = first & (skeys != _INVALID_KEY)
    rank = torch.cumsum(first, dim=0) - 1
    slot = torch.clamp(torch.where(first, rank, torch.full_like(rank, capacity)), 0, capacity)
    out = torch.zeros((capacity + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out[slot] = srows
    out_valid = torch.zeros(capacity + 1, dtype=torch.bool, device=rows.device)
    out_valid[slot] = first
    return out[:capacity], out_valid[:capacity]


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor, cell: float, capacity: int):
    """Grid downsample of (N, 3) points; see `downsample_rows`.
    Returns (points (capacity, 3), valid (capacity,) bool)."""
    return downsample_rows(points, valid, cell, capacity)
