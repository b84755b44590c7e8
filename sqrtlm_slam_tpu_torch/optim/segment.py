"""Keyed sums in a fixed order (no atomics), for camera- and vertex-keyed
reductions.

On CUDA, `index_add_`, `scatter_add_` and `index_put_(accumulate=True)` add
with atomics in no fixed order, so a sum over the observations of one camera
changes in its last bits from run to run, and an LM accept test at a gain
ratio near 0 can flip on that. The JAX package sums such terms with one-hot
matrix products; here the members of every key are gathered into a padded
(keys, max members) table, once per problem, and each key's members are
summed by `torch.sum` over that table. The sort that builds the table
orders each key's members by their position in the data, so the sum has a
fixed order on every device and every run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import to_host


class SegmentPlan(NamedTuple):
    keys: torch.Tensor  # (S,) int64 distinct keys that have members, ascending
    idx: torch.Tensor  # (S, D) int64 rows of the data; n (one past the end) pads
    n: int  # number of data rows
    num_keys: int  # size of the output's key axis


def segment_plan(keys: torch.Tensor, num_keys: int,
                 keep: Optional[torch.Tensor] = None) -> SegmentPlan:
    """Group the rows of a flat (n,) key vector; rows with keep False (or a
    key outside [0, num_keys)) belong to no key. One host read (the largest
    group size)."""
    keys = keys.reshape(-1).long()
    n = keys.shape[0]
    ok = (keys >= 0) & (keys < num_keys)
    if keep is not None:
        ok = ok & keep.reshape(-1)
    k = torch.where(ok, keys, torch.full_like(keys, num_keys))
    order = torch.argsort(k, stable=True)
    counts = torch.bincount(k, minlength=num_keys + 1)[:num_keys]
    width = max(int(to_host(counts.max())) if num_keys else 0, 1)
    starts = torch.cumsum(counts, 0) - counts
    k_sorted = k[order]
    member = k_sorted < num_keys
    k_m, rows = k_sorted[member], order[member]
    rank = torch.arange(k_m.shape[0], device=keys.device) - starts[k_m]
    table = torch.full((num_keys, width), n, dtype=torch.long, device=keys.device)
    table[k_m, rank] = rows
    present = torch.nonzero(counts > 0).reshape(-1)
    return SegmentPlan(keys=present, idx=table[present], n=n, num_keys=num_keys)


def segment_sum(plan: SegmentPlan, data: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows -> (num_keys, ...) per-key sums in a fixed order; keys
    without members get zeros."""
    pad = torch.zeros((1,) + data.shape[1:], dtype=data.dtype, device=data.device)
    sums = torch.sum(torch.cat([data, pad])[plan.idx], dim=1)
    out = torch.zeros((plan.num_keys,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    out[plan.keys] = sums
    return out
