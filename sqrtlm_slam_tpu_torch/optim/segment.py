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

`key_groups` is the same grouping in compressed form, built without a host
read: each key's rows in their order in the data, one run per key. Kernels
that walk one key's members read it (K2's camera pass).

`group_sum` sums those runs in plain PyTorch, each key's rows one after
another in their order, with no host read at all: a grouping built inside
a captured graph serves. The sqrt-Schur tail sums its camera-pair blocks
and its camera rows this way (`schur_bucketed._pieces_tail`).

A padded plan (`segment_plan(..., pad=True)`) lists every key and rounds
its width up to a power of two, so that its shapes depend on the key count
and the width's bucket alone: one captured graph then serves the local BA
windows of successive keyframes. The pad entries add zero rows; a padded
sum is the unpadded one but for the order of the additions (on every
device: the eager body and its graph read the same table). The BA engines'
plans are all padded (`schur.edge_plans`, `schur_bucketed.pose_plan`),
local and global alike. The pose graphs' block plans (`loop/essential_graph`,
`lidar/backend`) are not: their keys are (row, col) block pairs of K
vertices, K * K keys of which only the edges' are present, and listing
every one would gather K * K rows (360,000 at 600 keyframes) where the
present ones are a few thousand.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import to_host


class KeyGroups(NamedTuple):
    offsets: torch.Tensor  # (num_keys + 1,) int32: key q's rows are
    members: torch.Tensor  # (n,) int32 rows, members[offsets[q]:offsets[q + 1]]
    # (rows of no key follow members[offsets[-1]:])


class SegmentPlan(NamedTuple):
    keys: torch.Tensor  # (S,) int64 distinct keys that have members, ascending
    idx: torch.Tensor  # (S, D) int64 rows of the data (0 where `pad`)
    pad: torch.Tensor  # (S, D) bool entries past a key's members
    n: int  # number of data rows
    num_keys: int  # size of the output's key axis
    groups: KeyGroups  # the same grouping, compressed


def _sort_keys(keys: torch.Tensor, num_keys: int, keep: Optional[torch.Tensor]):
    """(keys with rows of no key set to num_keys, their stable sort order)."""
    keys = keys.reshape(-1).long()
    ok = (keys >= 0) & (keys < num_keys)
    if keep is not None:
        ok = ok & keep.reshape(-1)
    k = torch.where(ok, keys, torch.full_like(keys, num_keys))
    return k, torch.argsort(k, stable=True)


def key_groups(keys: torch.Tensor, num_keys: int,
               keep: Optional[torch.Tensor] = None) -> KeyGroups:
    """Group the rows of a flat (n,) key vector as `segment_plan` does, in
    compressed form and without a host read."""
    k, order = _sort_keys(keys, num_keys, keep)
    bounds = torch.arange(num_keys + 1, dtype=k.dtype, device=k.device)
    offsets = torch.searchsorted(k[order], bounds)
    return KeyGroups(offsets=offsets.to(torch.int32), members=order.to(torch.int32))


def bucket(width: int) -> int:
    """`width` rounded up to a power of two (at least 1)."""
    return 1 << max(width - 1, 0).bit_length()


def segment_plan(keys: torch.Tensor, num_keys: int,
                 keep: Optional[torch.Tensor] = None, pad: bool = False) -> SegmentPlan:
    """Group the rows of a flat (n,) key vector; rows with keep False (or a
    key outside [0, num_keys)) belong to no key. One host read (the largest
    group size). With `pad`, every key is listed and the width is
    `bucket`ed (see the module docstring)."""
    k, order = _sort_keys(keys, num_keys, keep)
    n = k.shape[0]
    counts = torch.bincount(k, minlength=num_keys + 1)[:num_keys]
    width = max(int(to_host(counts.max())) if num_keys else 0, 1)
    if pad:
        width = bucket(width)
    starts = torch.cumsum(counts, 0) - counts
    k_sorted = k[order]
    member = k_sorted < num_keys
    k_m, rows = k_sorted[member], order[member]
    rank = torch.arange(k_m.shape[0], device=k.device) - starts[k_m]
    table = torch.zeros((num_keys, width), dtype=torch.long, device=k.device)
    table[k_m, rank] = rows
    empty = torch.arange(width, device=k.device) >= counts[:, None]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    groups = KeyGroups(offsets=offsets, members=order.to(torch.int32))
    if pad:
        return SegmentPlan(keys=torch.arange(num_keys, device=k.device), idx=table, pad=empty,
                           n=n, num_keys=num_keys, groups=groups)
    present = torch.nonzero(counts > 0).reshape(-1)
    return SegmentPlan(keys=present, idx=table[present], pad=empty[present], n=n,
                       num_keys=num_keys, groups=groups)


def group_sum(groups: KeyGroups, rows: Callable[[torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """Per-key sums (num_keys, D) of `groups` (`key_groups`); keys without
    members get zeros. `rows(i)` returns the data rows `i` as (len(i), D)
    (a gather, so that the rows can be made in the groups' order from any
    layout). Each key's rows are added one after another in their order
    (`torch.segment_reduce`, with its checks, which read the device, off):
    a fixed order with no host read."""
    return torch.segment_reduce(rows(groups.members.long()), "sum",
                                offsets=groups.offsets.long(), unsafe=True)


def segment_sum(plan: SegmentPlan, data: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows -> (num_keys, ...) per-key sums in a fixed order; keys
    without members get zeros. The gathered rows are the only copy a call
    makes (its pad entries zeroed in place)."""
    if data.shape[0] == 0:
        return data.new_zeros((plan.num_keys,) + data.shape[1:])
    rows = data[plan.idx]
    rows.masked_fill_(plan.pad.reshape(plan.pad.shape + (1,) * (data.dim() - 1)), 0)
    sums = torch.sum(rows, dim=1)
    if plan.keys.shape[0] == plan.num_keys:  # every key listed, in order (a padded plan)
        return sums
    out = torch.zeros((plan.num_keys,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    out[plan.keys] = sums
    return out
