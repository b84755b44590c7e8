"""Descriptor matching: Hamming matrix (K1) + windowed/rotation-gated search.

Counterpart of `sqrtlm_slam_tpu/frontend/matching.py`: the whole matcher is
a masked (Q, T) Hamming matrix with window constraints, ratio test,
mutual-best or best-claim conflict resolution, and the rotation-consistency
histogram, all as tensor masks (no host sync). Descriptors are (N, 8) int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import hamming

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = 1 << 20


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 in [0, 256] (kernel K1 on CUDA)."""
    return hamming.hamming_matrix(desc_q, desc_t)


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (Q,) int32 target index (undefined where invalid)
    dist: torch.Tensor  # (Q,) int32 best Hamming distance
    valid: torch.Tensor  # (Q,) bool


def _rotation_consistency(
    angle_q: torch.Tensor, angle_t_matched: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the top-3 histogram
    bins (ORBmatcher `ComputeThreeMaxima` semantics, HISTO_LENGTH=30)."""
    two_pi = 2.0 * math.pi
    dtheta = torch.remainder(angle_q - angle_t_matched, two_pi)
    bins = torch.floor(dtheta / two_pi * HISTO_LENGTH).to(torch.int64)
    bins = torch.clamp(bins, 0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=valid.device)
    counts = counts.index_add(0, bins, valid.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    keep_count = torch.where(
        top3 >= torch.clamp(top3[0] / 10, min=1), top3, torch.full_like(top3, -1)
    )
    good_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=valid.device)
    for k in range(3):
        good_bin = good_bin | (counts == keep_count[k]) & (keep_count[k] > 0)
    return valid & good_bin[bins]


def match_descriptors(
    desc_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_q: torch.Tensor,
    valid_t: torch.Tensor,
    window_mask: Optional[torch.Tensor] = None,
    max_dist: int = TH_LOW,
    ratio: Optional[float] = None,
    mutual=True,
    angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    octave_t: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Best target per query with all ORB gates (see the JAX docstring):
    window mask, max distance, ratio test (octave-conditional when
    `octave_t` is given), mutual-best (True) or best-claim ("claim")
    conflict resolution, rotation consistency (`angles`)."""
    D = hamming_matrix(desc_q, desc_t)
    pair_ok = valid_q[:, None] & valid_t[None, :]
    if window_mask is not None:
        pair_ok = pair_ok & window_mask
    big = torch.full_like(D, _BIG)
    D_masked = torch.where(pair_ok, D, big)

    best, best_idx = torch.min(D_masked, dim=1)
    valid = (best <= max_dist) & valid_q

    if ratio is not None:
        cols = torch.arange(D.shape[1], device=D.device)
        D2 = torch.where(cols[None, :] == best_idx[:, None], big, D_masked)
        second, second_idx = torch.min(D2, dim=1)
        ratio_fail = best.to(torch.float32) >= ratio * second.to(torch.float32)
        if octave_t is not None:
            ratio_fail = ratio_fail & (octave_t[best_idx] == octave_t[second_idx])
        valid = valid & ~ratio_fail

    if mutual == "claim":
        # One query per target, best claim wins; ties break on query index.
        Q, T = D.shape
        d_key = torch.clamp(best, max=512).to(torch.int32)
        key = d_key * Q + torch.arange(Q, dtype=torch.int32, device=D.device)
        sentinel = 513 * Q
        tgt_best_key = torch.full((T,), sentinel, dtype=torch.int32, device=D.device)
        tgt_best_key = tgt_best_key.scatter_reduce(
            0, best_idx, torch.where(valid, key, torch.full_like(key, sentinel)),
            reduce="amin", include_self=True,
        )
        valid = valid & (key == tgt_best_key[best_idx])
    elif mutual:
        rev_best = torch.argmin(D_masked, dim=0)
        valid = valid & (rev_best[best_idx] == torch.arange(D.shape[0], device=D.device))

    if angles is not None:
        angle_q, angle_t = angles
        valid = _rotation_consistency(angle_q, angle_t[best_idx], valid)

    return MatchResult(idx=best_idx.to(torch.int32), dist=best, valid=valid)


def predict_octave(
    dist: torch.Tensor,
    max_dist: torch.Tensor,
    scale_factor: float = 1.2,
    num_levels: int = 8,
) -> torch.Tensor:
    """Predicted pyramid level for a landmark seen at distance `dist`
    (MapPoint::PredictScale); unset ranges (inf) predict level 0."""
    ratio = max_dist / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / math.log(scale_factor))
    lvl = torch.where(torch.isfinite(max_dist), lvl, torch.zeros_like(lvl))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


def projection_window_mask(
    uv_pred: torch.Tensor,
    uv_kp: torch.Tensor,
    radius,
    octave_pred: Optional[torch.Tensor] = None,
    octave_kp: Optional[torch.Tensor] = None,
    level_slack: int = 1,
    octave_gate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(Q, T) mask: keypoint t within `radius` (scalar or per-query (Q,)) of
    projection q, with optional pyramid-level compatibility."""
    d = uv_pred[:, None, :] - uv_kp[None, :, :]
    dist2 = torch.sum(d * d, dim=-1)
    if isinstance(radius, torch.Tensor):
        r = radius.to(uv_pred.dtype).expand(uv_pred.shape[0])
    else:  # a fill on the device, not a copy of a host scalar (a graph takes none)
        r = torch.full((uv_pred.shape[0],), float(radius), dtype=uv_pred.dtype,
                       device=uv_pred.device)
    mask = dist2 <= (r[:, None] * r[:, None])
    if octave_pred is not None and octave_kp is not None:
        dl = octave_kp[None, :] - octave_pred[:, None]
        level_ok = (dl >= -level_slack) & (dl <= level_slack)
        if octave_gate is not None:
            level_ok = level_ok | ~octave_gate[:, None]
        mask = mask & level_ok
    return mask
