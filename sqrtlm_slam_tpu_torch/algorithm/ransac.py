"""RANSAC sampling shared by the hypothesis banks (`algorithm/pnp.py`,
`loop/sim3_solver.py`, `pipeline/initializer.py`).

The minimal sets are a masked Gumbel top-k of (H, N) uniforms drawn from an
explicit `torch.Generator`. A captured CUDA graph (`utils.cache`) cannot
advance a generator, so a graphed caller draws the uniforms with
`torch.rand` before the graph, in the order the eager code draws them, and
`top_k_sets` runs inside it; `minimal_sets` is the two in turn. A graphed
call therefore consumes the generator stream that the eager call consumes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def top_k_sets(u: torch.Tensor, valid: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(H, k) distinct valid indices per hypothesis from uniforms u (H, N):
    masked Gumbel top-k (no device read; runs inside a graph)."""
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    g = torch.where(valid[None, :], g, torch.full_like(g, -math.inf))
    return torch.topk(g, k, dim=-1).indices


def minimal_sets(valid: torch.Tensor, num_hypotheses: int,
                 generator: Optional[torch.Generator] = None, k: int = 3) -> torch.Tensor:
    """(H, k) distinct valid indices per hypothesis: `top_k_sets` of
    uniforms drawn from `generator`."""
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator, device=valid.device)
    return top_k_sets(u, valid, k)


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor (the best hypothesis), by an index
    kernel: `x[i]` itself reads i back to the host."""
    return x[i.reshape(1)][0]
