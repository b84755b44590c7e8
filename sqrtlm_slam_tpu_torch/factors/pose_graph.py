"""Relative-pose factor of the Sim(3) essential graph.

Counterpart of `sim3_relative_residual(_jac)` in
`sqrtlm_slam_tpu/factors/pose_graph.py` (g2o `EdgeSim3`): for poses
``S_iw, S_jw`` (world -> frame) and the measurement ``S_ji``,

    r = log( S_ji_meas ∘ S_iw ∘ S_jw^{-1} )

The Jacobians w.r.t. the left-multiplicative 7-dim tangents of both
endpoints are forward-mode derivatives at delta = 0, as the JAX package's
`jax.jacfwd`: `torch.func.jvp` of the batched residual, vmapped over the 7
tangent directions. Edges are independent, so pushing the same tangent
through every edge at once gives one Jacobian column per edge.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jvp, vmap

from ..geometry import sim3


def sim3_relative_residual(S_iw: sim3.Sim3, S_jw: sim3.Sim3,
                           S_ji_meas: sim3.Sim3) -> torch.Tensor:
    """r = log(S_ji_meas ∘ S_iw ∘ S_jw^{-1}), shape (..., 7)."""
    return sim3.log(sim3.compose(S_ji_meas, sim3.compose(S_iw, sim3.inverse(S_jw))))


def sim3_relative_residual_jac(
    S_iw: sim3.Sim3, S_jw: sim3.Sim3, S_ji_meas: sim3.Sim3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual + Jacobians w.r.t. the left-mult tangents of both endpoints:
    (r (..., 7), J_i (..., 7, 7), J_j (..., 7, 7)), one pair per edge."""
    zero = torch.zeros(S_iw.t.shape[:-1] + (7,), dtype=S_iw.t.dtype, device=S_iw.t.device)

    def res(di, dj):
        return sim3_relative_residual(sim3.retract(S_iw, di), sim3.retract(S_jw, dj),
                                      S_ji_meas)

    basis = torch.eye(7, dtype=zero.dtype, device=zero.device)
    basis = basis.reshape((7,) + (1,) * (zero.dim() - 1) + (7,)).expand((7,) + zero.shape)

    def column_i(d):
        return jvp(lambda di: res(di, zero), (zero,), (d,))[1]

    def column_j(d):
        return jvp(lambda dj: res(zero, dj), (zero,), (d,))[1]

    r = res(zero, zero)
    J_i = torch.movedim(vmap(column_i)(basis), 0, -1)  # (..., 7 rows, 7 cols)
    J_j = torch.movedim(vmap(column_j)(basis), 0, -1)
    return r, J_i, J_j
