"""Relative-pose factors of the SE(3) LiDAR pose graph and the Sim(3)
essential graph.

Counterpart of `sqrtlm_slam_tpu/factors/pose_graph.py` (the Ceres
`EndBackFactor` chain factor and g2o `EdgeSim3`): for poses ``T_iw, T_jw``
(world -> frame) and the measurement ``T_ji``,

    r = log( T_ji_meas ∘ T_iw ∘ T_jw^{-1} )

The Jacobians w.r.t. the left-multiplicative tangents of both endpoints are
forward-mode derivatives at delta = 0, as the JAX package's `jax.jacfwd`:
`torch.func.jvp` of the batched residual, vmapped over the tangent
directions. Edges are independent, so pushing the same tangent through
every edge at once gives one Jacobian column per edge.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp, vmap

from ..geometry import se3, sim3


def _endpoint_jacobians(res: Callable, zero: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r, J_i, J_j) of `res(di, dj)` at di = dj = `zero` (..., D): one
    (..., D rows, D cols) Jacobian per edge and endpoint."""
    D = zero.shape[-1]
    basis = torch.eye(D, dtype=zero.dtype, device=zero.device)
    basis = basis.reshape((D,) + (1,) * (zero.dim() - 1) + (D,)).expand((D,) + zero.shape)

    def column_i(d):
        return jvp(lambda di: res(di, zero), (zero,), (d,))[1]

    def column_j(d):
        return jvp(lambda dj: res(zero, dj), (zero,), (d,))[1]

    J_i = torch.movedim(vmap(column_i)(basis), 0, -1)
    J_j = torch.movedim(vmap(column_j)(basis), 0, -1)
    return res(zero, zero), J_i, J_j


def se3_relative_residual(T_iw: se3.SE3, T_jw: se3.SE3, T_ji_meas: se3.SE3) -> torch.Tensor:
    """r = log(T_ji_meas ∘ T_iw ∘ T_jw^{-1}), shape (..., 6)."""
    return se3.log(se3.compose(T_ji_meas, se3.compose(T_iw, se3.inverse(T_jw))))


def se3_relative_residual_jac(
    T_iw: se3.SE3, T_jw: se3.SE3, T_ji_meas: se3.SE3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual + Jacobians w.r.t. the left-mult tangents of both endpoints:
    (r (..., 6), J_i (..., 6, 6), J_j (..., 6, 6)), one pair per edge."""
    if T_iw.t.dim() == 1:  # one edge: as a batch of one
        out = se3_relative_residual_jac(*(se3.SE3(T.R[None], T.t[None])
                                          for T in (T_iw, T_jw, T_ji_meas)))
        return tuple(x[0] for x in out)
    zero = torch.zeros(T_iw.t.shape[:-1] + (6,), dtype=T_iw.t.dtype, device=T_iw.t.device)
    return _endpoint_jacobians(
        lambda di, dj: se3_relative_residual(se3.retract(T_iw, di), se3.retract(T_jw, dj),
                                             T_ji_meas), zero)


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
    return _endpoint_jacobians(
        lambda di, dj: sim3_relative_residual(sim3.retract(S_iw, di), sim3.retract(S_jw, dj),
                                              S_ji_meas), zero)
