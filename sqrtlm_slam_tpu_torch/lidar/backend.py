"""SE(3) pose-graph backend for the LiDAR odometry chain.

Counterpart of `sqrtlm_slam_tpu/lidar/backend.py` (`art::Odom::BackEndForLoop`
/ `BackEndForGNSS`): the recorded frame chain with relative-pose edges, a
loop-closure edge or world-position anchors (GNSS), relaxed by damped
Gauss-Newton on the dense (6K, 6K) normal equations.

The endpoint blocks are summed into the Hessian in a fixed order
(`optim/segment.py`) instead of the JAX package's `.at[].add` scatter,
which on CUDA would add with atomics in no fixed order: two runs on the card
give the same poses bit for bit. The Cholesky factorisation is
`cholesky_ex` (no error check, so no host read per iteration), and matrix
products run in full float32 (TF32 off while the graph is optimised).

The JAX package jits the whole loop. Here one Gauss-Newton step
(`_gn_step`) is a captured CUDA graph (`utils.cache.graphed`, captured with
TF32 off), replayed `num_iters` times; its plans are built once per call,
outside the graph. The chain grows between calls, so only the newest
capture is kept (`max_entries=1`). `build_chain_graph` stays on the host,
as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..factors import pose_graph
from ..geometry import se3
from ..optim import segment
from ..utils import cache, to_host


class Se3Graph(NamedTuple):
    """Fixed-capacity SE3 pose graph (padded + masked)."""

    R: torch.Tensor  # (K, 3, 3) world -> frame
    t: torch.Tensor  # (K, 3)
    fixed: torch.Tensor  # (K,) bool
    valid: torch.Tensor  # (K,) bool
    e_i: torch.Tensor  # (E,) int32
    e_j: torch.Tensor  # (E,) int32
    e_R: torch.Tensor  # (E, 3, 3) measured T_ji
    e_t: torch.Tensor  # (E, 3)
    e_info: torch.Tensor  # (E,) scalar information weight
    e_valid: torch.Tensor  # (E,) bool
    # Unary world-position anchors (GNSS): ||C(T_k) - p_k||^2.
    a_idx: torch.Tensor  # (A,) int32 pose index
    a_pos: torch.Tensor  # (A, 3) anchor world position (sensor centre)
    a_info: torch.Tensor  # (A,)
    a_valid: torch.Tensor  # (A,) bool


def build_chain_graph(poses: list, loop_edges: list, anchors=(), K_cap: int = 0,
                      E_cap: int = 0, A_cap: int = 8, odom_info: float = 1.0,
                      loop_info: float = 2.0, anchor_info: float = 10.0) -> Se3Graph:
    """Host-side graph assembly from an odometry chain.

    poses: list of se3.SE3 (world -> frame), on one device; loop_edges:
    [(i, j, T_ji)]; anchors: [(k, xyz)] world positions. The graph lives on
    the poses' device. One read of the chain: the odometry edges are
    measured from the chain itself."""
    K = len(poses)
    K_cap = K_cap or K
    E_cap = E_cap or (K - 1 + len(loop_edges))
    device = poses[0].t.device
    chain = se3.SE3(torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses]))
    rel = se3.compose(se3.SE3(chain.R[1:], chain.t[1:]),
                      se3.inverse(se3.SE3(chain.R[:-1], chain.t[:-1])))
    cR, ct, rR, rt = to_host(chain.R, chain.t, rel.R, rel.t)

    R = np.tile(np.eye(3, dtype=np.float32), (K_cap, 1, 1))
    t = np.zeros((K_cap, 3), np.float32)
    R[:K], t[:K] = cR, ct
    valid = np.zeros(K_cap, bool)
    valid[:K] = True
    fixed = np.zeros(K_cap, bool)
    fixed[0] = True

    e_i = np.zeros(E_cap, np.int32)
    e_j = np.zeros(E_cap, np.int32)
    e_R = np.tile(np.eye(3, dtype=np.float32), (E_cap, 1, 1))
    e_t = np.zeros((E_cap, 3), np.float32)
    e_info = np.ones(E_cap, np.float32)
    e_valid = np.zeros(E_cap, bool)
    ne = min(K - 1, E_cap)
    e_i[:ne], e_j[:ne] = np.arange(ne), np.arange(1, ne + 1)
    e_R[:ne], e_t[:ne] = rR[:ne], rt[:ne]
    e_info[:ne] = odom_info
    e_valid[:ne] = True
    for (i, j, T_ji) in loop_edges:
        if ne >= E_cap:
            break
        e_i[ne], e_j[ne] = i, j
        e_R[ne], e_t[ne] = to_host(torch.as_tensor(T_ji.R), torch.as_tensor(T_ji.t))
        e_info[ne] = loop_info
        e_valid[ne] = True
        ne += 1

    a_idx = np.zeros(A_cap, np.int32)
    a_pos = np.zeros((A_cap, 3), np.float32)
    a_info = np.ones(A_cap, np.float32)
    a_valid = np.zeros(A_cap, bool)
    for s, (k, xyz) in enumerate(list(anchors)[:A_cap]):
        a_idx[s] = k
        a_pos[s] = np.asarray(xyz)
        a_info[s] = anchor_info
        a_valid[s] = True

    def T(a):
        return torch.as_tensor(a, device=device)

    return Se3Graph(R=T(R), t=T(t), fixed=T(fixed), valid=T(valid), e_i=T(e_i), e_j=T(e_j),
                    e_R=T(e_R), e_t=T(e_t), e_info=T(e_info), e_valid=T(e_valid),
                    a_idx=T(a_idx), a_pos=T(a_pos), a_info=T(a_info), a_valid=T(a_valid))


def _edge_args(g: Se3Graph):
    """(T_i, T_j, measured T_ji) of every edge."""
    ei, ej = g.e_i.long(), g.e_j.long()
    return (se3.SE3(g.R[ei], g.t[ei]), se3.SE3(g.R[ej], g.t[ej]), se3.SE3(g.e_R, g.e_t))


def optimize_se3_graph(g: Se3Graph, num_iters: int = 20, mu: float = 1e-6
                       ) -> Tuple[Se3Graph, torch.Tensor]:
    """Damped GN over the SE3 pose graph (+ optional position anchors).
    Returns (graph', edge chi2), both on the graph's device."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _optimize(g, num_iters, mu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _gn_step(g: Se3Graph, h_plan: segment.SegmentPlan, b_plan: segment.SegmentPlan,
             pin: torch.Tensor, free: torch.Tensor, mu: float):
    """One damped Gauss-Newton step of `optimize_se3_graph`: the new (R, t).
    No host read."""
    K = g.R.shape[0]
    ai = g.a_idx.long()
    dtype = g.t.dtype
    w = g.e_info * g.e_valid.to(dtype)
    wa = g.a_info * g.a_valid.to(dtype)
    r, J_i, J_j = pose_graph.se3_relative_residual_jac(*_edge_args(g))
    Hii = torch.einsum("eki,e,ekj->eij", J_i, w, J_i)
    Hjj = torch.einsum("eki,e,ekj->eij", J_j, w, J_j)
    Hij = torch.einsum("eki,e,ekj->eij", J_i, w, J_j)
    bi = torch.einsum("eki,e,ek->ei", J_i, w, r)
    bj = torch.einsum("eki,e,ek->ei", J_j, w, r)
    # Sensor-centre anchors: r = C - p with C = -R^T t; for the left
    # update T <- exp(d) T, d C / d [rho, phi] = [-R^T | 0].
    Ra = g.R[ai]
    ra = -torch.einsum("aji,aj->ai", Ra, g.t[ai]) - g.a_pos
    Ja = torch.cat([-Ra.transpose(-1, -2), torch.zeros_like(Ra)], dim=-1)  # (A, 3, 6)
    Ha = torch.einsum("aki,a,akj->aij", Ja, wa, Ja)
    ba = torch.einsum("aki,a,ak->ai", Ja, wa, ra)

    H = segment.segment_sum(h_plan, torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2), Ha]))
    b = segment.segment_sum(b_plan, torch.cat([bi, bj, ba]))
    Hd = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    bd = b.reshape(-1)
    Hd = torch.where(pin[:, None] | pin[None, :], torch.zeros_like(Hd), Hd)
    Hd = Hd + torch.diag(pin.to(dtype)) + mu * torch.eye(K * 6, dtype=dtype, device=Hd.device)
    bd = torch.where(pin, torch.zeros_like(bd), bd)
    L = torch.linalg.cholesky_ex(Hd)[0]
    dx = torch.cholesky_solve(-bd[:, None], L)[:, 0].reshape(K, 6)
    new = se3.retract(se3.SE3(g.R, g.t), dx)
    return torch.where(free[:, None, None], new.R, g.R), torch.where(free[:, None], new.t, g.t)


# One step per capture, the newest key only (see the module docstring).
_gn_step_jit = cache.graphed(_gn_step, static_argnames=("mu",), max_entries=1)


def _step_plans(g: Se3Graph):
    """`_gn_step`'s loop-constant inputs besides the graph: the plans of the
    block sums (block (row, col) keys of the edges' four endpoint blocks and
    the anchors' diagonal blocks; vertex keys of the gradient blocks; one
    host read each) and the pinned tangent rows and free poses."""
    K = g.R.shape[0]
    ei, ej, ai = g.e_i.long(), g.e_j.long(), g.a_idx.long()
    ev, av = g.e_valid, g.a_valid
    h_plan = segment.segment_plan(
        torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei, ai * K + ai]), K * K,
        keep=torch.cat([ev.repeat(4), av]))
    b_plan = segment.segment_plan(torch.cat([ei, ej, ai]), K, keep=torch.cat([ev, ev, av]))
    pin = torch.repeat_interleave(g.fixed | ~g.valid, 6)
    return h_plan, b_plan, pin, ~(g.fixed | ~g.valid)


def _optimize(g: Se3Graph, num_iters: int, mu: float):
    plans = _step_plans(g)
    for _ in range(num_iters):
        R, t = _gn_step_jit(g, *plans, float(mu))
        g = g._replace(R=R, t=t)
    r = pose_graph.se3_relative_residual(*_edge_args(g))
    chi2 = torch.sum(torch.where(g.e_valid, g.e_info * torch.sum(r * r, dim=-1),
                                 torch.zeros_like(g.e_info)))
    return g, chi2
