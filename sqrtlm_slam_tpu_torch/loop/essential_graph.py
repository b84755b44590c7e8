"""Sim(3) essential-graph optimisation (the 7-DoF scale-drift correction).

Counterpart of `sqrtlm_slam_tpu/loop/essential_graph.py`: a pose graph over
all keyframes with Sim3 vertices and a fixed-capacity edge list (new loop
edge, spanning tree, earlier loop edges, strong covisibility), solved by
damped Gauss-Newton on the dense (7K, 7K) normal equations with a Cholesky
factorisation each iteration.

The endpoint blocks are summed into the Hessian in a fixed order
(`optim/segment.py`) instead of the JAX package's `.at[].add` scatter,
which on CUDA would add with atomics in no fixed order. Matrix products run
in full float32: TF32 is off while the graph is optimised (with reduced
multiplies the normal equations lose the small Jacobian couplings and GN
diverges at a few hundred keyframes, as the JAX package found on the TPU).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..factors import pose_graph
from ..geometry import sim3
from ..optim import segment


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose graph (padded + masked)."""

    s: torch.Tensor  # (K,) scales of S_kw (world -> kf)
    R: torch.Tensor  # (K, 3, 3)
    t: torch.Tensor  # (K, 3)
    fixed: torch.Tensor  # (K,) bool: loop KF + padding
    valid: torch.Tensor  # (K,) bool
    e_i: torch.Tensor  # (E,) int32 endpoint i
    e_j: torch.Tensor  # (E,) int32 endpoint j
    e_s: torch.Tensor  # (E,) measured S_ji scale
    e_R: torch.Tensor  # (E, 3, 3)
    e_t: torch.Tensor  # (E, 3)
    e_valid: torch.Tensor  # (E,) bool

    def poses(self) -> sim3.Sim3:
        return sim3.Sim3(self.s, self.R, self.t)

    def measurements(self) -> sim3.Sim3:
        return sim3.Sim3(self.e_s, self.e_R, self.e_t)


def measure_edges(poses: sim3.Sim3, e_i: torch.Tensor, e_j: torch.Tensor) -> sim3.Sim3:
    """S_ji = S_jw ∘ S_iw^-1 from the given poses."""
    return sim3.compose(sim3.index(poses, e_j.long()),
                        sim3.inverse(sim3.index(poses, e_i.long())))


def _edge_poses(p: PoseGraphProblem):
    poses = p.poses()
    return sim3.index(poses, p.e_i.long()), sim3.index(poses, p.e_j.long())


def _chi2(p: PoseGraphProblem) -> torch.Tensor:
    S_i, S_j = _edge_poses(p)
    r = pose_graph.sim3_relative_residual(S_i, S_j, p.measurements())
    return torch.sum(torch.where(p.e_valid, torch.sum(r * r, dim=-1), torch.zeros_like(r[:, 0])))


def optimize_pose_graph(problem: PoseGraphProblem, num_iters: int = 20, mu: float = 1e-6
                        ) -> Tuple[PoseGraphProblem, torch.Tensor]:
    """Damped GN on the Sim3 pose graph. Returns (problem', final chi2)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _optimize(problem, num_iters, mu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _optimize(problem: PoseGraphProblem, num_iters: int, mu: float):
    K = problem.s.shape[0]
    ei, ej = problem.e_i.long(), problem.e_j.long()
    ev = problem.e_valid
    # Block (row, col) keys of the four endpoint blocks of every edge and
    # the vertex keys of its two gradient blocks: loop-constant plans.
    h_plan = segment.segment_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
                                  K * K, keep=ev.repeat(4))
    b_plan = segment.segment_plan(torch.cat([ei, ej]), K, keep=ev.repeat(2))
    pin = torch.repeat_interleave(problem.fixed | ~problem.valid, 7)
    free = ~(problem.fixed | ~problem.valid)
    dtype = problem.t.dtype
    eye = torch.eye(K * 7, dtype=dtype, device=problem.t.device)

    p = problem
    for _ in range(num_iters):
        S_i, S_j = _edge_poses(p)
        r, J_i, J_j = pose_graph.sim3_relative_residual_jac(S_i, S_j, p.measurements())
        w = ev.to(dtype)
        Hii = torch.einsum("eki,e,ekj->eij", J_i, w, J_i)
        Hjj = torch.einsum("eki,e,ekj->eij", J_j, w, J_j)
        Hij = torch.einsum("eki,e,ekj->eij", J_i, w, J_j)
        bi = torch.einsum("eki,e,ek->ei", J_i, w, r)
        bj = torch.einsum("eki,e,ek->ei", J_j, w, r)
        H = segment.segment_sum(h_plan, torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
        b = segment.segment_sum(b_plan, torch.cat([bi, bj]))
        Hd = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        bd = b.reshape(-1)
        Hd = torch.where(pin[:, None] | pin[None, :], torch.zeros_like(Hd), Hd)
        Hd = Hd + torch.diag(pin.to(dtype)) + mu * eye
        bd = torch.where(pin, torch.zeros_like(bd), bd)
        L = torch.linalg.cholesky(Hd)
        dx = torch.cholesky_solve(-bd[:, None], L)[:, 0].reshape(K, 7)
        new = sim3.retract(p.poses(), dx)
        p = p._replace(
            s=torch.where(free, new.s, p.s),
            R=torch.where(free[:, None, None], new.R, p.R),
            t=torch.where(free[:, None], new.t, p.t),
        )
    return p, _chi2(p)
