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

The JAX package compiles the whole `lax.scan` of Gauss-Newton steps. Here
one step (`_gn_step`) is a captured CUDA graph (`utils.cache.graphed`),
replayed `num_iters` times: the keyframe count changes with every loop
closure, so a capture of the whole loop would be replayed once, while a
capture of one step costs about one eager step and serves every iteration.
The block sums' plans are built once per call, outside the graph (one host
read each); the factorisation is `cholesky_ex`, whose info flag is never
read, so no host error check is left inside the loop. The graph is
captured with TF32 off. Only the newest capture is kept (`max_entries=1`):
device memory holds one step graph however many loops a run closes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..factors import pose_graph
from ..geometry import sim3
from ..optim import segment
from ..utils import cache


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


def _gn_step(p: PoseGraphProblem, h_plan: segment.SegmentPlan, b_plan: segment.SegmentPlan,
             pin: torch.Tensor, free: torch.Tensor, mu: float):
    """One damped Gauss-Newton step (the JAX package's `step` inside the
    `lax.scan` of `optimize_pose_graph`): the new (s, R, t). No host read."""
    K = p.s.shape[0]
    dtype = p.t.dtype
    ev = p.e_valid
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
    Hd = Hd + torch.diag(pin.to(dtype)) + mu * torch.eye(K * 7, dtype=dtype, device=Hd.device)
    bd = torch.where(pin, torch.zeros_like(bd), bd)
    L = torch.linalg.cholesky_ex(Hd)[0]
    dx = torch.cholesky_solve(-bd[:, None], L)[:, 0].reshape(K, 7)
    new = sim3.retract(p.poses(), dx)
    return (torch.where(free, new.s, p.s), torch.where(free[:, None, None], new.R, p.R),
            torch.where(free[:, None], new.t, p.t))


# One step per capture, the newest key only (see the module docstring).
_gn_step_jit = cache.graphed(_gn_step, static_argnames=("mu",), max_entries=1)


def _step_plans(problem: PoseGraphProblem):
    """`_gn_step`'s loop-constant inputs besides the problem: the plans of
    the block sums (block (row, col) keys of every edge's four endpoint
    blocks; vertex keys of its two gradient blocks; one host read each) and
    the pinned tangent rows and free vertices."""
    K = problem.s.shape[0]
    ei, ej = problem.e_i.long(), problem.e_j.long()
    ev = problem.e_valid
    h_plan = segment.segment_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
                                  K * K, keep=ev.repeat(4))
    b_plan = segment.segment_plan(torch.cat([ei, ej]), K, keep=ev.repeat(2))
    pin = torch.repeat_interleave(problem.fixed | ~problem.valid, 7)
    return h_plan, b_plan, pin, ~(problem.fixed | ~problem.valid)


def _optimize(problem: PoseGraphProblem, num_iters: int, mu: float):
    plans = _step_plans(problem)
    p = problem
    for _ in range(num_iters):
        s, R, t = _gn_step_jit(p, *plans, float(mu))
        p = p._replace(s=s, R=R, t=t)
    return p, _chi2(p)
