"""Flat-edge bundle adjustment with a dense cross block W: the `flat` backend.

Counterpart of `sqrtlm_slam_tpu/optim/schur.py`. The problem is a flat (E,)
edge list (`BAProblem`); one LM iteration is

    per-edge residual / Jacobians -> robust weights
      -> keyed sums of Hpp (P,6,6), Hll (L,3,3), W (P*6, L, 3), bp, bl
      -> batched closed-form 3x3 inverse of the damped Hll (`inv3x3`)
      -> S = blockdiag(Hpp_d) - W Hll^-1 W^T   (one matmul)
      -> gauge-fixed dense Cholesky solve for the poses
      -> landmark back-substitution.

The JAX package runs this engine as XLA (it reaches no Pallas kernel), so
here it is plain PyTorch on every device. The keyed sums (by camera, by
landmark, and W by `cam * L + pt`) go through `segment.py` over the active
edges: a fixed order and no atomics, so reruns on the card are bitwise
equal. The groupings depend on the observation graph alone and are built
once per LM loop (`edge_plans`, three host reads), padded (every key, a
width bucketed to a power of two) so that their shapes depend on the
problem's shape and the widths' buckets alone. The dense W costs P*6*L*3
floats (57 MB at P=96, L=8192): local windows, not whole maps. The
matrix-free half (`cg_reduce_and_solve`, `ba_iterate_cg`, `global_ba_cg`)
never forms W and reuses the bucketed engine's PCG.

On the card the LM loops are captured CUDA graphs (`utils.cache`; the JAX
package jits them): `ba_iterate`'s whole loop is one graph (local BA's two
phases each replay one, with the survivor gate and the second phase's plans
between them; global BA replays one of its own), and `ba_iterate_cg`'s
iteration is the bucketed engine's three graphs: the edge data, the
damped blocks and the PCG's start; a chunk of `PCG_CHECK_EVERY` PCG
iterations, the done flag read between replays; the back-substitution, the
candidate's chi2 and the gain-ratio test. Local and global BA keep
captures of their own (`max_entries`), so neither evicts the other's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..factors import reprojection as reproj
from ..geometry import se3
from . import assembly, segment
from . import loss as losses
from .edge_kernels import inv3x3
from ..utils import cache
from .schur_bucketed import (PCG_CHECK_EVERY, BAProblem, CGHead, CGSteps, LMState, PCGState,
                             _apply_update, _lm_accept, _pcg_iterations, _pcg_run, _pcg_start,
                             lm_cg_loop, lm_test, solve_pose_system)


class BAStats(NamedTuple):
    chi2: torch.Tensor
    num_inlier_edges: torch.Tensor
    iters_accepted: torch.Tensor


class EdgePlans(NamedTuple):
    """The active edges grouped by camera, by landmark and by (camera,
    landmark) pair, each in a fixed order."""

    cam: segment.SegmentPlan
    pt: segment.SegmentPlan
    pair: segment.SegmentPlan  # key cam * L + pt


def edge_plans(problem: BAProblem, active) -> EdgePlans:
    """Groupings of the keyed sums, padded (three host reads)."""
    return _plans(problem, active, pair=True)


def _plans(problem: BAProblem, active, pair: bool) -> EdgePlans:
    """`edge_plans`, without the (camera, landmark) grouping unless `pair`
    (the matrix-free engine forms no W: two host reads)."""
    P, L = problem.num_poses, problem.num_points
    cam, pt = problem.obs_cam.long(), problem.obs_pt.long()
    return EdgePlans(
        cam=segment.segment_plan(cam, P, keep=active, pad=True),
        pt=segment.segment_plan(pt, L, keep=active, pad=True),
        pair=segment.segment_plan(cam * L + pt, P * L, keep=active, pad=True) if pair else None)


def _edge_terms(problem: BAProblem, cam: reproj.Camera, active, robust_delta):
    """Per-edge (r, Jp, Jl, w, chi2, e2) with mono/stereo unified to 3 dof:
    the bucketed engine's edge terms with one slot per edge."""
    idx = problem.obs_cam.long()
    w_info = problem.obs_inv_sigma2 * active.to(problem.points.dtype)
    r, Jp, Jl, w, chi2, e2 = assembly.edge_terms(
        problem.pose_R, problem.pose_t, problem.points[problem.obs_pt.long()], idx[:, None],
        problem.obs_uvr[:, None], w_info[:, None], cam, robust_delta)
    return r[:, 0], Jp[:, 0], Jl[:, 0], w[:, 0], chi2, e2[:, 0]


def _edge_data(problem: BAProblem, cam: reproj.Camera, active, robust_delta,
               plans: EdgePlans):
    """Per-edge Jacobians and weights with the block-diagonal sums (no W):
    (r, Jp, Jl, w, Hpp, Hll, bp, bl, chi2). Fixed poses get no pose
    Jacobian (their rows stay empty)."""
    r, Jp, Jl, w, chi2, _ = _edge_terms(problem, cam, active, robust_delta)
    free = (~problem.pose_fixed)[problem.obs_cam.long()]
    Jp = Jp * free[:, None, None].to(Jp.dtype)
    Hpp = segment.segment_sum(plans.cam, torch.einsum("eki,e,ekj->eij", Jp, w, Jp))
    Hll = segment.segment_sum(plans.pt, torch.einsum("eki,e,ekj->eij", Jl, w, Jl))
    bp = segment.segment_sum(plans.cam, torch.einsum("eki,e,ek->ei", Jp, w, r))
    bl = segment.segment_sum(plans.pt, torch.einsum("eki,e,ek->ei", Jl, w, r))
    return r, Jp, Jl, w, Hpp, Hll, bp, bl, chi2


def build_normal_equations(problem: BAProblem, cam: reproj.Camera, active, robust_delta,
                           plans: Optional[EdgePlans] = None):
    """Assemble (Hpp, Hll, W, bp, bl, chi2); W has shape (P*6, L, 3).
    `plans` is `edge_plans(problem, active)` (built here when absent)."""
    P, L = problem.num_poses, problem.num_points
    if plans is None:
        plans = edge_plans(problem, active)
    r, Jp, Jl, w, Hpp, Hll, bp, bl, chi2 = _edge_data(problem, cam, active, robust_delta,
                                                      plans)
    W = segment.segment_sum(plans.pair, torch.einsum("eki,e,ekj->eij", Jp, w, Jl))
    W = W.reshape(P, L, 6, 3).permute(0, 2, 1, 3).reshape(P * 6, L, 3)
    return Hpp, Hll, W, bp, bl, chi2


def _damp(H: torch.Tensor, mu) -> torch.Tensor:
    """Marquardt (multiplicative) damping plus a 1e-8 floor, (..., n, n)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + mu * torch.diagonal(H, dim1=-2, dim2=-1)[..., None] * eye + 1e-8 * eye


def _blockdiag(blocks: torch.Tensor) -> torch.Tensor:
    """(P, 6, 6) block-diagonal -> (P*6, P*6) dense, without a scatter."""
    P = blocks.shape[0]
    eyeP = torch.eye(P, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("pij,pq->piqj", blocks, eyeP).reshape(P * 6, P * 6)


def reduce_and_solve(Hpp, Hll, W, bp, bl, pose_fixed, point_valid, mu
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damp, Schur-reduce, solve poses, back-substitute landmarks.
    Returns (dx_pose (P, 6), dx_point (L, 3))."""
    P, L = Hpp.shape[0], Hll.shape[0]
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    # Invalid landmarks get identity blocks (zero rhs => zero update).
    Hll_inv = inv3x3(torch.where(point_valid[:, None, None], _damp(Hll, mu), eye3))
    W2 = W.reshape(P * 6, L * 3)
    WHinv = torch.einsum("alk,lkm->alm", W, Hll_inv).reshape(P * 6, L * 3)
    S = _blockdiag(_damp(Hpp, mu)) - WHinv @ W2.T
    rhs = -(bp.reshape(-1) - WHinv @ bl.reshape(-1))
    dxp = solve_pose_system(S, rhs, pose_fixed)
    Wt_dxp = (dxp.reshape(1, -1) @ W2).reshape(L, 3)
    dxl = torch.einsum("lkm,lm->lk", Hll_inv, -bl - Wt_dxp)
    return dxp, torch.where(point_valid[:, None], dxl, torch.zeros_like(dxl))


def chi2_only(problem: BAProblem, cam: reproj.Camera, active, robust_delta):
    """Residual-only robust chi2 at the problem's state."""
    return _edge_terms(problem, cam, active, robust_delta)[4]


def _lm_loop(problem: BAProblem, cam: reproj.Camera, active, num_iters: int,
             robust_delta, step_fn):
    """Nielsen-damped LM with rollback: `step_fn(prob, mu) -> (dxp, dxl,
    bp, bl)`; the candidate is scored by a residual-only chi2. No host read
    inside the loop. Returns (problem, chi2, accepted count)."""
    chi2 = chi2_only(problem, cam, active, robust_delta)
    mu = torch.full_like(chi2, 1e-3)
    nu = torch.full_like(chi2, 2.0)
    n_acc = torch.zeros((), dtype=torch.int32, device=chi2.device)
    prob = problem
    for _ in range(num_iters):
        dxp, dxl, bp, bl = step_fn(prob, mu)
        candidate = _apply_update(prob, dxp, dxl)
        chi2_c = chi2_only(candidate, cam, active, robust_delta)
        accept, prob, mu, nu = _lm_accept(prob, candidate, chi2, chi2_c, dxp, dxl, bp, bl,
                                          mu, nu)
        chi2 = torch.where(accept, chi2_c, chi2)
        n_acc = n_acc + accept.to(torch.int32)
    return prob, chi2, n_acc


def _ba_loop(problem: BAProblem, active, plans: EdgePlans, cam: reproj.Camera,
             num_iters: int, robust_delta) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """`ba_iterate`'s LM loop on given plans (the graphed body)."""

    def step(prob, mu):
        Hpp, Hll, W, bp, bl, _ = build_normal_equations(prob, cam, active, robust_delta,
                                                        plans)
        dxp, dxl = reduce_and_solve(Hpp, Hll, W, bp, bl, prob.pose_fixed, prob.point_valid,
                                    mu)
        return dxp, dxl, bp, bl

    return _lm_loop(problem, cam, active, num_iters, robust_delta, step)


# The LM loop as captured graphs, one a key (the static arguments, the
# problem's shape and the plans' widths). Local BA's windows share the
# shapes of `LocalMappingConfig`: its two phases times the plans' width
# buckets made 4 keys over a 40-frame KITTI-size run's 6 windows, all
# captured in the first three (chip_smoke.py phase 16). Global BA's shapes
# change with every loop closure, and it keeps its newest capture only.
LOCAL_CAPTURES = 4
_local_loop_jit = cache.graphed(_ba_loop, static_argnames=("cam", "num_iters", "robust_delta"),
                                max_entries=LOCAL_CAPTURES)
_global_loop_jit = cache.graphed(_ba_loop, static_argnames=("cam", "num_iters", "robust_delta"),
                                 max_entries=1)


def ba_iterate(problem: BAProblem, cam: reproj.Camera, active, num_iters: int,
               robust_delta: Optional[float], tau: float = 1e-5
               ) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """`num_iters` damped LM iterations, the normal equations rebuilt each
    iteration. Returns (problem, chi2, accepted count). The plans are built
    here (three host reads); the loop is local BA's graph on the card.

    `tau` is the JAX package's parameter, which its loop never reads: the
    multiplicative damping starts at mu = 1e-3 (Nielsen) whatever `tau`."""
    return _local_loop_jit(problem, active, edge_plans(problem, active), cam=cam,
                           num_iters=num_iters, robust_delta=robust_delta)


def edge_chi2_and_depth(problem: BAProblem, cam: reproj.Camera):
    """Per-edge chi2 (info-weighted) and camera-frame depth, for gating."""
    e2 = _edge_terms(problem, cam, problem.obs_valid, None)[5]
    idx = problem.obs_cam.long()
    T = se3.SE3(problem.pose_R[idx], problem.pose_t[idx])
    return e2, se3.act(T, problem.points[problem.obs_pt.long()])[..., 2]


def _survivors(problem: BAProblem, cam: reproj.Camera):
    """The chi2 (5.991 mono / 7.815 stereo) and positive-depth gate."""
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    return problem.obs_valid & (e2 <= gate) & (z > 0)


def local_ba(problem: BAProblem, cam: reproj.Camera, first_iters: int = 5,
             second_iters: int = 10) -> Tuple[BAProblem, torch.Tensor, BAStats]:
    """Two-phase local BA: robust iterations, the chi2/depth gate, then
    iterations on the survivors. Returns (problem, survivors (E,), stats)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, _, acc1 = ba_iterate(problem, cam, problem.obs_valid, first_iters,
                                  robust_delta=delta2)
    active = _survivors(problem, cam)
    problem, chi2, acc2 = ba_iterate(problem, cam, active, second_iters, robust_delta=None)
    survivors = _survivors(problem, cam)
    return problem, survivors, BAStats(chi2=chi2, num_inlier_edges=survivors.sum(),
                                       iters_accepted=acc1 + acc2)


def global_ba(problem: BAProblem, cam: reproj.Camera, num_iters: int = 20
              ) -> Tuple[BAProblem, torch.Tensor, BAStats]:
    """Global BA: all keyframes and landmarks, `num_iters` robust iterations."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, chi2, acc = _global_loop_jit(problem, problem.obs_valid,
                                          edge_plans(problem, problem.obs_valid), cam=cam,
                                          num_iters=num_iters, robust_delta=delta2)
    survivors = _survivors(problem, cam)
    return problem, survivors, BAStats(chi2=chi2, num_inlier_edges=survivors.sum(),
                                       iters_accepted=acc)


# ----------------------------------------------------------------------
# Matrix-free Schur + PCG: S = Hpp - W Hll^-1 W^T applied edge-wise, never
# formed; block-Jacobi preconditioned CG on the reduced camera system.
# ----------------------------------------------------------------------


def _schur_matvec(v, Jp, Jl, w, obs_cam, obs_pt, Hpp_d, Hll_inv, pose_fixed,
                  plans: EdgePlans):
    """S @ v for v (P, 6) without W. Returns (P, 6)."""
    v = torch.where(pose_fixed[:, None], torch.zeros_like(v), v)
    tmp = torch.einsum("ekj,ej->ek", Jp, v[obs_cam])
    Wt_v = segment.segment_sum(plans.pt, torch.einsum("eki,e,ek->ei", Jl, w, tmp))
    y = torch.einsum("lij,lj->li", Hll_inv, Wt_v)
    z = torch.einsum("ekj,ej->ek", Jl, y[obs_pt])
    Wy = segment.segment_sum(plans.cam, torch.einsum("eki,e,ek->ei", Jp, w, z))
    Sv = torch.einsum("pij,pj->pi", Hpp_d, v) - Wy
    return torch.where(pose_fixed[:, None], v, Sv)


class CGContext(NamedTuple):
    """An LM iteration's matrix-free system: the edge Jacobians and weights
    and the damped blocks."""

    Jp: torch.Tensor  # (E, 3, 6)
    Jl: torch.Tensor  # (E, 3, 3)
    w: torch.Tensor  # (E,)
    Hpp_d: torch.Tensor  # (P, 6, 6)
    Hll_inv: torch.Tensor  # (L, 3, 3)
    bp: torch.Tensor  # (P, 6)
    bl: torch.Tensor  # (L, 3)
    chi2: torch.Tensor  # ()


def _cg_head(problem: BAProblem, active, mu, plans: EdgePlans, cam: reproj.Camera,
             robust_delta, tol: float) -> CGHead:
    """The edge data, the damped blocks, the right-hand side -(bp - W Hll^-1
    bl) edge-wise, the preconditioner and the PCG's start (the first graph
    of `ba_iterate_cg`'s iteration; `CGHead.Mp` is the preconditioner)."""
    obs_pt = problem.obs_pt.long()
    _, Jp, Jl, w, Hpp, Hll, bp, bl, chi2 = _edge_data(problem, cam, active, robust_delta,
                                                      plans)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    Hll_inv = inv3x3(torch.where(problem.point_valid[:, None, None], _damp(Hll, mu), eye3))
    Hpp_d = _damp(Hpp, mu)
    z = torch.einsum("ekj,ej->ek", Jl, torch.einsum("lij,lj->li", Hll_inv, bl)[obs_pt])
    rhs = -(bp - segment.segment_sum(plans.cam, torch.einsum("eki,e,ek->ei", Jp, w, z)))
    diag_ok = problem.pose_valid & ~problem.pose_fixed
    Minv = torch.linalg.inv_ex(torch.where(diag_ok[:, None, None], Hpp_d, eye6)
                               + 1e-8 * eye6)[0]
    ctx = CGContext(Jp=Jp, Jl=Jl, w=w, Hpp_d=Hpp_d, Hll_inv=Hll_inv, bp=bp, bl=bl, chi2=chi2)
    return CGHead(ctx=ctx, Mp=Minv, pcg=_pcg_start(rhs, Minv, problem.pose_fixed, tol))


def _pcg_chunk(ctx: CGContext, Minv, obs_cam, obs_pt, pose_fixed, plans: EdgePlans,
               s: PCGState, steps: int) -> PCGState:
    """`steps` PCG iterations on the system of `ctx` (the second graph)."""
    obs_cam, obs_pt = obs_cam.long(), obs_pt.long()
    return _pcg_iterations(
        lambda v: _schur_matvec(v, ctx.Jp, ctx.Jl, ctx.w, obs_cam, obs_pt, ctx.Hpp_d,
                                ctx.Hll_inv, pose_fixed, plans), Minv, s, steps)


def _cg_back_substitute(problem: BAProblem, ctx: CGContext, x, plans: EdgePlans):
    """(dxp, dxl) from the PCG's pose step: dxl = Hll^-1 (-bl - W^T dxp),
    edge-wise."""
    dxp = torch.where(problem.pose_fixed[:, None], torch.zeros_like(x), x)
    tmp = torch.einsum("ekj,ej->ek", ctx.Jp, dxp[problem.obs_cam.long()])
    Wt_dxp = segment.segment_sum(plans.pt, torch.einsum("eki,e,ek->ei", ctx.Jl, ctx.w, tmp))
    dxl = torch.einsum("lij,lj->li", ctx.Hll_inv, -ctx.bl - Wt_dxp)
    dxl = torch.where(problem.point_valid[:, None], dxl, torch.zeros_like(dxl))
    return dxp, dxl


def cg_reduce_and_solve(problem: BAProblem, cam: reproj.Camera, active, robust_delta, mu,
                        cg_iters: int = 100, cg_tol: float = 1e-6,
                        plans: Optional[EdgePlans] = None):
    """One damped-GN step via matrix-free Schur + PCG.
    Returns (dxp (P,6), dxl (L,3), chi2, bp, bl, cg_n)."""
    if plans is None:
        plans = edge_plans(problem, active)
    head = _cg_head(problem, active, mu, plans, cam, robust_delta, cg_tol)
    s = _pcg_run(lambda st, steps: _pcg_chunk(head.ctx, head.Mp, problem.obs_cam,
                                              problem.obs_pt, problem.pose_fixed, plans, st,
                                              steps),
                 head.pcg, cg_iters, PCG_CHECK_EVERY)
    dxp, dxl = _cg_back_substitute(problem, head.ctx, s.x, plans)
    return dxp, dxl, head.ctx.chi2, head.ctx.bp, head.ctx.bl, s.n


def _lm_tail(problem: BAProblem, ctx: CGContext, x, chi2, mu, nu, active, plans: EdgePlans,
             cam: reproj.Camera, robust_delta) -> LMState:
    """The back-substitution, the candidate, its chi2 and the gain-ratio
    test (the third graph)."""
    dxp, dxl = _cg_back_substitute(problem, ctx, x, plans)
    return lm_test(problem, dxp, dxl, chi2, mu, nu, ctx.bp, ctx.bl,
                   lambda c: chi2_only(c, cam, active, robust_delta))


# `ba_iterate_cg`'s graphs: it serves global BA, whose shapes change with
# every loop closure (one key a graph in a run of it; the newest is kept).
_cg_head_jit = cache.graphed(_cg_head, static_argnames=("cam", "robust_delta", "tol"),
                             max_entries=1)
_pcg_chunk_jit = cache.graphed(_pcg_chunk, static_argnames=("steps",), max_entries=1)
_lm_tail_jit = cache.graphed(_lm_tail, static_argnames=("cam", "robust_delta"),
                             max_entries=1)


def ba_iterate_cg(problem: BAProblem, cam: reproj.Camera, active, num_iters: int,
                  robust_delta: Optional[float], tau: float = 1e-5, cg_iters: int = 100
                  ) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """LM loop on the matrix-free PCG step (tight CG tolerance, 1e-6). `tau`
    as in `ba_iterate`: not read, mu starts at 1e-3. The plans are built
    once (two host reads); each iteration replays the three graphs on the
    card, through the bucketed engine's LM loop (`lm_cg_loop`)."""
    plans = _plans(problem, active, pair=False)
    steps = CGSteps(
        head=lambda prob, mu: _cg_head_jit(prob, active, mu, plans, cam=cam,
                                           robust_delta=robust_delta, tol=1e-6),
        chunk=lambda prob, h, s, n: _pcg_chunk_jit(h.ctx, h.Mp, prob.obs_cam, prob.obs_pt,
                                                   prob.pose_fixed, plans, s, steps=n),
        tail=lambda prob, h, x, chi2, mu, nu: _lm_tail_jit(prob, h.ctx, x, chi2, mu, nu, active,
                                                           plans, cam=cam,
                                                           robust_delta=robust_delta))
    return lm_cg_loop(steps, problem, chi2_only(problem, cam, active, robust_delta), num_iters,
                      cg_iters)


def global_ba_cg(problem: BAProblem, cam: reproj.Camera, num_iters: int = 20
                 ) -> Tuple[BAProblem, torch.Tensor, BAStats]:
    """Whole-map global BA on the matrix-free engine."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, chi2, acc = ba_iterate_cg(problem, cam, problem.obs_valid, num_iters,
                                       robust_delta=delta2)
    survivors = _survivors(problem, cam)
    return problem, survivors, BAStats(chi2=chi2, num_inlier_edges=survivors.sum(),
                                       iters_accepted=acc)
