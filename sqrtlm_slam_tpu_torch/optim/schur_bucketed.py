"""Landmark-bucketed sqrt-Schur BA engine: local BA and matrix-free global BA.

Counterpart of `sqrtlm_slam_tpu/optim/schur_bucketed.py` (its XLA-layout
path). Local BA is damped LM with landmark Schur elimination in
square-root form,

    Hll_d = Lc Lc^T          (batched closed-form 3x3 Cholesky)
    V     = U Lc^{-T}        (whitened cross blocks, U = Jp^T w Jl)
    Y     = scatter-by-cam(V)            (P, L, 6, 3)
    S     = Hpp_d - Y Y^T                (one matmul)
    rhs   = -(bp - Y (Lc^{-1} bl))

The per-iteration reductions (Hll, bl, U, Hpp, bp, chi2) come from kernel
K2 (`optim/assembly.py`) on CUDA and from its plain version on the CPU.
`S` and the 6P x 6P Cholesky stay `torch.matmul` / `torch.linalg`, as the
JAX package left them to XLA. The LM loop is a Python loop of `torch.where`
selects with no host sync per iteration. The TPU layouts (rows layout,
chunked S-Gram, bf16 Y) are not ported.

Global BA (`ba_iterate_cg`, `global_ba_cg`) applies the reduced camera
system matrix-free inside a block-Jacobi PCG, with the context built from
K2's `AssemblyOut` and the LM candidate test on K3 (`chi2_only`) at both
ends. Camera-keyed sums go through `segment.segment_sum` (fixed order, no
atomics), so global BA is bitwise repeatable on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..factors import reprojection as reproj
from ..geometry import se3
from ..utils import to_host
from . import assembly
from . import loss as losses
from . import segment


class BAProblem(NamedTuple):
    """Flat (E,) edge-list BA problem (numpy or tensor fields): the flat
    engine's container (`schur.BAProblem` is this class) and what
    `from_flat` consumes."""

    pose_R: object  # (P, 3, 3)
    pose_t: object  # (P, 3)
    pose_fixed: object  # (P,) bool
    pose_valid: object  # (P,) bool
    points: object  # (L, 3)
    point_valid: object  # (L,) bool
    obs_cam: object  # (E,) int
    obs_pt: object  # (E,) int
    obs_uvr: object  # (E, 3)
    obs_inv_sigma2: object  # (E,)
    obs_valid: object  # (E,) bool

    @property
    def num_poses(self):
        return self.pose_R.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    def poses(self) -> se3.SE3:
        return se3.SE3(self.pose_R, self.pose_t)


class BucketedBAProblem(NamedTuple):
    """Fixed-capacity BA problem with (L, K) landmark-bucketed observations."""

    pose_R: torch.Tensor  # (P, 3, 3)
    pose_t: torch.Tensor  # (P, 3)
    pose_fixed: torch.Tensor  # (P,) bool
    pose_valid: torch.Tensor  # (P,) bool
    points: torch.Tensor  # (L, 3)
    point_valid: torch.Tensor  # (L,) bool
    obs_cam: torch.Tensor  # (L, K) int32 pose index (0 where invalid)
    obs_uvr: torch.Tensor  # (L, K, 3)
    obs_inv_sigma2: torch.Tensor  # (L, K)
    obs_valid: torch.Tensor  # (L, K) bool

    @property
    def num_poses(self):
        return self.pose_R.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    def poses(self) -> se3.SE3:
        return se3.SE3(self.pose_R, self.pose_t)


def bucketed_from_numpy(arrays: dict, device) -> BucketedBAProblem:
    """BucketedBAProblem on `device` from a dict of numpy arrays."""
    f32 = torch.float32
    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), device=device).to(dtype)
    return BucketedBAProblem(
        pose_R=t("pose_R", f32), pose_t=t("pose_t", f32),
        pose_fixed=t("pose_fixed", torch.bool), pose_valid=t("pose_valid", torch.bool),
        points=t("points", f32), point_valid=t("point_valid", torch.bool),
        obs_cam=t("obs_cam", torch.int32), obs_uvr=t("obs_uvr", f32),
        obs_inv_sigma2=t("obs_inv_sigma2", f32), obs_valid=t("obs_valid", torch.bool),
    )


def from_flat(problem: BAProblem, K: int, device="cuda") -> BucketedBAProblem:
    """Re-bucket a flat problem (E,) by landmark into (L, K) slots (host-side
    numpy, one time); raises if a landmark has more than K valid edges."""
    L = np.asarray(problem.points).shape[0]
    obs_pt = np.asarray(problem.obs_pt)
    obs_cam = np.asarray(problem.obs_cam)
    obs_uvr = np.asarray(problem.obs_uvr)
    obs_is2 = np.asarray(problem.obs_inv_sigma2)
    obs_val = np.asarray(problem.obs_valid)

    cam_b = np.zeros((L, K), np.int32)
    uvr_b = np.full((L, K, 3), -1.0, np.float32)
    is2_b = np.ones((L, K), np.float32)
    val_b = np.zeros((L, K), bool)
    ev = np.nonzero(obs_val)[0]
    lv = obs_pt[ev]
    order = np.argsort(lv, kind="stable")
    ev, lv = ev[order], lv[order]
    counts = np.bincount(lv, minlength=L)
    if counts.max(initial=0) > K:
        worst = int(np.argmax(counts))
        raise ValueError(f"landmark {worst} has more than K={K} observations")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ev)) - starts[lv]
    cam_b[lv, slot] = obs_cam[ev]
    uvr_b[lv, slot] = obs_uvr[ev]
    is2_b[lv, slot] = obs_is2[ev]
    val_b[lv, slot] = True
    return bucketed_from_numpy(
        dict(pose_R=problem.pose_R, pose_t=problem.pose_t, pose_fixed=problem.pose_fixed,
             pose_valid=problem.pose_valid, points=problem.points,
             point_valid=problem.point_valid, obs_cam=cam_b, obs_uvr=uvr_b,
             obs_inv_sigma2=is2_b, obs_valid=val_b),
        device,
    )


# ----------------------------------------------------------------------
# Closed-form batched 3x3 Cholesky machinery (the square-root factors).
# ----------------------------------------------------------------------


def chol3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form Cholesky of SPD (..., 3, 3): M = L L^T (lower)."""
    eps = 1e-20
    a11, a21, a31 = M[..., 0, 0], M[..., 1, 0], M[..., 2, 0]
    a22, a32, a33 = M[..., 1, 1], M[..., 2, 1], M[..., 2, 2]
    l11 = torch.sqrt(torch.clamp(a11, min=eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=eps))
    zero = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, zero, zero], dim=-1),
        torch.stack([l21, l22, zero], dim=-1),
        torch.stack([l31, l32, l33], dim=-1),
    ], dim=-2)


def trinv_lower3x3(Lc: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of lower-triangular (..., 3, 3)."""
    l11, l21, l31 = Lc[..., 0, 0], Lc[..., 1, 0], Lc[..., 2, 0]
    l22, l32, l33 = Lc[..., 1, 1], Lc[..., 2, 1], Lc[..., 2, 2]
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    zero = torch.zeros_like(m11)
    return torch.stack([
        torch.stack([m11, zero, zero], dim=-1),
        torch.stack([m21, m22, zero], dim=-1),
        torch.stack([m31, m32, m33], dim=-1),
    ], dim=-2)


# ----------------------------------------------------------------------
# Edge terms and reductions (the plain version of K2).
# ----------------------------------------------------------------------


def _edge_terms(problem: BucketedBAProblem, cam: reproj.Camera, active, robust_delta):
    """Per-slot (r, Jp, Jl, w, chi2, e2) with mono/stereo unified (L, K, ...)."""
    w_info = problem.obs_inv_sigma2 * active.to(problem.points.dtype)
    return assembly.edge_terms(problem.pose_R, problem.pose_t, problem.points,
                               problem.obs_cam, problem.obs_uvr, w_info, cam,
                               robust_delta)


def reductions_from_terms(problem: BucketedBAProblem, terms) -> assembly.AssemblyOut:
    """Mu-independent reductions (Hll, bl, U, Hpp, bp, chi2) from edge terms."""
    return assembly.reductions(terms, problem.obs_cam, ~problem.pose_fixed,
                               problem.num_poses)


def assemble(problem: BucketedBAProblem, cam: reproj.Camera, active,
             robust_delta, groups: Optional[segment.KeyGroups] = None
             ) -> assembly.AssemblyOut:
    """The reductions of one LM iteration: kernel K2 on CUDA, its plain
    version (`_edge_terms` + `reductions_from_terms`) on the CPU. `groups`
    is `camera_groups(problem, active)` (built by the kernel's wrapper when
    absent)."""
    w_active = problem.obs_inv_sigma2 * active.to(problem.points.dtype)
    return assembly.assemble(problem.pose_R, problem.pose_t, ~problem.pose_fixed,
                             problem.points, problem.obs_cam, problem.obs_uvr, w_active,
                             cam, robust_delta, groups=groups)


def edge_chi2_and_depth(problem: BucketedBAProblem, cam: reproj.Camera):
    """Per-slot chi2 (info-weighted) and camera-frame depth, for gating."""
    e2 = _edge_terms(problem, cam, problem.obs_valid, None)[5]
    idx = problem.obs_cam.long()
    T = se3.SE3(problem.pose_R[idx], problem.pose_t[idx])
    z = se3.act(T, problem.points[:, None, :])[..., 2]
    return e2, z


# ----------------------------------------------------------------------
# One damped step: build S, solve, back-substitute.
# ----------------------------------------------------------------------


class LocalPieces(NamedTuple):
    S_half: torch.Tensor  # (P*6, P*6) = blockdiag(Hpp_d) - Y Y^T
    bp: torch.Tensor  # (P, 6)
    rhs_corr: torch.Tensor  # (P*6,) = Y (Hll_d^{-1} bl)
    chi2: torch.Tensor  # ()
    U: torch.Tensor  # (L, K, 6, 3)
    Minv: torch.Tensor  # (L, 3, 3)
    bl: torch.Tensor  # (L, 3)


def _pieces_tail(problem: BucketedBAProblem, Hll, bl, U, Hpp, bp, chi2, mu) -> LocalPieces:
    """Damping + sqrt-Schur factors from the assembled reductions."""
    P, L = problem.num_poses, problem.num_points
    dtype, dev = bl.dtype, bl.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    # (L, K, P) one-hot by comparison: `one_hot` checks its classes on the host.
    O = (problem.obs_cam.long()[..., None] == torch.arange(P, device=dev)).to(dtype)

    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_d = Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
    Hll_d = torch.where(problem.point_valid[:, None, None], Hll_d, eye3)
    Lc = chol3x3(Hll_d)
    Minv = trinv_lower3x3(Lc)

    V = torch.einsum("lkim,ljm->lkij", U, Minv)  # U Lc^{-T}
    Y = torch.einsum("lkp,lkim->plim", O, V)  # scatter by camera, (P, L, 6, 3)
    Y2 = Y.permute(0, 2, 1, 3).reshape(P * 6, L * 3)

    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6
    S_half = -(Y2 @ Y2.T)
    eyeP = torch.eye(P, dtype=dtype, device=dev)
    S_half = S_half + torch.einsum("pij,pq->piqj", Hpp_d, eyeP).reshape(P * 6, P * 6)

    z = torch.einsum("lij,lj->li", Minv, bl)
    y2 = torch.einsum("lmi,lm->li", Minv, z)  # Hll_d^{-1} bl
    Vz = torch.einsum("lkim,lm->lki", U, y2)
    rhs_corr = torch.einsum("lkp,lki->pi", O, Vz).reshape(-1)
    return LocalPieces(S_half=S_half, bp=bp, rhs_corr=rhs_corr, chi2=chi2, U=U,
                       Minv=Minv, bl=bl)


def build_local_pieces(problem: BucketedBAProblem, cam: reproj.Camera, active, robust_delta,
                       mu, groups: Optional[segment.KeyGroups] = None) -> LocalPieces:
    """Everything of one damped step up to the pose solve: K2's reductions
    (its plain version on the CPU) and the sqrt-Schur tail. This is what
    each shard of distributed BA computes. `groups` as in `assemble`."""
    red = assemble(problem, cam, active, robust_delta, groups)
    return _pieces_tail(problem, *red, mu)


def pieces_from_terms(problem: BucketedBAProblem, terms, mu) -> LocalPieces:
    """The same pieces from precomputed edge terms (r, Jp, Jl, w, chi2)."""
    return _pieces_tail(problem, *reductions_from_terms(problem, terms), mu)


def solve_pose_system(S: torch.Tensor, rhs: torch.Tensor, pose_fixed: torch.Tensor):
    """Gauge-fix + dense Cholesky solve of the reduced camera system.
    `cholesky_ex` does not read its info flag back: no host sync."""
    fixed6 = torch.repeat_interleave(pose_fixed, 6)
    S = torch.where(fixed6[:, None] | fixed6[None, :], torch.zeros_like(S), S)
    S = S + torch.diag(fixed6.to(S.dtype))
    rhs = torch.where(fixed6, torch.zeros_like(rhs), rhs)
    Lc = torch.linalg.cholesky_ex(S)[0]
    y = torch.linalg.solve_triangular(Lc, rhs[:, None], upper=False)
    dxp = torch.linalg.solve_triangular(Lc.T, y, upper=True)[:, 0]
    return dxp.reshape(-1, 6)


def back_substitute(pieces: LocalPieces, problem: BucketedBAProblem, dxp):
    """Landmark back-substitution dxl = Hll_d^{-1}(-bl - W^T dxp)."""
    dxp_g = dxp[problem.obs_cam.long()]  # (L, K, 6)
    Wt_dxp = torch.einsum("lkij,lki->lj", pieces.U, dxp_g)
    rhs_l = -pieces.bl - Wt_dxp
    Minv = pieces.Minv
    dxl = torch.einsum("lji,ljk,lk->li", Minv, Minv, rhs_l)
    return torch.where(problem.point_valid[:, None], dxl, torch.zeros_like(dxl))


def _apply_update(problem: BucketedBAProblem, dxp, dxl) -> BucketedBAProblem:
    poses = se3.retract(problem.poses(), dxp)
    free = (~problem.pose_fixed)[:, None]
    new_R = torch.where(free[..., None], poses.R, problem.pose_R)
    new_t = torch.where(free, poses.t, problem.pose_t)
    return problem._replace(pose_R=new_R, pose_t=new_t, points=problem.points + dxl)


def _lm_accept(prob, candidate, chi2, chi2_c, dxp, dxl, bp, bl, mu, nu):
    """Nielsen gain-ratio accept/reject bookkeeping (device tensors only)."""
    dx_all = torch.cat([dxp.reshape(-1), dxl.reshape(-1)])
    b_all = torch.cat([bp.reshape(-1), bl.reshape(-1)])
    predicted = 0.5 * torch.sum(dx_all * (mu * dx_all - b_all))
    rho = (chi2 - chi2_c) / torch.clamp(predicted, min=1e-12)
    accept = (rho > 0) & torch.isfinite(chi2_c)
    prob_new = prob._replace(
        pose_R=torch.where(accept, candidate.pose_R, prob.pose_R),
        pose_t=torch.where(accept, candidate.pose_t, prob.pose_t),
        points=torch.where(accept, candidate.points, prob.points),
    )
    factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    mu_new = torch.where(accept, mu * factor, mu * nu)
    nu_new = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return accept, prob_new, mu_new, nu_new


def _step(prob: BucketedBAProblem, red: assembly.AssemblyOut, mu):
    """Damped step from the carried reductions: (dxp, dxl, bp, bl)."""
    pieces = _pieces_tail(prob, *red, mu)
    rhs = -(pieces.bp.reshape(-1) - pieces.rhs_corr)
    dxp = solve_pose_system(pieces.S_half, rhs, prob.pose_fixed)
    dxp = torch.where(prob.pose_fixed[:, None], torch.zeros_like(dxp), dxp)
    dxl = back_substitute(pieces, prob, dxp)
    return dxp, dxl, red.bp, red.bl


def reduce_and_solve(problem: BucketedBAProblem, cam: reproj.Camera, active, robust_delta,
                     mu):
    """One damped-GN step. Returns (dxp (P,6), dxl (L,3), chi2, bp, bl)."""
    red = assemble(problem, cam, active, robust_delta)
    dxp, dxl, bp, bl = _step(problem, red, mu)
    return dxp, dxl, red.chi2, bp, bl


def _ba_iterate_core(problem: BucketedBAProblem, reduce_fn, num_iters: int):
    """Shared LM loop: carry the reductions of the current point, assemble
    once per iteration, speculatively at the candidate (its chi2 is the
    accept test; on acceptance it becomes the next carry)."""
    red = reduce_fn(problem)
    dtype, dev = problem.points.dtype, problem.points.device
    # Filled on the device: no host-to-device copy (a captured graph has none).
    mu = torch.full((), 1e-3, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    prob = problem
    for _ in range(num_iters):
        dxp, dxl, bp, bl = _step(prob, red, mu)
        candidate = _apply_update(prob, dxp, dxl)
        red_c = reduce_fn(candidate)
        accept, prob, mu, nu = _lm_accept(prob, candidate, red.chi2, red_c.chi2, dxp,
                                          dxl, bp, bl, mu, nu)
        red = assembly.AssemblyOut(*[torch.where(accept, c, o) for c, o in zip(red_c, red)])
        n_acc = n_acc + accept.to(torch.int32)
    return prob, red.chi2, n_acc


def ba_iterate(problem: BucketedBAProblem, cam: reproj.Camera, active, num_iters: int,
               robust_delta: Optional[float]
               ) -> Tuple[BucketedBAProblem, torch.Tensor, torch.Tensor]:
    """Nielsen-damped LM loop; one K2 assembly per iteration. The camera
    grouping of the active slots (K2's camera pass) is built once per call:
    the observation graph does not change inside the loop."""
    groups = camera_groups(problem, active)
    return _ba_iterate_core(
        problem, lambda p: assemble(p, cam, active, robust_delta, groups), num_iters
    )


def local_ba(problem: BucketedBAProblem, cam: reproj.Camera, first_iters: int = 5,
             second_iters: int = 10):
    """Two-phase local BA protocol (5 robust iters -> chi2/depth gate ->
    10 iters). Returns (problem, survivors (L, K), chi2)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, _, _ = ba_iterate(problem, cam, problem.obs_valid, first_iters,
                               robust_delta=delta2)
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    active = problem.obs_valid & (e2 <= gate) & (z > 0)
    problem, chi2, _ = ba_iterate(problem, cam, active, second_iters, robust_delta=None)
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    return problem, survivors, chi2


# ----------------------------------------------------------------------
# Matrix-free Schur + PCG: the whole-map (global BA) path.
#
# At 10^3 keyframes x 10^5 landmarks the dense (P, L, 6, 3) cross factor
# does not fit; S is applied matrix-free: per-landmark K-axis reductions
# plus one camera-keyed sum per matvec.
# ----------------------------------------------------------------------


def chi2_only(problem: BucketedBAProblem, cam: reproj.Camera, active, robust_delta):
    """Robust chi2 at the problem's state: kernel K3 on CUDA, its plain
    version on the CPU."""
    w_active = problem.obs_inv_sigma2 * active.to(problem.points.dtype)
    return assembly.chi2_sum(problem.pose_R, problem.pose_t, problem.points,
                             problem.obs_cam, problem.obs_uvr, w_active, cam, robust_delta)


def camera_groups(problem: BucketedBAProblem, active) -> segment.KeyGroups:
    """The active slots by camera, each camera's in their (L, K) order: the
    table K2's camera pass walks. No host read."""
    return segment.key_groups(problem.obs_cam, problem.num_poses, keep=active)


def pose_plan(problem: BucketedBAProblem, active) -> segment.SegmentPlan:
    """Camera grouping of the active slots (the only slots whose U is
    nonzero), with its compressed form for K2 (`.groups`). Depends on the
    observation graph alone: built once per LM loop (one host read)."""
    return segment.segment_plan(problem.obs_cam, problem.num_poses, keep=active)


def _pose_accumulate(plan: segment.SegmentPlan, X: torch.Tensor) -> torch.Tensor:
    """Sum over slots of X (L, K, D) into their camera rows -> (P, D), in a
    fixed order."""
    return segment.segment_sum(plan, X.reshape(-1, X.shape[-1]))


class CGContext(NamedTuple):
    U: torch.Tensor  # (L, K, 6, 3)
    Minv: torch.Tensor  # (L, 3, 3) Lc^{-1} of the damped Hll
    Hpp_d: torch.Tensor  # (P, 6, 6) damped
    bp: torch.Tensor  # (P, 6)
    bl: torch.Tensor  # (L, 3)
    chi2: torch.Tensor  # () K2's chi2 (diagnostic; the LM test uses K3)


def _cg_context(problem: BucketedBAProblem, cam: reproj.Camera, active, robust_delta,
                mu, plan: Optional[segment.SegmentPlan] = None) -> CGContext:
    """Per-iteration quantities of the matrix-free solve, from K2's
    reductions (the TPU branch of the JAX package builds them from its
    Pallas assembly the same way)."""
    groups = plan.groups if plan is not None else None
    red = assemble(problem, cam, active, robust_delta, groups)
    dtype, dev = red.bl.dtype, red.bl.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    dll = torch.diagonal(red.Hll, dim1=-2, dim2=-1)
    Hll_d = red.Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
    Hll_d = torch.where(problem.point_valid[:, None, None], Hll_d, eye3)
    Minv = trinv_lower3x3(chol3x3(Hll_d))
    dpp = torch.diagonal(red.Hpp, dim1=-2, dim2=-1)
    Hpp_d = red.Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6
    return CGContext(U=red.U, Minv=Minv, Hpp_d=Hpp_d, bp=red.bp, bl=red.bl, chi2=red.chi2)


def _apply_Ainv(Minv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Hll_d^{-1} x = Minv^T (Minv x), batched (L, 3)."""
    return torch.einsum("lji,ljk,lk->li", Minv, Minv, x)


def _pose_gather(obs_cam: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v (P, D) -> (L, K, D) by camera index (a plain gather)."""
    return v[obs_cam.long()]


def _schur_matvec(v, ctx: CGContext, obs_cam, pose_fixed, plan: segment.SegmentPlan):
    """S @ v for v (P, 6), matrix-free: two K-reductions + one camera-keyed
    sum."""
    v = torch.where(pose_fixed[:, None], torch.zeros_like(v), v)
    Wt_v = torch.einsum("lkij,lki->lj", ctx.U, _pose_gather(obs_cam, v))  # (L, 3)
    y = _apply_Ainv(ctx.Minv, Wt_v)
    Uy = torch.einsum("lkij,lj->lki", ctx.U, y)  # (L, K, 6)
    Sv = torch.einsum("pij,pj->pi", ctx.Hpp_d, v) - _pose_accumulate(plan, Uy)
    return torch.where(pose_fixed[:, None], v, Sv)


# Host checks of the PCG stop flag: every this many iterations (read at
# call time).
PCG_CHECK_EVERY = 10


def _pcg(matvec, b, Minv_blocks, pose_fixed, max_iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the reduced camera system; stops at
    ||r|| <= tol ||b|| or after `max_iters`.

    The JAX package runs a device-side `lax.while_loop`. Here a done flag
    freezes x, r, p and rz on the device as soon as the stop test holds, so
    the iterates are exactly the while loop's; the host reads the flag only
    every `PCG_CHECK_EVERY` iterations to leave the loop early (one host
    read per check, counted by `utils.host_reads`). Returns (x, iterations)."""
    check_every = PCG_CHECK_EVERY
    b = torch.where(pose_fixed[:, None], torch.zeros_like(b), b)

    def precond(r):
        return torch.einsum("pij,pj->pi", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    limit = tol * tol * torch.clamp(torch.sum(b * b), min=1e-20)
    done = ~(torch.sum(r * r) > limit)
    n = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(max_iters):
        if k % check_every == 0 and bool(to_host(done)):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.clamp(rz, min=1e-20)
        p_n = z + beta * p
        x = torch.where(done, x, x_n)
        r = torch.where(done, r, r_n)
        p = torch.where(done, p, p_n)
        rz = torch.where(done, rz, rz_n)
        n = n + (~done).to(torch.int32)
        done = done | ~(torch.sum(r * r) > limit)
    return x, n


def cg_reduce_and_solve(problem: BucketedBAProblem, cam: reproj.Camera, active,
                        robust_delta, mu, cg_iters: int = 100, cg_tol: float = 1e-6,
                        plan: Optional[segment.SegmentPlan] = None):
    """One damped-GN step via matrix-free Schur + PCG. The default `cg_tol`
    is a tight solve; the LM loop passes the forcing term 1e-2. `plan` is
    `pose_plan(problem, active)` (built here when absent).

    Returns (dxp (P,6), dxl (L,3), chi2 (K2's), bp, bl, cg_n)."""
    if plan is None:
        plan = pose_plan(problem, active)
    ctx = _cg_context(problem, cam, active, robust_delta, mu, plan)
    dtype, dev = ctx.bp.dtype, ctx.bp.device

    # rhs = -(bp - W Hll_d^{-1} bl), slot-wise.
    y = _apply_Ainv(ctx.Minv, ctx.bl)
    Uy = torch.einsum("lkij,lj->lki", ctx.U, y)
    rhs = -(ctx.bp - _pose_accumulate(plan, Uy))

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag_ok = problem.pose_valid & ~problem.pose_fixed
    M = torch.where(diag_ok[:, None, None], ctx.Hpp_d, eye6)
    Mp = torch.linalg.inv(M + 1e-8 * eye6)

    dxp, cg_n = _pcg(lambda v: _schur_matvec(v, ctx, problem.obs_cam, problem.pose_fixed,
                                             plan),
                     rhs, Mp, problem.pose_fixed, cg_iters, cg_tol)
    dxp = torch.where(problem.pose_fixed[:, None], torch.zeros_like(dxp), dxp)
    Wt_dxp = torch.einsum("lkij,lki->lj", ctx.U, _pose_gather(problem.obs_cam, dxp))
    dxl = _apply_Ainv(ctx.Minv, -ctx.bl - Wt_dxp)
    dxl = torch.where(problem.point_valid[:, None], dxl, torch.zeros_like(dxl))
    return dxp, dxl, ctx.chi2, ctx.bp, ctx.bl, cg_n


def ba_iterate_cg(problem: BucketedBAProblem, cam: reproj.Camera, active, num_iters: int,
                  robust_delta: Optional[float], cg_iters: int = 100
                  ) -> Tuple[BucketedBAProblem, torch.Tensor, torch.Tensor]:
    """LM loop on the matrix-free PCG step (whole-map scale). One K2 launch
    per iteration builds the step; the accept test compares K3's chi2 at
    the candidate with K3's chi2 at the current state."""
    chi2 = chi2_only(problem, cam, active, robust_delta)
    dtype, dev = chi2.dtype, chi2.device
    mu = torch.tensor(1e-3, dtype=dtype, device=dev)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    plan = pose_plan(problem, active)
    prob = problem
    for _ in range(num_iters):
        # Inexact-Newton forcing term: the LM gate bounds step quality.
        dxp, dxl, _, bp, bl, _ = cg_reduce_and_solve(prob, cam, active, robust_delta, mu,
                                                     cg_iters=cg_iters, cg_tol=1e-2,
                                                     plan=plan)
        candidate = _apply_update(prob, dxp, dxl)
        chi2_c = chi2_only(candidate, cam, active, robust_delta)
        accept, prob, mu, nu = _lm_accept(prob, candidate, chi2, chi2_c, dxp, dxl, bp, bl,
                                          mu, nu)
        chi2 = torch.where(accept, chi2_c, chi2)
        n_acc = n_acc + accept.to(torch.int32)
    return prob, chi2, n_acc


def global_ba_cg(problem: BucketedBAProblem, cam: reproj.Camera, num_iters: int = 20):
    """Whole-map global BA on the matrix-free engine: `num_iters` robust LM
    iterations, then the chi2/depth survivor gate. Returns (problem,
    survivors (L, K), chi2)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, chi2, _ = ba_iterate_cg(problem, cam, problem.obs_valid, num_iters,
                                     robust_delta=delta2)
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    return problem, survivors, chi2
