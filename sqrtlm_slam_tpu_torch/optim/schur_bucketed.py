"""Landmark-bucketed sqrt-Schur BA engine: local BA and matrix-free global BA.

Counterpart of `sqrtlm_slam_tpu/optim/schur_bucketed.py` (its XLA-layout
path). Local BA is damped LM with landmark Schur elimination in
square-root form,

    Hll_d = Lc Lc^T          (batched closed-form 3x3 Cholesky)
    V     = U Lc^{-T}        (whitened cross blocks, U = Jp^T w Jl)
    S     = Hpp_d - Y Y^T    (Y: V scattered by camera, never formed)
    rhs   = -(bp - Y (Lc^{-1} bl))

The per-iteration reductions (Hll, bl, U, Hpp, bp, chi2) come from kernel
K2 (`optim/assembly.py`) on CUDA and from its plain version on the CPU.
Y Y^T is summed over each landmark's pairs of valid slots by camera pair
and Y (Lc^{-1} bl) over its slots by camera, in float64 and a fixed
order, each sum rounded once (`_yyt`, `segment.group_sum`): the JAX package's
one-hot (P, L, 6, 3) Y and its Gram are an MXU layout, and at 1,400
keyframes x 280,000 landmarks they would take ~67 GB and ~1.2e14 flop an
LM iteration. The 6P x 6P Cholesky stays `torch.linalg`, as the JAX
package left it to XLA.
The LM loop is a Python loop of `torch.where` selects with no host sync
per iteration. The TPU layouts (rows layout, chunked S-Gram, bf16 Y) are
not ported.

Global BA (`ba_iterate_cg`, `global_ba_cg`) applies the reduced camera
system matrix-free inside a block-Jacobi PCG, with the context built from
K2's `AssemblyOut` and the LM candidate test on K3 (`chi2_only`) at both
ends. Camera-keyed sums go through `segment.segment_sum` (fixed order, no
atomics), so global BA is bitwise repeatable on the card.

On the card each LM iteration of global BA runs as three captured CUDA
graphs (`utils.cache.graphed`; the JAX package compiles the whole
`lax.scan`, `_global_ba_cg_jit`): K2's context and the preconditioner, a
chunk of `PCG_CHECK_EVERY` PCG iterations, and the update with K3 at the
candidate and the gain-ratio test. They are replayed for every iteration of
every `global_ba_cg` call of one run (the camera plan, whose build reads the
device once, is made per call outside the graphs). The PCG stops as the JAX
package's `while_loop` does: a done mask freezes its iterates, and the host
reads the done flag between chunks to leave early. The cg backend's local
BA (`facade.Optimizer("cg")`) replays instances of the same three graphs
of its own (`LOCAL_GRAPHS`), and the flat engine's `schur.ba_iterate_cg`
three graphs of its engine, through the same LM loop (`lm_cg_loop`). The
camera plan is padded (`segment.segment_plan(..., pad=True)`), so that its
shape depends on the pose count and the width's bucket alone.
The preconditioner's block inverses are `torch.linalg.inv_ex` (`inv`'s
bits without its host error check): nothing on this path checks a
factorisation on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..factors import reprojection as reproj
from ..geometry import se3
from ..utils import cache, to_host
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


def _yyt(problem: BucketedBAProblem, V: torch.Tensor) -> torch.Tensor:
    """Y Y^T (6P, 6P) of the sqrt-Schur tail without forming Y. Y's column
    block of landmark l holds, at camera c, the sum Vc of V over l's valid
    slots on c (the JAX package's one-hot scatter); here that sum sits at
    the first of those slots. Over each landmark's pairs of such slots
    a <= b, the products Vc_a Vc_b^T are summed by camera pair (a < b, block
    (c_a, c_b)) and by camera (a = b) in a fixed order (`segment.group_sum`),
    and Y Y^T is the cross sums C plus C^T plus the block diagonal of the
    self sums. Vc, the products and the sums are float64 from V's values;
    C and the self sums are each rounded to V's dtype once, so that each
    is its exact value rounded (up to float64 rounding) whatever the order
    of its terms (a shard's landmarks sum in another order than the whole
    map's), and added in V's dtype."""
    P = problem.num_poses
    L, K = problem.obs_cam.shape
    f64 = torch.float64
    cam, valid = problem.obs_cam.long(), problem.obs_valid
    same = valid[:, :, None] & valid[:, None, :] & (cam[:, :, None] == cam[:, None, :])
    earlier = torch.ones(K, K, dtype=torch.bool, device=V.device).tril(-1)
    first = valid & ~(same & earlier).any(-1)  # no earlier valid slot on its camera
    Vc = torch.einsum("lab,lbx->lax", same.to(f64), V.reshape(L, K, 18).to(f64))
    Vc = Vc.reshape(L * K, 6, 3)
    a, b = torch.triu_indices(K, K, device=V.device)  # slot pairs a <= b
    ca, cb = cam[:, a], cam[:, b]
    keys = torch.where(a == b, P * P + ca, ca * P + cb)  # (L, pairs)
    groups = segment.key_groups(keys, P * P + P, keep=first[:, a] & first[:, b])

    def rows(i):  # i = l * pairs + pair: Vc_a Vc_b^T, three products a row
        l, n = i // a.shape[0], i % a.shape[0]
        A, B = Vc[l * K + a[n]], Vc[l * K + b[n]]
        X = A[:, :, None, 0] * B[:, None, :, 0]
        X.addcmul_(A[:, :, None, 1], B[:, None, :, 1])
        X.addcmul_(A[:, :, None, 2], B[:, None, :, 2])
        return X.reshape(-1, 36)

    sums = segment.group_sum(groups, rows)
    C = sums[:P * P].reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    eyeP = torch.eye(P, dtype=f64, device=V.device)
    D = torch.einsum("pij,pq->piqj", sums[P * P:].reshape(P, 6, 6), eyeP).reshape(P * 6, P * 6)
    C, D = C.to(V.dtype), D.to(V.dtype)
    return C + C.T + D


def _pieces_tail(problem: BucketedBAProblem, Hll, bl, U, Hpp, bp, chi2, mu) -> LocalPieces:
    """Damping + sqrt-Schur factors from the assembled reductions. The
    JAX package scatters V by camera into a one-hot (P, L, 6, 3) Y and
    forms S from Y Y^T (an MXU layout); here the same sums run over each
    landmark's slot pairs (`_yyt`) and rhs_corr's over its slots,
    by camera in a fixed order: no tensor holds both a pose and a
    landmark axis."""
    P = problem.num_poses
    dtype, dev = bl.dtype, bl.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_d = Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
    Hll_d = torch.where(problem.point_valid[:, None, None], Hll_d, eye3)
    Lc = chol3x3(Hll_d)
    Minv = trinv_lower3x3(Lc)

    V = torch.einsum("lkim,ljm->lkij", U, Minv)  # U Lc^{-T}

    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6
    eyeP = torch.eye(P, dtype=dtype, device=dev)
    S_half = -_yyt(problem, V) + torch.einsum("pij,pq->piqj", Hpp_d, eyeP).reshape(P * 6, P * 6)

    z = torch.einsum("lij,lj->li", Minv, bl)
    y2 = torch.einsum("lmi,lm->li", Minv, z)  # Hll_d^{-1} bl
    Vz = torch.einsum("lkim,lm->lki", U, y2)
    cams = segment.key_groups(problem.obs_cam, P, keep=problem.obs_valid)
    rhs_corr = segment.group_sum(cams, Vz.reshape(-1, 6).to(torch.float64).__getitem__)
    rhs_corr = rhs_corr.to(dtype).reshape(-1)
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
    observation graph alone: built once per LM loop (one host read).
    Padded: every camera listed, the width bucketed, so that a local
    window's plan has the shape of the pose cap and the width's bucket."""
    return segment.segment_plan(problem.obs_cam, problem.num_poses, keep=active, pad=True)


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
# call time). On the card global BA's PCG runs this many iterations a
# graph replay, with the flag read between replays; the alternative, all
# `cg_iters` iterations under the done mask in the LM iteration's graph
# with no read, gives the same bits and was 7-12 % slower at 600 keyframes
# on the H100; at 69 its replays were faster, but its larger capture cost
# more than they gained in a loop closure's global BA (PERF.md section 6).
PCG_CHECK_EVERY = 10


class PCGState(NamedTuple):
    """The PCG's iterates; `done` freezes x, r, p and rz once the stop test
    holds, so further iterations leave them as the while loop leaves them."""

    x: torch.Tensor  # (P, 6)
    r: torch.Tensor  # (P, 6)
    p: torch.Tensor  # (P, 6)
    rz: torch.Tensor  # ()
    done: torch.Tensor  # () bool
    n: torch.Tensor  # () int32 iterations run before done
    limit: torch.Tensor  # () tol^2 ||b||^2
    limit64: torch.Tensor  # () the same in float64


def _converged(r, limit, limit64):
    """The stop test ||r||^2 <= limit, in r's dtype where ||r||^2 and the
    limit are finite there, else in float64: a right-hand side past ~1e19
    (a landmark hundreds of km out) overflows the float32 squares, and
    `~(inf > inf)` read done before the first iteration."""
    rr = torch.sum(r * r)
    rr64 = torch.sum(torch.square(r.double()))
    return torch.where(torch.isfinite(rr) & torch.isfinite(limit), ~(rr > limit),
                       ~(rr64 > limit64))


def _pcg_start(b, Minv_blocks, pose_fixed, tol: float) -> PCGState:
    b = torch.where(pose_fixed[:, None], torch.zeros_like(b), b)
    z = torch.einsum("pij,pj->pi", Minv_blocks, b)
    r = b
    limit = tol * tol * torch.clamp(torch.sum(b * b), min=1e-20)
    limit64 = tol * tol * torch.clamp(torch.sum(torch.square(b.double())), min=1e-20)
    return PCGState(x=torch.zeros_like(b), r=r, p=z, rz=torch.sum(r * z),
                    done=_converged(r, limit, limit64),
                    n=torch.zeros((), dtype=torch.int32, device=b.device), limit=limit,
                    limit64=limit64)


def _pcg_iterations(matvec, Minv_blocks, s: PCGState, steps: int) -> PCGState:
    """`steps` masked PCG iterations from `s`, with no read."""
    x, r, p, rz, done, n, limit, limit64 = s
    for _ in range(steps):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = torch.einsum("pij,pj->pi", Minv_blocks, r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.clamp(rz, min=1e-20)
        p_n = z + beta * p
        x = torch.where(done, x, x_n)
        r = torch.where(done, r, r_n)
        p = torch.where(done, p, p_n)
        rz = torch.where(done, rz, rz_n)
        n = n + (~done).to(torch.int32)
        done = done | _converged(r, limit, limit64)
    return PCGState(x, r, p, rz, done, n, limit, limit64)


def _pcg_run(chunk, s: PCGState, max_iters: int, check_every: int) -> PCGState:
    """Run `chunk(state, steps)` up to `max_iters` iterations in all, reading
    the done flag before each chunk of `check_every` (one counted host read
    each)."""
    k = 0
    while k < max_iters and not bool(to_host(s.done)):
        steps = min(check_every, max_iters - k)
        s = chunk(s, steps)
        k += steps
    return s


class CGHead(NamedTuple):
    """An LM iteration's matrix-free system, ready for the PCG."""

    ctx: CGContext
    Mp: torch.Tensor  # (P, 6, 6) block-Jacobi preconditioner
    pcg: PCGState  # the PCG's start


def _cg_head(problem: BucketedBAProblem, active, mu, plan: segment.SegmentPlan,
             cam: reproj.Camera, robust_delta, tol: float) -> CGHead:
    """K2's context, the right-hand side and the preconditioner of one
    damped step. `torch.linalg.inv_ex` gives `inv`'s bits without its host
    error check. The first of the three graphs of global BA's LM iteration
    (`_lm_step`)."""
    ctx = _cg_context(problem, cam, active, robust_delta, mu, plan)
    dtype, dev = ctx.bp.dtype, ctx.bp.device
    # rhs = -(bp - W Hll_d^{-1} bl), slot-wise.
    y = _apply_Ainv(ctx.Minv, ctx.bl)
    Uy = torch.einsum("lkij,lj->lki", ctx.U, y)
    rhs = -(ctx.bp - _pose_accumulate(plan, Uy))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag_ok = problem.pose_valid & ~problem.pose_fixed
    M = torch.where(diag_ok[:, None, None], ctx.Hpp_d, eye6)
    Mp = torch.linalg.inv_ex(M + 1e-8 * eye6)[0]
    return CGHead(ctx=ctx, Mp=Mp, pcg=_pcg_start(rhs, Mp, problem.pose_fixed, tol))


def _pcg_chunk(ctx: CGContext, Mp, obs_cam, pose_fixed, plan: segment.SegmentPlan,
               s: PCGState, steps: int) -> PCGState:
    """`steps` PCG iterations on the system of `ctx` (global BA's second
    graph)."""
    return _pcg_iterations(lambda v: _schur_matvec(v, ctx, obs_cam, pose_fixed, plan), Mp, s,
                           steps)


def _cg_back_substitute(problem: BucketedBAProblem, ctx: CGContext, x):
    """(dxp, dxl) from the PCG's pose step."""
    dxp = torch.where(problem.pose_fixed[:, None], torch.zeros_like(x), x)
    Wt_dxp = torch.einsum("lkij,lki->lj", ctx.U, _pose_gather(problem.obs_cam, dxp))
    dxl = _apply_Ainv(ctx.Minv, -ctx.bl - Wt_dxp)
    dxl = torch.where(problem.point_valid[:, None], dxl, torch.zeros_like(dxl))
    return dxp, dxl


def cg_reduce_and_solve(problem: BucketedBAProblem, cam: reproj.Camera, active,
                        robust_delta, mu, cg_iters: int = 100, cg_tol: float = 1e-6,
                        plan: Optional[segment.SegmentPlan] = None):
    """One damped-GN step via matrix-free Schur + PCG. The default `cg_tol`
    is a tight solve; the LM loop passes the forcing term 1e-2. `plan` is
    `pose_plan(problem, active)` (built here when absent).

    Returns (dxp (P,6), dxl (L,3), chi2 (K2's), bp, bl, cg_n)."""
    if plan is None:
        plan = pose_plan(problem, active)
    head = _cg_head(problem, active, mu, plan, cam, robust_delta, cg_tol)
    s = _pcg_run(lambda st, steps: _pcg_chunk(head.ctx, head.Mp, problem.obs_cam,
                                              problem.pose_fixed, plan, st, steps),
                 head.pcg, cg_iters, PCG_CHECK_EVERY)
    dxp, dxl = _cg_back_substitute(problem, head.ctx, s.x)
    return dxp, dxl, head.ctx.chi2, head.ctx.bp, head.ctx.bl, s.n


class LMState(NamedTuple):
    """The carry of global BA's LM loop after one iteration."""

    pose_R: torch.Tensor
    pose_t: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor  # K3's chi2 at the kept state
    mu: torch.Tensor
    nu: torch.Tensor
    accept: torch.Tensor  # () bool


def _lm_tail(problem: BucketedBAProblem, ctx: CGContext, x, chi2, mu, nu, active,
             cam: reproj.Camera, robust_delta) -> LMState:
    """Back-substitution, the candidate, K3 at the candidate and the gain-ratio
    test (global BA's third graph)."""
    dxp, dxl = _cg_back_substitute(problem, ctx, x)
    return lm_test(problem, dxp, dxl, chi2, mu, nu, ctx.bp, ctx.bl,
                   lambda c: chi2_only(c, cam, active, robust_delta))


def lm_test(problem, dxp, dxl, chi2, mu, nu, bp, bl, chi2_at: Callable) -> LMState:
    """The candidate, its chi2 (`chi2_at(candidate)`) and the gain-ratio
    test: the end of an LM iteration's last graph, in both engines."""
    candidate = _apply_update(problem, dxp, dxl)
    chi2_c = chi2_at(candidate)
    accept, prob, mu, nu = _lm_accept(problem, candidate, chi2, chi2_c, dxp, dxl, bp, bl,
                                      mu, nu)
    return LMState(prob.pose_R, prob.pose_t, prob.points, torch.where(accept, chi2_c, chi2),
                   mu, nu, accept)


# Global BA's graphs (`utils.cache`). The problem's shapes change with every
# loop closure, and one run of global BA has one key a graph: only the
# newest capture is kept.
_cg_head_jit = cache.graphed(_cg_head, static_argnames=("cam", "robust_delta", "tol"),
                             max_entries=1)
_pcg_chunk_jit = cache.graphed(_pcg_chunk, static_argnames=("steps",), max_entries=1)
_lm_tail_jit = cache.graphed(_lm_tail, static_argnames=("cam", "robust_delta"),
                             max_entries=1)
# The cg backend's local BA (`facade.Optimizer("cg")`) replays graphs of its
# own, so that local and global BA never evict each other's captures. Its
# windows have the shapes of `LocalMappingConfig` and a padded camera plan:
# a key per phase (robust and not) and camera-width bucket. A 40-frame
# KITTI-size run's 6 windows made at most 2 keys a graph, all in the first
# window (chip_smoke.py phase 16); the bound leaves room for one bucket
# crossing, as the flat engine's plans made in that run
# (`schur.LOCAL_CAPTURES`).
LOCAL_CG_CAPTURES = 4
_local_cg_head_jit = cache.graphed(_cg_head, static_argnames=("cam", "robust_delta", "tol"),
                                   max_entries=LOCAL_CG_CAPTURES)
_local_pcg_chunk_jit = cache.graphed(_pcg_chunk, static_argnames=("steps",),
                                     max_entries=LOCAL_CG_CAPTURES)
_local_lm_tail_jit = cache.graphed(_lm_tail, static_argnames=("cam", "robust_delta"),
                                   max_entries=LOCAL_CG_CAPTURES)
GLOBAL_GRAPHS = (_cg_head_jit, _pcg_chunk_jit, _lm_tail_jit)
LOCAL_GRAPHS = (_local_cg_head_jit, _local_pcg_chunk_jit, _local_lm_tail_jit)


class CGSteps(NamedTuple):
    """One engine's LM iteration on the PCG step as three calls, each a
    captured graph on the card: `head(problem, mu)` builds the damped
    system and the PCG's start (a `CGHead`), `chunk(problem, head, state,
    steps)` runs `steps` PCG iterations, and `tail(problem, head, x, chi2,
    mu, nu)` back-substitutes and tests the step (an `LMState`)."""

    head: Callable
    chunk: Callable
    tail: Callable


def lm_cg_step(steps: CGSteps, problem, chi2, mu, nu, cg_iters: int) -> LMState:
    """One LM iteration: the head, `steps.chunk` replayed once every
    `PCG_CHECK_EVERY` PCG iterations until the done flag reads true (or
    `cg_iters`), and the tail."""
    head = steps.head(problem, mu)
    s = _pcg_run(lambda st, n: steps.chunk(problem, head, st, n), head.pcg, cg_iters,
                 PCG_CHECK_EVERY)
    return steps.tail(problem, head, s.x, chi2, mu, nu)


def lm_cg_loop(steps: CGSteps, problem, chi2, num_iters: int, cg_iters: int):
    """The LM loop on the PCG step of both engines: `num_iters` iterations
    from `chi2` (the start's), mu = 1e-3 and nu = 2 (Nielsen). Returns
    (problem, chi2, accepted count)."""
    mu = torch.full_like(chi2, 1e-3)
    nu = torch.full_like(chi2, 2.0)
    n_acc = torch.zeros((), dtype=torch.int32, device=chi2.device)
    for _ in range(num_iters):
        s = lm_cg_step(steps, problem, chi2, mu, nu, cg_iters)
        problem = problem._replace(pose_R=s.pose_R, pose_t=s.pose_t, points=s.points)
        chi2, mu, nu = s.chi2, s.mu, s.nu
        n_acc = n_acc + s.accept.to(torch.int32)
    return problem, chi2, n_acc


def _cg_steps(graphs: tuple, active, plan: segment.SegmentPlan, cam: reproj.Camera,
              robust_delta) -> CGSteps:
    """This engine's `CGSteps` through `graphs` (`GLOBAL_GRAPHS` or
    `LOCAL_GRAPHS`) with the inexact-Newton forcing term 1e-2: the LM gate
    bounds step quality."""
    head, chunk, tail = graphs
    return CGSteps(
        head=lambda prob, mu: head(prob, active, mu, plan, cam=cam, robust_delta=robust_delta,
                                   tol=1e-2),
        chunk=lambda prob, h, s, n: chunk(h.ctx, h.Mp, prob.obs_cam, prob.pose_fixed, plan, s,
                                          steps=n),
        tail=lambda prob, h, x, chi2, mu, nu: tail(prob, h.ctx, x, chi2, mu, nu, active,
                                                   cam=cam, robust_delta=robust_delta))


def _lm_step(problem: BucketedBAProblem, chi2, mu, nu, active, plan: segment.SegmentPlan,
             cam: reproj.Camera, robust_delta, cg_iters: int, graphs: tuple) -> LMState:
    """One LM iteration of global BA with the forcing term 1e-2: K2 (through
    `_cg_context`), the PCG, the update, K3 at the candidate and the
    gain-ratio test, through `graphs` (`GLOBAL_GRAPHS` or `LOCAL_GRAPHS`;
    eager on the CPU). The counterpart of one step of the `lax.scan` that
    the JAX package's `_global_ba_cg_jit` (`optim/schur_bucketed.py`)
    compiles."""
    return lm_cg_step(_cg_steps(graphs, active, plan, cam, robust_delta), problem, chi2, mu,
                      nu, cg_iters)


def ba_iterate_cg(problem: BucketedBAProblem, cam: reproj.Camera, active, num_iters: int,
                  robust_delta: Optional[float], cg_iters: int = 100
                  ) -> Tuple[BucketedBAProblem, torch.Tensor, torch.Tensor]:
    """LM loop on the matrix-free PCG step (whole-map scale). One K2 launch
    per iteration builds the step; the accept test compares K3's chi2 at
    the candidate with K3's chi2 at the current state. The camera plan is
    built once per call (one host read); each iteration is `lm_cg_step`
    through global BA's graphs."""
    return _ba_iterate_cg(problem, cam, active, num_iters, robust_delta, cg_iters,
                          GLOBAL_GRAPHS)


def _ba_iterate_cg(problem: BucketedBAProblem, cam: reproj.Camera, active, num_iters: int,
                   robust_delta: Optional[float], cg_iters: int, graphs: tuple):
    """`ba_iterate_cg` through `graphs` (the cg backend's local BA passes
    `LOCAL_GRAPHS`)."""
    steps = _cg_steps(graphs, active, pose_plan(problem, active), cam, robust_delta)
    return lm_cg_loop(steps, problem, chi2_only(problem, cam, active, robust_delta), num_iters,
                      cg_iters)


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
