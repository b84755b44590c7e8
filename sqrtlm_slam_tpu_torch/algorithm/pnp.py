"""Robust camera-pose estimation from 2D/3D matches: batched RANSAC.

Counterpart of `sqrtlm_slam_tpu/algorithm/pnp.py`, used by relocalisation
and as the no-prior fallback in tracking. Two estimators, each one batched
computation over H hypotheses with no host round trip:

  * `ransac_pose_3d3d`: where the frame keypoint carries depth, each match
    is a 3D-3D pair and the minimal solver is Horn's closed form (the
    port's batched `align.umeyama`, one batched 3x3 SVD);
  * `ransac_pnp_2d3d`: 6-point DLT resections (one batched 12x12 SVD), a
    row-weighted DLT refit on the consensus set and five Gauss-Newton steps.

Verification is the reprojection chi2 gate (9.21), and the refit is kept
when it has at least as many inliers. The SVDs are `geometry/jacobi.py`'s
and the solves `solve_ex`: nothing reads the device, so both banks run
inside `tracking.recover_pose_no_prior`'s captured graph. The minimal sets
are a masked Gumbel top-k (`ransac.top_k_sets`) of uniform draws taken
from an explicit `torch.Generator` before any graph; `sel` takes the sets
from the caller instead, which lets a parity test feed the JAX package's own
draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..factors import reprojection as reproj
from ..factors.reprojection import Camera
from ..geometry import align, jacobi, se3
from .ransac import minimal_sets, row

CHI2_PNP = 9.210  # PnP / Sim3 inlier gate (chi2, 2 dof, at 0.01)
NUM_HYPOTHESES = 256  # minimal sets a bank


class PnPResult(NamedTuple):
    pose: se3.SE3  # T_cw
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # ()


def _dlt_pose(X_w: torch.Tensor, uv_n: torch.Tensor, row_w: Optional[torch.Tensor] = None):
    """Linear camera resection (DLT) in normalized image coordinates,
    batched over leading dimensions.

    X_w (..., N, 3), uv_n (..., N, 2) with K removed, row_w (..., N) optional
    row weights. Returns (R (..., 3, 3), t (..., 3)): the null vector of the
    (2N, 12) system, its sign chosen for det > 0, its rotation part replaced
    by the nearest rotation."""
    ones = torch.ones_like(X_w[..., :1])
    Xh = torch.cat([X_w, ones], dim=-1)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -uv_n[..., :1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -uv_n[..., 1:2] * Xh], dim=-1)
    if row_w is not None:
        r1 = r1 * row_w[..., None]
        r2 = r2 * row_w[..., None]
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 12)
    Pm = jacobi.null_vector(A).reshape(A.shape[:-2] + (3, 4))
    # P and -P project identically: take det(M) > 0, so that the nearest
    # orthonormal factor is a proper rotation.
    sgn = torch.sign(jacobi.det3(Pm[..., :3]))
    Pm = Pm * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None, None]
    U, D, V2 = jacobi.svd3(Pm[..., :3])
    R = U @ V2.mT
    scale = 3.0 / torch.clamp(torch.sum(D, dim=-1), min=1e-12)
    return R, Pm[..., 3] * scale[..., None]


def _gate(R, t, points_w, uv, valid, inv_sigma2, cam: Camera):
    """Reprojection chi2 gate of poses (..., 3, 3), (..., 3) over (N,) matches."""
    x_c = torch.einsum("...ij,nj->...ni", R, points_w) + t[..., None, :]
    e2 = torch.sum((cam.project(x_c) - uv) ** 2, dim=-1) * inv_sigma2
    return (e2 < CHI2_PNP) & valid & (x_c[..., 2] > 0.1)


def _select(use: torch.Tensor, a: se3.SE3, b: se3.SE3, in_a, in_b) -> PnPResult:
    inl = torch.where(use, in_a, in_b)
    return PnPResult(pose=se3.SE3(torch.where(use, a.R, b.R), torch.where(use, a.t, b.t)),
                     inliers=inl, num_inliers=torch.sum(inl))


def ransac_pnp_2d3d(points_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                    inv_sigma2: torch.Tensor, cam: Camera, num_hypotheses: int = NUM_HYPOTHESES,
                    generator: Optional[torch.Generator] = None,
                    sel: Optional[torch.Tensor] = None) -> PnPResult:
    """2D-3D RANSAC resection (no depth needed). points_w (N, 3) landmark
    world positions, uv (N, 2) observed pixels; `sel` (H, 6) replaces the
    random minimal sets when given."""
    if sel is None:
        sel = minimal_sets(valid, num_hypotheses, generator, k=6)
    sel = sel.long()
    uv_n = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], dim=-1)

    Rs, ts = _dlt_pose(points_w[sel], uv_n[sel])
    ok = _gate(Rs, ts, points_w, uv, valid, inv_sigma2, cam)
    counts = torch.sum(ok, dim=-1)
    finite = torch.isfinite(Rs).all(dim=-1).all(dim=-1) & torch.isfinite(ts).all(dim=-1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts)  # first maximum
    inliers = row(ok, best)

    # Consensus refit: row-weighted DLT, then a short Gauss-Newton polish
    # (the DLT's algebraic error is biased).
    R_f, t_f = _dlt_pose(points_w, uv_n, row_w=inliers.to(points_w.dtype))
    pose_f = se3.SE3(R_f, t_f)
    w = inliers.to(points_w.dtype) * inv_sigma2
    eye = 1e-6 * torch.eye(6, dtype=points_w.dtype, device=points_w.device)
    for _ in range(5):
        r, J, _ = reproj.mono_residual_jac(pose_f, points_w, uv, cam)
        H = torch.einsum("nki,n,nkj->ij", J, w, J) + eye
        b = torch.einsum("nki,n,nk->i", J, w, r)
        # solve_ex: a singular system gives non-finite values (caught below)
        # and no error check reads the device.
        pose_f = se3.retract(pose_f, -torch.linalg.solve_ex(H, b)[0])

    in_f = _gate(pose_f.R, pose_f.t, points_w, uv, valid, inv_sigma2, cam)
    use_f = ((torch.sum(in_f) >= torch.sum(inliers)) & torch.isfinite(pose_f.R).all()
             & torch.isfinite(pose_f.t).all())
    return _select(use_f, pose_f, se3.SE3(row(Rs, best), row(ts, best)), in_f, inliers)


def ransac_pose_3d3d(points_w: torch.Tensor, points_c: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, inv_sigma2: torch.Tensor, cam: Camera,
                     num_hypotheses: int = NUM_HYPOTHESES,
                     generator: Optional[torch.Generator] = None,
                     sel: Optional[torch.Tensor] = None) -> PnPResult:
    """Estimate T_cw with points_c ~ T_cw * points_w: batched-hypothesis
    RANSAC with reprojection verification and a weighted Horn refit on the
    consensus set. `sel` (H, 3) replaces the random minimal sets when given."""
    if sel is None:
        sel = minimal_sets(valid, num_hypotheses, generator, k=3)
    sel = sel.long()
    T_h = align.umeyama(points_w[sel], points_c[sel], with_scale=False)
    ok = _gate(T_h.R, T_h.t, points_w, uv, valid, inv_sigma2, cam)
    best = torch.argmax(torch.sum(ok, dim=-1))  # first maximum
    inliers = row(ok, best)

    T_fit = align.umeyama(points_w, points_c, weights=inliers.to(points_w.dtype),
                          with_scale=False)
    in_f = _gate(T_fit.R, T_fit.t, points_w, uv, valid, inv_sigma2, cam)
    use_fit = torch.sum(in_f) >= torch.sum(inliers)
    return _select(use_fit, se3.SE3(T_fit.R, T_fit.t),
                   se3.SE3(row(T_h.R, best), row(T_h.t, best)), in_f, inliers)
