"""Monocular two-view initialization: batched H/F RANSAC + model selection.

Counterpart of `sqrtlm_slam_tpu/pipeline/initializer.py` (ORB-SLAM's
`Initializer`): both hypothesis banks are batched computations on the
matches' device:

  * fundamental: normalized 8-point solves, one per minimal set;
  * homography: normalized 4-point DLT solves;
  * symmetric-transfer scoring with the chi-square gates 3.841 / 5.991 and
    the score offset 5.991; the best hypothesis of each bank is refit on its
    inliers and the refit kept when it scores higher;
  * model selection SH / (SH + SF) > 0.40;
  * motion recovery: the 4 (R, t) candidates of the essential matrix or the
    8 of the homography's SVD decomposition, each cheirality-checked by
    batched DLT triangulation at once.

The null vector of each (8, 9) system is the last right singular vector of
the system padded with a zero row to (9, 9) (a square batched SVD; the
padding keeps the null space). Its sign is arbitrary, and F and -F score
alike. Singular homography hypotheses are inverted with `inv_ex`: no error
check (no host read), and their non-finite transfer errors fail the gates.

The minimal sets are a masked Gumbel top-k drawn from an explicit
`torch.Generator` (`sim3_solver.minimal_sets`), or given by the caller as
`sel_F` (H, 8) / `sel_H` (H, 4), which lets a parity test score the JAX
package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..factors.reprojection import Camera
from ..geometry import se3
from ..loop.sim3_solver import minimal_sets
from .triangulation import _K, _dlt_triangulate

CHI2_F = 3.841  # 1-dof gate (point-line)
CHI2_H = 5.991  # 2-dof gate (point-point)


class InitResult(NamedTuple):
    success: torch.Tensor  # () bool
    T_21: se3.SE3  # pose of view 2 w.r.t. view 1 (world = cam1), unit-norm t
    points_w: torch.Tensor  # (N, 3) triangulated points (world = cam1 frame)
    good: torch.Tensor  # (N,) bool inlier + cheirality mask
    used_homography: torch.Tensor  # () bool


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _normalize(xy: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization (mean 0, mean abs dev 1) as an affine T."""
    w = valid.to(xy.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(xy * w[:, None], dim=0) / n
    d = torch.sum(torch.abs(xy - mu) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(d, min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mu[0] * s[0]]),
                     torch.stack([zero, s[1], -mu[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (xy - mu) * s, T


def _f_rows(x1n, x2n):
    """(..., N, 9) rows of the epipolar constraint x2^T F x1 = 0."""
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _h_rows(x1n, x2n):
    """(..., 2N, 9) DLT rows of x2 ~ H x1."""
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    zero, one = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., 8, 9) -> (..., 3, 3): the right singular vector of the smallest
    singular value, from the square system padded with a zero row."""
    A9 = torch.cat([A, torch.zeros_like(A[..., :1, :])], dim=-2)
    return torch.linalg.svd(A9).Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, D, Vh = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return U @ (D[..., :, None] * Vh)


def _eight_point_F(x1n, x2n):
    """(..., 8, 2) x 2 -> F (..., 3, 3) in normalized coords (smallest
    singular vector + rank-2 projection)."""
    return _rank2(_null_vector(_f_rows(x1n, x2n)))


def _four_point_H(x1n, x2n):
    """(..., 4, 2) x 2 -> H (..., 3, 3) by DLT in normalized coords."""
    return _null_vector(_h_rows(x1n, x2n))


def _fit_F_masked(x1n, x2n, mask):
    """LS 8-point fit over all inlier rows (masked-out rows zeroed)."""
    A = _f_rows(x1n, x2n) * mask[:, None].to(x1n.dtype)
    Vh = torch.linalg.svd(A, full_matrices=False).Vh
    return _rank2(Vh[-1].reshape(3, 3))


def _fit_H_masked(x1n, x2n, mask):
    """LS DLT homography fit over all inlier rows."""
    m = mask.to(x1n.dtype)
    A = _h_rows(x1n, x2n) * torch.cat([m, m])[:, None]
    return torch.linalg.svd(A, full_matrices=False).Vh[-1].reshape(3, 3)


def _apply(M: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """Rows of (N, 3) points through (..., 3, 3) matrices: (..., N, 3)."""
    return torch.sum(M[..., None, :, :] * xh[:, None, :], dim=-1)


def _score_F(F, x1, x2, valid, sigma2=1.0):
    """Symmetric epipolar-distance score of (..., 3, 3) F: (score (...,),
    inlier mask (..., N))."""
    x1h, x2h = _homogeneous(x1), _homogeneous(x2)
    l2 = _apply(F, x1h)  # lines in image 2
    l1 = _apply(F.transpose(-1, -2), x2h)  # lines in image 1
    d2 = torch.sum(x2h * l2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(x1h * l1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    c1, c2 = d1 / sigma2, d2 / sigma2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    zero = torch.zeros_like(c1)
    score = torch.sum(torch.where(valid & (c1 < CHI2_F), CHI2_H - c1, zero)
                      + torch.where(valid & (c2 < CHI2_F), CHI2_H - c2, zero), dim=-1)
    return score, ok


def _score_H(H, x1, x2, valid, sigma2=1.0):
    """Symmetric transfer-error score of (..., 3, 3) H."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def terr(M, a, b):
        p = _apply(M, _homogeneous(a))
        w = p[..., 2:]
        p = p[..., :2] / torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))
        return torch.sum((p - b) ** 2, dim=-1)

    c1 = terr(Hinv, x2, x1) / sigma2
    c2 = terr(H, x1, x2) / sigma2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    zero = torch.zeros_like(c1)
    score = torch.sum(torch.where(valid & (c1 < CHI2_H), CHI2_H - c1, zero)
                      + torch.where(valid & (c2 < CHI2_H), CHI2_H - c2, zero), dim=-1)
    return score, ok


def _check_RT(R, t, x1, x2, valid, cam: Camera, sigma2=4.0):
    """Triangulate under (..., 3, 3) R and (..., 3) t and count the good
    points. Returns (n_good (...,), parallax_deg (...,), X (..., N, 3),
    good (..., N))."""
    K = _K(cam, x1)
    eye_0 = torch.cat([torch.eye(3, dtype=x1.dtype, device=x1.device),
                       torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], dim=-1)
    P1 = K @ eye_0
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = _dlt_triangulate(x1, x2, P1, P2)
    z1 = X[..., 2]
    x_c2 = torch.sum(R[..., None, :, :] * X[..., None, :], dim=-1) + t[..., None, :]
    z2 = x_c2[..., 2]
    # Parallax between the rays from both camera centres.
    C2 = -torch.sum(R * t[..., :, None], dim=-2)  # -R^T t
    r1, r2 = X, X - C2[..., None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / (torch.linalg.norm(r1, dim=-1)
                                         * torch.linalg.norm(r2, dim=-1) + 1e-9)

    def reproj(xc, z):
        return torch.sum(xc[..., None, :] * K, dim=-1)[..., :2] / torch.clamp(z, min=1e-9)[..., None]

    e1 = torch.sum((reproj(X, z1) - x1) ** 2, dim=-1)
    e2 = torch.sum((reproj(x_c2, z2) - x2) ** 2, dim=-1)
    good = (valid & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < sigma2) & (e2 < sigma2)
            & torch.isfinite(X).all(dim=-1))
    # The 50th-smallest parallax cosine among the good points is the quality
    # signal (1.0, i.e. no parallax, fills the others).
    cosp_good = torch.where(good, cosp, torch.ones_like(cosp))
    kth = torch.sort(cosp_good, dim=-1).values[..., min(50, cosp.shape[-1] - 1)]
    par = torch.rad2deg(torch.arccos(torch.clamp(kth, -1.0, 1.0)))
    return torch.sum(good, dim=-1), par, X, good


def _decompose_E(E):
    """E -> 4 (R, t) candidates: (4, 3, 3), (4, 3)."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H, K):
    """Faugeras SVD homography decomposition -> 8 (R, t) candidates:
    (8, 3, 3), (8, 3); the d' = d2 case first, then d' = -d2."""
    A = torch.linalg.inv_ex(K)[0] @ H @ K
    U, w, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = w[0], w[1], w[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    cross = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H.dtype, device=H.device)
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    def candidates(c, sn, flip, tp):
        # Rp = [[c, 0, -flip sn], [0, flip, 0], [sn, 0, flip c]] per case.
        Rp = torch.stack([torch.stack([c * one, zero, -flip * sn], -1),
                          torch.stack([zero, flip * one, zero], -1),
                          torch.stack([sn, zero, flip * c * one], -1)], -2)
        R = s * (U @ Rp @ Vh)
        t = torch.sum(U * tp[:, None, :], dim=-1)  # U @ tp
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-9)

    # d' = d2: Rp = [[ct, 0, -st], [0, 1, 0], [st, 0, ct]], tp = (d1 - d3) [x1, 0, -x3].
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / den_p
    Rp_pos, tp_pos = candidates(ct, sign * cross / den_p, 1.0,
                                (d1 - d3) * torch.stack([x1s, zero, -x3s], -1))
    # d' = -d2: Rp = [[cp, 0, sp], [0, -1, 0], [sp, 0, -cp]], tp = (d1 + d3) [x1, 0, x3].
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / den_n
    Rp_neg, tp_neg = candidates(cp, sign * cross / den_n, -1.0,
                                (d1 + d3) * torch.stack([x1s, zero, x3s], -1))
    return torch.cat([Rp_pos, Rp_neg]), torch.cat([tp_pos, tp_neg])


def initialize_two_view(xy1: torch.Tensor, xy2: torch.Tensor, valid: torch.Tensor,
                        cam: Camera, num_hypotheses: int = 200,
                        generator: Optional[torch.Generator] = None,
                        sel_F: Optional[torch.Tensor] = None,
                        sel_H: Optional[torch.Tensor] = None) -> InitResult:
    """Two-view initialization from matched pixels xy1[i] <-> xy2[i]
    (valid rows only), on their device. `sel_F` (H, 8) / `sel_H` (H, 4)
    replace the minimal sets drawn from `generator` (F's first, then H's)."""
    x1n, T1 = _normalize(xy1, valid)
    x2n, T2 = _normalize(xy2, valid)
    if sel_F is None:
        sel_F = minimal_sets(valid, num_hypotheses, generator, k=8)
    if sel_H is None:
        sel_H = minimal_sets(valid, num_hypotheses, generator, k=4)
    sel_F, sel_H = sel_F.long(), sel_H.long()
    T2inv = torch.linalg.inv_ex(T2)[0]

    # Fundamental bank, then the refit on the best hypothesis's inliers.
    F = T2.T @ _eight_point_F(x1n[sel_F], x2n[sel_F]) @ T1  # de-normalize
    scores_F, oks_F = _score_F(F, xy1, xy2, valid)
    b = torch.argmax(scores_F)
    SF, F_best, inF = scores_F[b], F[b], oks_F[b]
    F_fit = T2.T @ _fit_F_masked(x1n, x2n, inF) @ T1
    SF2, inF2 = _score_F(F_fit, xy1, xy2, valid)
    better = SF2 > SF
    SF = torch.where(better, SF2, SF)
    F_best = torch.where(better, F_fit, F_best)
    inF = torch.where(better, inF2, inF)

    # Homography bank, the same way.
    Hm = T2inv @ _four_point_H(x1n[sel_H], x2n[sel_H]) @ T1
    scores_H, oks_H = _score_H(Hm, xy1, xy2, valid)
    b = torch.argmax(scores_H)
    SH, H_best, inH = scores_H[b], Hm[b], oks_H[b]
    H_fit = T2inv @ _fit_H_masked(x1n, x2n, inH) @ T1
    SH2, inH2 = _score_H(H_fit, xy1, xy2, valid)
    better = SH2 > SH
    SH = torch.where(better, SH2, SH)
    H_best = torch.where(better, H_fit, H_best)
    inH = torch.where(better, inH2, inH)

    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40
    K = _K(cam, xy1)
    Re, te = _decompose_E(K.T @ F_best @ K)
    Rh, th = _decompose_H(H_best, K)
    # E gives 4 candidates, padded to 8 by copies that must not count as a
    # competing second-best hypothesis.
    Rs = torch.where(use_H, Rh, torch.cat([Re, Re]))
    ts = torch.where(use_H, th, torch.cat([te, te]))
    inliers = torch.where(use_H, inH, inF)
    cand_valid = use_H | (torch.arange(8, device=xy1.device) < 4)

    n_good, par, Xs, goods = _check_RT(Rs, ts, xy1, xy2, inliers, cam)
    n_good = torch.where(cand_valid, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good)
    nbest = n_good[best]
    second = torch.sort(n_good).values[-2]
    distinct = use_H | (second < 0.75 * nbest)
    success = ((nbest >= 30) & (nbest > 0.8 * torch.sum(inliers)) & distinct
               & (par[best] > 0.5))
    return InitResult(success=success, T_21=se3.SE3(Rs[best], ts[best]), points_w=Xs[best],
                      good=goods[best], used_homography=use_H)
