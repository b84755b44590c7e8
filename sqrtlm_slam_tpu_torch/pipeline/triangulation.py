"""Two-view triangulation of new map points — batched.

Counterpart of `sqrtlm_slam_tpu/pipeline/triangulation.py`: descriptor
matching under an epipolar-band mask, a batched 4x4 DLT for all candidate
pairs, and the reference's acceptance gates (parallax, positive depth in
both views, reprojection chi2, scale consistency) as masks.

`match_and_triangulate` is a captured CUDA graph on the card
(`utils.cache.graphed`, static `cam`: the JAX package's `jax.jit`), so
nothing in it reads the device: K and K^-1 come in closed form from the
camera's four scalars, made once per camera, dtype and device, and the DLT's
null vector is a one-sided Jacobi SVD of fixed sweeps in tensor ops
(`torch.linalg.inv` and `torch.linalg.svd` check their results on the
host).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3, so3
from ..utils import cache

CHI2_MONO = 5.991
# One-sided Jacobi sweeps of the 4x4 DLT: each sweep rotates the 6 column
# pairs; convergence is quadratic, and 6 sweeps reach float32 rounding.
JACOBI_SWEEPS = 6


class TriangulationResult(NamedTuple):
    points_w: torch.Tensor  # (N, 3)
    idx2: torch.Tensor  # (N,) matched keypoint in view 2
    valid: torch.Tensor  # (N,) bool


@functools.lru_cache(maxsize=None)
def _intrinsics(fx: float, fy: float, cx: float, cy: float, dtype: torch.dtype,
                device: torch.device):
    """(K, K^-1) of a pinhole camera, K^-1 in closed form (float64, then
    rounded to `dtype`), on `device` once per process (no host-to-device
    copy per call: a captured graph takes none)."""
    K = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
    Kinv = [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]]
    return (torch.tensor(K, dtype=torch.float64).to(device=device, dtype=dtype),
            torch.tensor(Kinv, dtype=torch.float64).to(device=device, dtype=dtype))


def _K(cam: Camera, like: torch.Tensor) -> torch.Tensor:
    return _intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, like.dtype, like.device)[0]


def fundamental_matrix(T1w: se3.SE3, T2w: se3.SE3, cam: Camera) -> torch.Tensor:
    """F12 with x2^T F12 x1 = 0 (pixels), from world->cam poses."""
    T12 = se3.compose(T1w, se3.inverse(T2w))
    Kinv = _intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, T12.R.dtype, T12.R.device)[1]
    E = so3.hat(T12.t) @ T12.R
    return (Kinv.T @ E @ Kinv).T


def _null_vector_4x4(A: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Right singular vector of the smallest singular value of each (..., 4,
    4) matrix (up to sign): one-sided (Hestenes) Jacobi, `sweeps` cyclic
    sweeps over the 6 column pairs, each rotation orthogonalizing two
    columns of A V. It works on A itself (not A^T A, which would square the
    condition number) and takes a fixed number of steps in tensor ops: no
    convergence test reads the device."""
    U = A.clone()
    V = torch.eye(4, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(sweeps):
        for p in range(3):
            for q in range(p + 1, 4):
                up, uq = U[..., :, p], U[..., :, q]
                alpha = torch.sum(up * up, dim=-1)
                beta = torch.sum(uq * uq, dim=-1)
                gamma = torch.sum(up * uq, dim=-1)
                # The rotation that zeroes the pair's inner product (none
                # where it is zero already).
                skip = gamma == 0
                zeta = (beta - alpha) / torch.where(skip, one, 2.0 * gamma)
                t = torch.where(zeta >= 0, one, -one) / (
                    torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
                t = torch.where(skip, torch.zeros_like(t), t)
                c = torch.rsqrt(1.0 + t * t)[..., None]
                s = c * t[..., None]
                for M in (U, V):
                    mp, mq = M[..., :, p].clone(), M[..., :, q].clone()
                    M[..., :, p] = c * mp - s * mq
                    M[..., :, q] = s * mp + c * mq
    norms = torch.sum(U * U, dim=-2)  # (..., 4) squared singular values
    j = torch.argmin(norms, dim=-1)
    return torch.gather(V, -1, j[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def _dlt_triangulate(uv1, uv2, P1, P2):
    """Batched DLT: (N, 2) x 2 views -> (N, 3). Projection matrices (..., 3, 4)
    with leading dims (candidate motions) give (..., N, 3)."""
    def rows(uv, P):
        P = P[..., None, :, :]  # one matrix for every point
        return torch.stack([uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                            uv[..., 1, None] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat(torch.broadcast_tensors(rows(uv1, P1), rows(uv2, P2)), dim=-2)  # (..., N, 4, 4)
    X = _null_vector_4x4(A)
    w = X[..., 3]
    w = torch.where(torch.abs(w) > 1e-9, w, torch.full_like(w, 1e-9))
    return X[..., :3] / w[..., None]


def match_and_triangulate(T1w: se3.SE3, T2w: se3.SE3, cam: Camera,
                          xy1, desc1, valid1, sigma2_1,
                          xy2, desc2, valid2, sigma2_2,
                          angles1=None, angles2=None,
                          min_parallax_cos: float = 0.9998,
                          epipolar_band: float = 3.84) -> TriangulationResult:
    """Epipolar-gated matching + DLT triangulation + acceptance gates.
    valid1 should already exclude keypoints bound to existing landmarks."""
    F12 = fundamental_matrix(T1w, T2w, cam)
    x1h = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)
    lines = x1h @ F12.T
    x2h = torch.cat([xy2, torch.ones_like(xy2[..., :1])], dim=-1)
    num = torch.abs(lines @ x2h.T)
    den = torch.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2 + 1e-12)[..., None]
    epi_ok = (num / den) ** 2 < epipolar_band * sigma2_2[None, :]

    res = matching.match_descriptors(
        desc1, desc2, valid1, valid2, window_mask=epi_ok, max_dist=matching.TH_LOW,
        ratio=0.75, mutual=True,
        angles=(angles1, angles2) if angles1 is not None else None,
    )
    idx = res.idx.long()
    uv1 = xy1
    uv2 = xy2[idx]
    K = _K(cam, xy1)
    P1 = K @ torch.cat([T1w.R, T1w.t[:, None]], dim=-1)
    P2 = K @ torch.cat([T2w.R, T2w.t[:, None]], dim=-1)
    X = _dlt_triangulate(uv1, uv2, P1, P2)

    x_c1 = se3.act(T1w, X)
    x_c2 = se3.act(T2w, X)
    depth_ok = (x_c1[..., 2] > 0.05) & (x_c2[..., 2] > 0.05)
    C1 = -T1w.R.T @ T1w.t
    C2 = -T2w.R.T @ T2w.t
    r1 = X - C1
    r2 = X - C2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = torch.sum(r1 * r2, dim=-1) / (n1 * n2 + 1e-9)
    parallax_ok = cos_par < min_parallax_cos
    e1 = torch.sum((cam.project(x_c1) - uv1) ** 2, dim=-1) / sigma2_1
    e2 = torch.sum((cam.project(x_c2) - uv2) ** 2, dim=-1) / sigma2_2[idx]
    reproj_ok = (e1 < CHI2_MONO) & (e2 < CHI2_MONO)
    ratio = n1 / torch.clamp(n2, min=1e-9)
    scale_ok = (ratio > 1.0 / 2.5) & (ratio < 2.5)
    valid = res.valid & depth_ok & parallax_ok & reproj_ok & scale_ok
    return TriangulationResult(points_w=X, idx2=res.idx, valid=valid)


match_and_triangulate = cache.graphed(match_and_triangulate, static_argnames=("cam",))
