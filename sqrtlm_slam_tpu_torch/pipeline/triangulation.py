"""Two-view triangulation of new map points — batched.

Counterpart of `sqrtlm_slam_tpu/pipeline/triangulation.py`: descriptor
matching under an epipolar-band mask, a batched 4x4 DLT SVD for all
candidate pairs, and the reference's acceptance gates (parallax, positive
depth in both views, reprojection chi2, scale consistency) as masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.reprojection import Camera
from ..frontend import matching
from ..geometry import se3, so3

CHI2_MONO = 5.991


class TriangulationResult(NamedTuple):
    points_w: torch.Tensor  # (N, 3)
    idx2: torch.Tensor  # (N,) matched keypoint in view 2
    valid: torch.Tensor  # (N,) bool


def _K(cam: Camera, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def fundamental_matrix(T1w: se3.SE3, T2w: se3.SE3, cam: Camera) -> torch.Tensor:
    """F12 with x2^T F12 x1 = 0 (pixels), from world->cam poses."""
    T12 = se3.compose(T1w, se3.inverse(T2w))
    K = _K(cam, T12.R)
    Kinv = torch.linalg.inv(K)
    E = so3.hat(T12.t) @ T12.R
    return (Kinv.T @ E @ Kinv).T


def _dlt_triangulate(uv1, uv2, P1, P2):
    """Batched DLT: (N, 2) x 2 views -> (N, 3). Projection matrices (..., 3, 4)
    with leading dims (candidate motions) give (..., N, 3)."""
    def rows(uv, P):
        P = P[..., None, :, :]  # one matrix for every point
        return torch.stack([uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                            uv[..., 1, None] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat(torch.broadcast_tensors(rows(uv1, P1), rows(uv2, P2)), dim=-2)  # (..., N, 4, 4)
    Vh = torch.linalg.svd(A).Vh
    X = Vh[..., -1, :]
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
