"""Closed-form 3D-3D alignment (Horn / Umeyama), batched over hypotheses.

Counterpart of `sqrtlm_slam_tpu/geometry/align.py`: weighted Umeyama with
an optional scale, batched over leading dimensions (the whole Sim3 RANSAC
hypothesis bank is one batched 3x3 SVD). The SVD and the determinant are
`geometry/jacobi.py`'s (fixed sweeps, closed form), which read nothing back
from the device: the RANSAC banks run inside captured graphs.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import jacobi
from .se3 import SE3
from .sim3 import Sim3

_EPS = 1e-9


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: Optional[torch.Tensor] = None,
            with_scale: bool = True) -> Sim3:
    """Weighted Umeyama alignment: the Sim3 S minimizing ||S(src) - dst||^2.

    src, dst: (..., N, 3); weights: (..., N) nonnegative (masks allowed).
    With ``with_scale=False`` the scale is fixed to 1."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=_EPS)

    mu_src = torch.sum(w[..., None] * src, dim=-2)
    mu_dst = torch.sum(w[..., None] * dst, dim=-2)
    src_c = src - mu_src[..., None, :]
    dst_c = dst - mu_dst[..., None, :]
    cov = torch.einsum("...ni,...n,...nj->...ij", dst_c, w, src_c)

    U, D, V = jacobi.svd3(cov)
    Vt = V.mT
    det = jacobi.det3(U @ Vt)
    ones = torch.ones(src.shape[:-2] + (2,), dtype=src.dtype, device=src.device)
    S = torch.cat([ones, torch.sign(det)[..., None]], dim=-1)
    R = U @ (S[..., :, None] * Vt)

    if with_scale:
        var_src = torch.sum(w * torch.sum(src_c * src_c, dim=-1), dim=-1)
        scale = torch.sum(D * S, dim=-1) / torch.clamp(var_src, min=_EPS)
    else:
        scale = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)

    t = mu_dst - scale[..., None] * torch.einsum("...ij,...j->...i", R, mu_src)
    return Sim3(scale, R, t)


def se3_horn(src: torch.Tensor, dst: torch.Tensor, weights=None) -> SE3:
    """Rigid (scale = 1) Horn alignment, returned as SE3."""
    S = umeyama(src, dst, weights=weights, with_scale=False)
    return SE3(S.R, S.t)


def ate_rmse(est_xyz: torch.Tensor, gt_xyz: torch.Tensor, align_scale: bool = True):
    """Absolute trajectory error RMSE of (N, 3) positions after Sim3 (or SE3)
    alignment (`evo_ape ... -as`). Returns (rmse, aligned estimate)."""
    S = umeyama(est_xyz, gt_xyz, with_scale=align_scale)
    aligned = S.s * est_xyz @ S.R.T + S.t
    err = aligned - gt_xyz
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1))), aligned
