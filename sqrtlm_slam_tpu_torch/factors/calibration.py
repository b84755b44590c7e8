"""Extrinsic calibration between sensor frames: damped Gauss-Newton on SE(3).

Counterpart of `sqrtlm_slam_tpu/factors/calibration.py` (the reference's
`CalibrationFactor`): refine the camera <- LiDAR extrinsic T from
corresponding features, a LiDAR point ``p_l`` landing on its camera-frame
target after ``x_c = T p_l``. Residuals (batched, masked):
  * point-to-point:  r = T p_l - q_c       (3,)
  * point-to-plane:  r = n . (T p_l) + d   (1,)
Plain PyTorch: a fixed number of 6x6 normal-equation solves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3, so3


def _dxc_ddelta(x_c: torch.Tensor) -> torch.Tensor:
    """d(T p)/d delta for the left-multiplicative update T <- exp(delta) T:
    [I | -hat(x_c)]."""
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device).expand(x_c.shape[:-1] + (3, 3))
    return torch.cat([eye, -so3.hat(x_c)], dim=-1)


def point_pair_residual_jac(T: se3.SE3, p_l, q_c):
    """r = T p_l - q_c. Returns (r (..., 3), J (..., 3, 6))."""
    x_c = se3.act(T, p_l)
    return x_c - q_c, _dxc_ddelta(x_c)


def point_plane_residual_jac(T: se3.SE3, p_l, n_c, d_c):
    """r = n . (T p_l) + d. Returns (r (...,), J (..., 6))."""
    x_c = se3.act(T, p_l)
    r = torch.sum(n_c * x_c, dim=-1) + d_c
    J = torch.einsum("...i,...ij->...j", n_c, _dxc_ddelta(x_c))
    return r, J


class CalibResult(NamedTuple):
    T: se3.SE3
    chi2: torch.Tensor


def calibrate_extrinsics(
    T0: se3.SE3,
    p_lidar: torch.Tensor,  # (N, 3) LiDAR-frame points
    q_cam: torch.Tensor,  # (N, 3) camera-frame targets
    pair_valid: torch.Tensor,  # (N,) bool
    plane_p: Optional[torch.Tensor] = None,  # (M, 3) LiDAR points on planes
    plane_n: Optional[torch.Tensor] = None,  # (M, 3) camera-frame normals
    plane_d: Optional[torch.Tensor] = None,  # (M,)
    plane_valid: Optional[torch.Tensor] = None,  # (M,) bool
    num_iters: int = 10,
    damping: float = 1e-6,
) -> CalibResult:
    """Refine the extrinsic T (camera <- LiDAR) from correspondences. `chi2`
    is the cost at the state before the last step, as in the JAX package."""
    T = T0
    chi2 = None
    for _ in range(num_iters):
        r, J = point_pair_residual_jac(T, p_lidar, q_cam)
        w = pair_valid.to(r.dtype)
        H = torch.einsum("nki,n,nkj->ij", J, w, J)
        b = torch.einsum("nki,n,nk->i", J, w, r)
        chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
        if plane_p is not None:
            rp, Jp = point_plane_residual_jac(T, plane_p, plane_n, plane_d)
            wp = plane_valid.to(rp.dtype)
            H = H + torch.einsum("ni,n,nj->ij", Jp, wp, Jp)
            b = b + torch.einsum("ni,n,n->i", Jp, wp, rp)
            chi2 = chi2 + torch.sum(wp * rp * rp)
        lam = damping * torch.clamp(torch.max(torch.abs(torch.diagonal(H))), min=1e-12)
        eye = torch.eye(6, dtype=H.dtype, device=H.device)
        dx = torch.linalg.solve(H + lam * eye, -b)
        T = se3.retract(T, dx)
    return CalibResult(T=T, chi2=chi2)
