"""Analytic reprojection residuals + Jacobians, batched over edges.

Counterpart of `sqrtlm_slam_tpu/factors/reprojection.py`. Pose ``T = T_cw``
maps world -> camera; the update is left-multiplicative, so
``d x_c / d rho = I`` and ``d x_c / d phi = -hat(x_c)``; the point Jacobian
is ``d x_c / d X_w = R``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import se3, so3

_ZEPS = 1e-6


class Camera(NamedTuple):
    """Pinhole intrinsics (+ stereo baseline*fx, the reference's ``bf``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0

    def project(self, x_cam: torch.Tensor) -> torch.Tensor:
        """Project camera-frame points (..., 3) to pixels (..., 2)."""
        z = torch.clamp(x_cam[..., 2], min=_ZEPS)
        u = self.fx * x_cam[..., 0] / z + self.cx
        v = self.fy * x_cam[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)


def transform_points(T_cw: se3.SE3, X_w: torch.Tensor) -> torch.Tensor:
    return se3.act(T_cw, X_w)


def _pose_chain(x_c: torch.Tensor) -> torch.Tensor:
    """d x_c / d delta for the left-mult update: (..., 3, 6) = [I | -hat(x_c)]."""
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device).expand(x_c.shape[:-1] + (3, 3))
    return torch.cat([eye, -so3.hat(x_c)], dim=-1)


def _proj_rows(cam: Camera, x_c: torch.Tensor):
    x, y = x_c[..., 0], x_c[..., 1]
    z = torch.clamp(x_c[..., 2], min=_ZEPS)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return x, y, iz, iz2, zero, row_u, row_v


def mono_residual_jac(
    T_cw: se3.SE3, X_w: torch.Tensor, uv_obs: torch.Tensor, cam: Camera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monocular reprojection: (r (...,2), J_pose (...,2,6), J_point (...,2,3)),
    ``r = proj(T X) - uv_obs``."""
    x_c = se3.act(T_cw, X_w)
    r = cam.project(x_c) - uv_obs
    _, _, _, _, _, row_u, row_v = _proj_rows(cam, x_c)
    dproj = torch.stack([row_u, row_v], dim=-2)
    return r, dproj @ _pose_chain(x_c), dproj @ T_cw.R


def stereo_residual_jac(
    T_cw: se3.SE3, X_w: torch.Tensor, uvr_obs: torch.Tensor, cam: Camera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stereo reprojection (u_left, v_left, u_right = u - bf/z):
    (r (...,3), J_pose (...,3,6), J_point (...,3,3))."""
    x_c = se3.act(T_cw, X_w)
    x, y, iz, iz2, zero, row_u, row_v = _proj_rows(cam, x_c)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = torch.stack([u, v, ur], dim=-1) - uvr_obs
    row_r = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], dim=-1)
    dproj = torch.stack([row_u, row_v, row_r], dim=-2)
    return r, dproj @ _pose_chain(x_c), dproj @ T_cw.R


def depth_residual_jac(
    T_cw: se3.SE3, X_w: torch.Tensor, inv_uvd_obs: torch.Tensor, cam: Camera
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v, depth) observation variant (RGB-D direct depth):
    (r (...,3), J_pose (...,3,6), J_point (...,3,3)), the depth row
    ``z - d_obs``."""
    x_c = se3.act(T_cw, X_w)
    r = torch.cat([cam.project(x_c) - inv_uvd_obs[..., :2],
                   x_c[..., 2:] - inv_uvd_obs[..., 2:]], dim=-1)
    _, _, _, _, zero, row_u, row_v = _proj_rows(cam, x_c)
    row_z = torch.stack([zero, zero, torch.ones_like(zero)], dim=-1)
    dfull = torch.stack([row_u, row_v, row_z], dim=-2)
    return r, dfull @ _pose_chain(x_c), dfull @ T_cw.R
