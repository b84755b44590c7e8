"""Analytic LiDAR residuals + Jacobians, batched over associated features.

Counterpart of `sqrtlm_slam_tpu/factors/lidar.py`. A LiDAR feature point
``p_s`` lives in the camera frame of the current frame; the local map
(targets, planes) lives in the world frame. With the tracked pose ``T_cw``
the feature's world position is ``p_w = T_cw^{-1} p_s = R^T (p_s - t)``, and
the left-multiplicative update ``T <- exp(delta) T`` gives
``d p_w / d rho = -R^T`` and ``d p_w / d phi = R^T hat(p_s)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import se3, so3


def point_world(T_cw: se3.SE3, p_s: torch.Tensor) -> torch.Tensor:
    """Map sensor-frame points (..., 3) to world via T_cw^{-1}."""
    Rt = T_cw.R.transpose(-1, -2)
    return torch.einsum("...ij,...j->...i", Rt, p_s - T_cw.t)


def _dpw_ddelta(T_cw: se3.SE3, p_s: torch.Tensor) -> torch.Tensor:
    """d p_w / d delta: (..., 3, 6) = R^T [ -I | hat(p_s) ]."""
    Rt = T_cw.R.transpose(-1, -2)
    left = -Rt.expand(p_s.shape[:-1] + (3, 3))
    right = Rt @ so3.hat(p_s)
    return torch.cat([left, right], dim=-1)


def plane_residual_jac(T_cw: se3.SE3, p_s: torch.Tensor, plane_n: torch.Tensor,
                       plane_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-plane: r = n . p_w + d (scalar per feature).
    Returns (r (...,), J (..., 6))."""
    p_w = point_world(T_cw, p_s)
    r = torch.sum(plane_n * p_w, dim=-1) + plane_d
    J = torch.einsum("...i,...ij->...j", plane_n, _dpw_ddelta(T_cw, p_s))
    return r, J


def point_residual_jac(T_cw: se3.SE3, p_s: torch.Tensor, target_w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point: r = p_w - q_w (3-vector per feature).
    Returns (r (..., 3), J (..., 3, 6))."""
    return point_world(T_cw, p_s) - target_w, _dpw_ddelta(T_cw, p_s)


def edge_line_residual_jac(T_cw: se3.SE3, p_s: torch.Tensor, line_a: torch.Tensor,
                           line_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-line (the classic LOAM corner) in vector form:
    r = (p_w - a) x u with u the unit direction of a - b.
    Returns (r (..., 3), J (..., 3, 6))."""
    p_w = point_world(T_cw, p_s)
    ab = line_a - line_b
    u = ab / torch.clamp(torch.linalg.norm(ab, dim=-1, keepdim=True), min=1e-9)
    r = torch.linalg.cross(p_w - line_a, u, dim=-1)
    # d r / d p_w = -hat(u), since r = (p - a) x u.
    J = -so3.hat(u) @ _dpw_ddelta(T_cw, p_s)
    return r, J
