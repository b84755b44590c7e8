"""Batched SO(3) Lie-group operations in PyTorch.

Counterpart of `sqrtlm_slam_tpu/geometry/so3.py`: rotations are (..., 3, 3)
matrices, every function broadcasts over leading batch dims, and the
small-angle branches are selected with `torch.where` (no host sync).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) via Rodrigues, (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3), through the
    quaternion (stable at small angles and near pi)."""
    q = mat_to_quat(R)
    qw, xyz = q[..., 0], q[..., 1:]
    sin_half = torch.sqrt(torch.sum(xyz * xyz, dim=-1) + _EPS * _EPS)
    theta = 2.0 * torch.atan2(sin_half, qw)
    small = sin_half < 1e-6
    scale = torch.where(
        small,
        2.0 + theta * theta / 12.0,
        theta / torch.where(small, torch.ones_like(sin_half), sin_half),
    )
    return scale[..., None] * xyz


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian, (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    one = torch.ones_like(theta)
    cot = torch.where(small, one, torch.cos(half) / torch.where(small, one, torch.sin(half)))
    k = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * cot) / torch.where(small, one, theta2),
    )
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) - 0.5 * W + k[..., None, None] * W2


def normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a rotation matrix by Gram-Schmidt on its first two
    columns (drift correction after long chains of composes)."""
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=_EPS)
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=_EPS)
    return torch.stack([x, y, torch.linalg.cross(x, y, dim=-1)], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z]
    by branch-free Shepperd's method (largest pivot, canonical qw >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack([qw0 * qw0, (m21 - m12), (m02 - m20), (m10 - m01)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12), qx1 * qx1, (m01 + m10), (m02 + m20)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20), (m01 + m10), qy2 * qy2, (m12 + m21)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01), (m02 + m20), (m12 + m21), qz3 * qz3], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
