"""Batched SE(3) rigid transforms in PyTorch.

Counterpart of `sqrtlm_slam_tpu/geometry/se3.py`: a transform is an
`(R, t)` pair, ``x_out = R @ x + t``; tangent vectors are ``[rho, phi]``
(translation first) and the optimizer update is left-multiplicative,
``retract(T, d) = exp(d) ∘ T``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import so3


class SE3(NamedTuple):
    """Batched rigid transform: ``x_out = R @ x + t``."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def identity(
    batch_shape: Tuple[int, ...] = (), dtype=torch.float32, device="cpu"
) -> SE3:
    R = torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3)).clone()
    t = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
    return SE3(R, t)


def from_matrix(T: torch.Tensor) -> SE3:
    return SE3(T[..., :3, :3], T[..., :3, 3])


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (..., 3, 3), t (..., 3)) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp(xi: torch.Tensor) -> SE3:
    """Exponential map se(3) -> SE(3). ``xi = [rho, phi]`` of shape (..., 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3.exp(phi)
    V = so3.left_jacobian(phi)
    return SE3(R, torch.einsum("...ij,...j->...i", V, rho))


def log(T: SE3) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3), returning (..., 6) ``[rho, phi]``."""
    phi = so3.log(T.R)
    Vinv = so3.left_jacobian_inv(phi)
    rho = torch.einsum("...ij,...j->...i", Vinv, T.t)
    return torch.cat([rho, phi], dim=-1)


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b: apply b first, then a."""
    R = a.R @ b.R
    t = torch.einsum("...ij,...j->...i", a.R, b.t) + a.t
    return SE3(R, t)


def inverse(T: SE3) -> SE3:
    Rinv = T.R.transpose(-1, -2)
    return SE3(Rinv, -torch.einsum("...ij,...j->...i", Rinv, T.t))


def act(T: SE3, x: torch.Tensor) -> torch.Tensor:
    """Apply transform to points: (..., 3) or (..., N, 3)."""
    if x.dim() >= 2 and x.shape[-2] != 1 and T.t.dim() < x.dim():
        return torch.einsum("...ij,...nj->...ni", T.R, x) + T.t[..., None, :]
    return torch.einsum("...ij,...j->...i", T.R, x) + T.t


def retract(T: SE3, delta: torch.Tensor) -> SE3:
    """Left-multiplicative update ``exp(delta) ∘ T``."""
    return compose(exp(delta), T)


def local_delta(T_new: SE3, T_ref: SE3) -> torch.Tensor:
    """Inverse of `retract`: log(T_new ∘ T_ref^{-1})."""
    return log(compose(T_new, inverse(T_ref)))


def adjoint(T: SE3) -> torch.Tensor:
    """SE(3) adjoint: (..., 6, 6) mapping tangent vectors between frames."""
    A = torch.zeros(T.t.shape[:-1] + (6, 6), dtype=T.R.dtype, device=T.R.device)
    A[..., :3, :3] = T.R
    A[..., 3:, 3:] = T.R
    A[..., :3, 3:] = so3.hat(T.t) @ T.R
    return A


def normalize(T: SE3) -> SE3:
    return SE3(so3.normalize(T.R), T.t)


def to_quat_trans(T: SE3) -> torch.Tensor:
    """Pack to 7-vector [tx, ty, tz, qw, qx, qy, qz] (compact storage)."""
    return torch.cat([T.t, so3.mat_to_quat(T.R)], dim=-1)


def from_quat_trans(v: torch.Tensor) -> SE3:
    return SE3(so3.quat_to_mat(v[..., 3:]), v[..., :3])
