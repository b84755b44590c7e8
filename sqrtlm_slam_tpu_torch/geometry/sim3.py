"""Batched Sim(3) similarity transforms in PyTorch.

Counterpart of `sqrtlm_slam_tpu/geometry/sim3.py`: ``(s, R, t)`` with
scale ``s (...)``, rotation ``(..., 3, 3)`` and translation ``(..., 3)``;
the action is ``x -> s * R @ x + t``. The tangent is the 7-vector
``[rho(3), phi(3), sigma(1)]`` with ``s = exp(sigma)``; the small-angle and
small-scale branches of the `W` matrix are selected with `torch.where`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import se3, so3

_EPS = 1e-8


class Sim3(NamedTuple):
    s: torch.Tensor  # (...)
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)


def identity(batch_shape: Tuple[int, ...] = (), dtype=torch.float32, device="cpu") -> Sim3:
    return Sim3(
        torch.ones(batch_shape, dtype=dtype, device=device),
        torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3)).clone(),
        torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
    )


def from_se3(T: se3.SE3, s=None) -> Sim3:
    if s is None:
        s = torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device)
    return Sim3(s, T.R, T.t)


def to_se3(S: Sim3) -> se3.SE3:
    """Drop the scale by folding it into the translation: t <- t / s."""
    return se3.SE3(S.R, S.t / torch.clamp(S.s[..., None], min=_EPS))


def act(S: Sim3, x: torch.Tensor) -> torch.Tensor:
    if x.dim() >= 2 and S.t.dim() < x.dim():
        return (S.s[..., None, None] * torch.einsum("...ij,...nj->...ni", S.R, x)
                + S.t[..., None, :])
    return S.s[..., None] * torch.einsum("...ij,...j->...i", S.R, x) + S.t


def compose(a: Sim3, b: Sim3) -> Sim3:
    s = a.s * b.s
    R = a.R @ b.R
    t = a.s[..., None] * torch.einsum("...ij,...j->...i", a.R, b.t) + a.t
    return Sim3(s, R, t)


def inverse(S: Sim3) -> Sim3:
    sinv = 1.0 / torch.clamp(S.s, min=_EPS)
    Rinv = S.R.transpose(-1, -2)
    tinv = -sinv[..., None] * torch.einsum("...ij,...j->...i", Rinv, S.t)
    return Sim3(sinv, Rinv, tinv)


def _W_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``W = A*hat(phi) + B*hat(phi)^2 + C*I``, coupling translation with
    rotation and scale (the four {sigma, theta} near/away-from-zero regimes
    of the JAX package, branch-free)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    one = torch.ones_like(theta)

    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    sig = torch.where(small_sigma, one, sigma)  # safe denominators
    th = torch.where(small_theta, one, theta)
    th2 = torch.where(small_theta, one, theta2)

    C = torch.where(small_sigma, 1.0 + 0.5 * sigma, (s - 1.0) / sig)

    A_s0 = torch.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - cos_t) / th2)
    B_s0 = torch.where(small_theta, 1.0 / 6.0 - theta2 / 120.0, (theta - sin_t) / (th2 * th))

    A_t0 = ((sigma - 1.0) * s + 1.0) / (sig * sig)
    B_t0 = (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / (sig * sig * sig)

    a = s * sin_t
    b = s * cos_t
    c = theta2 + sigma * sigma
    c_safe = torch.where(small_theta & small_sigma, one, c)
    A_gen = (a * sigma + (1.0 - b) * theta) / (th * c_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / th2

    A = torch.where(small_sigma, A_s0, torch.where(small_theta, A_t0, A_gen))
    B = torch.where(small_sigma, B_s0, torch.where(small_theta, B_t0, B_gen))

    Phi = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return A[..., None, None] * Phi + B[..., None, None] * (Phi @ Phi) + C[..., None, None] * eye


def exp(xi: torch.Tensor) -> Sim3:
    """Exponential map sim(3) -> Sim(3); ``xi = [rho, phi, sigma]`` (..., 7)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3.exp(phi)
    W = _W_matrix(phi, sigma)
    return Sim3(torch.exp(sigma), R, torch.einsum("...ij,...j->...i", W, rho))


def log(S: Sim3) -> torch.Tensor:
    """Logarithm map Sim(3) -> sim(3), (..., 7) ``[rho, phi, sigma]``."""
    sigma = torch.log(torch.clamp(S.s, min=_EPS))
    phi = so3.log(S.R)
    W = _W_matrix(phi, sigma)
    # `solve_ex`: `solve`'s bits without its host error check (the essential
    # graph's step runs this inside a captured CUDA graph).
    rho = torch.linalg.solve_ex(W, S.t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def retract(S: Sim3, delta: torch.Tensor) -> Sim3:
    """Left-multiplicative update ``exp(delta) ∘ S`` (7-dim tangent)."""
    return compose(exp(delta), S)


def index(S: Sim3, idx) -> Sim3:
    """Select transforms along the batch dimension."""
    return Sim3(S.s[idx], S.R[idx], S.t[idx])
