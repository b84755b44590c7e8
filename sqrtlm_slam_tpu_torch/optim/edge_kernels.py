"""Small closed-form kernels for the flat BA engine.

Counterpart of `sqrtlm_slam_tpu/optim/edge_kernels.py`: `inv3x3`, the
batched 3x3 inverse by adjugate and determinant (elementwise math, no
batched LU and no host read of a singularity flag).
"""

from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det), (..., 3, 3). A
    determinant below 1e-20 in magnitude is replaced by 1e-20."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E_ = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    idet = 1.0 / torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    rows = torch.stack([
        torch.stack([A, B, C], dim=-1),
        torch.stack([D, E_, F], dim=-1),
        torch.stack([G, H, I], dim=-1),
    ], dim=-2)
    return rows * idet[..., None, None]
