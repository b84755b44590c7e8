"""Robust loss functions (rho, rho', rho'') on tensors.

Counterpart of `sqrtlm_slam_tpu/optim/loss.py`, the part the main path
uses: the Huber kernel and the chi-square gates. Each loss maps the squared
error ``e2 = r^T W r`` to ``(rho, rho1, rho2)``; ``rho1`` is the IRLS weight.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

LossFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class Loss(NamedTuple):
    name: str
    fn: LossFn

    def __call__(self, e2: torch.Tensor):
        return self.fn(e2)


def huber(delta: float) -> Loss:
    """Huber: quadratic below delta^2, linear above."""
    d2 = delta * delta

    def fn(e2):
        sqrt_e2 = torch.sqrt(torch.clamp(e2, min=1e-12))
        inlier = e2 <= d2
        rho = torch.where(inlier, e2, 2.0 * delta * sqrt_e2 - d2)
        rho1 = torch.where(inlier, torch.ones_like(e2), delta / sqrt_e2)
        rho2 = torch.where(inlier, torch.zeros_like(e2), -0.5 * delta / (e2 * sqrt_e2))
        return rho, rho1, rho2

    return Loss("huber", fn)


# chi-square 0.05 upper quantiles: 2 dof (mono), 3 dof (stereo).
CHI2_2DOF = 5.991
CHI2_3DOF = 7.815
