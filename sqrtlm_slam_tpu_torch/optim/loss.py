"""Robust loss functions (rho, rho', rho'') on tensors.

Counterpart of `sqrtlm_slam_tpu/optim/loss.py`: the trivial, Huber, Cauchy
and Tukey kernels and the chi-square gates. Each loss maps the squared
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

    def weight(self, e2: torch.Tensor) -> torch.Tensor:
        """IRLS weight rho'(e2), clipped to be nonnegative."""
        return torch.clamp(self.fn(e2)[1], min=0.0)


def trivial() -> Loss:
    def fn(e2):
        return e2, torch.ones_like(e2), torch.zeros_like(e2)

    return Loss("trivial", fn)


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


def cauchy(c: float) -> Loss:
    """Cauchy: rho = c^2 log(1 + e2/c^2)."""
    c2 = c * c
    inv_c2 = 1.0 / c2

    def fn(e2):
        aux = inv_c2 * e2 + 1.0
        rho1 = 1.0 / aux
        return c2 * torch.log(aux), rho1, -inv_c2 * rho1 * rho1

    return Loss("cauchy", fn)


def tukey(c: float) -> Loss:
    """Tukey biweight: a hard redescending loss (constant past |e| = c)."""
    c2 = c * c

    def fn(e2):
        inlier = torch.sqrt(torch.clamp(e2, min=1e-12)) <= c
        aux = 1.0 - e2 / c2
        zero = torch.zeros_like(e2)
        rho = torch.where(inlier, c2 / 3.0 * (1.0 - aux**3), torch.full_like(e2, c2 / 3.0))
        rho1 = torch.where(inlier, aux * aux, zero)
        rho2 = torch.where(inlier, -2.0 / c2 * aux, zero)
        return rho, rho1, rho2

    return Loss("tukey", fn)


# chi-square 0.05 upper quantiles: 2 dof (mono), 3 dof (stereo).
CHI2_2DOF = 5.991
CHI2_3DOF = 7.815
