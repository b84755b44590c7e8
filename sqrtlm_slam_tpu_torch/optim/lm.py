"""Generic damped Levenberg-Marquardt engine on tensors.

Counterpart of `sqrtlm_slam_tpu/optim/lm.py` (Nielsen gain-ratio damping,
rollback of rejected steps, a fixed iteration count). The `lax.scan` becomes
a Python loop whose accept/reject decisions are `torch.where` selects on
device tensors: no host sync per iteration.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..geometry import se3

SystemFn = Callable[[se3.SE3], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _solve_damped(H: torch.Tensor, b: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Solve (H + mu I) dx = -b. `solve_ex` skips the error check, which
    would read the LAPACK info back to the host."""
    D = H.shape[-1]
    A = H + mu * torch.eye(D, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(A, -b)[0]


def lm_optimize(params0: se3.SE3, system_fn: SystemFn, num_iters: int = 10,
                tau: float = 1e-5, min_chi2_decrease: float = 1e-6) -> se3.SE3:
    """`num_iters` LM iterations of an SE(3) pose (left retraction); returns
    the optimized pose. One `system_fn` evaluation per iteration, the
    candidate's normal equations doubling as the next iteration's when
    accepted."""
    H, b, chi2 = system_fn(params0)
    max_diag = torch.max(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)))
    mu = tau * torch.clamp(max_diag, min=1e-10)
    nu = torch.full_like(mu, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=H.device)
    params = params0
    for _ in range(num_iters):
        dx = _solve_damped(H, b, mu)
        cand = se3.retract(params, dx)
        H_c, b_c, chi2_c = system_fn(cand)

        predicted = 0.5 * torch.sum(dx * (mu * dx - b))
        actual = chi2 - chi2_c
        rho = actual / torch.clamp(predicted, min=1e-12)
        accept = (rho > 0) & torch.isfinite(chi2_c) & ~done

        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        mu_new = torch.where(accept, mu * factor, mu * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        mu = mu_new

        params = se3.SE3(torch.where(accept, cand.R, params.R),
                         torch.where(accept, cand.t, params.t))
        H = torch.where(accept, H_c, H)
        b = torch.where(accept, b_c, b)
        done = done | (accept & (actual < min_chi2_decrease * torch.clamp(chi2, min=1.0)))
        chi2 = torch.where(accept, chi2_c, chi2)
    return params
