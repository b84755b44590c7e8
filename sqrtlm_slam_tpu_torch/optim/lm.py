"""Generic damped Levenberg-Marquardt engine on tensors.

Counterpart of `sqrtlm_slam_tpu/optim/lm.py` (Nielsen gain-ratio damping,
rollback of rejected steps, a fixed iteration count). The `lax.scan` becomes
a Python loop whose accept/reject decisions are `torch.where` selects on
device tensors: no host sync per iteration.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..geometry import se3

SystemFn = Callable[[Any], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
RetractFn = Callable[[Any, torch.Tensor], Any]


class LMResult(NamedTuple):
    params: Any
    chi2: torch.Tensor
    mu: torch.Tensor
    num_accepted: torch.Tensor


def _solve_damped(H: torch.Tensor, b: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Solve (H + mu I) dx = -b. `solve_ex` skips the error check, which
    would read the LAPACK info back to the host."""
    D = H.shape[-1]
    A = H + mu * torch.eye(D, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(A, -b)[0]


def lm_optimize(params0: Any, system_fn: SystemFn, retract_fn: RetractFn = se3.retract,
                num_iters: int = 10, tau: float = 1e-5,
                min_chi2_decrease: float = 1e-6) -> LMResult:
    """`num_iters` LM iterations of a NamedTuple of tensors (an SE(3) pose
    with its left retraction by default). One `system_fn` evaluation per
    iteration, the candidate's normal equations doubling as the next
    iteration's when accepted."""
    H, b, chi2 = system_fn(params0)
    max_diag = torch.max(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)))
    mu = tau * torch.clamp(max_diag, min=1e-10)
    nu = torch.full_like(mu, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=H.device)
    accepts = []
    params = params0
    for _ in range(num_iters):
        dx = _solve_damped(H, b, mu)
        cand = retract_fn(params, dx)
        H_c, b_c, chi2_c = system_fn(cand)

        predicted = 0.5 * torch.sum(dx * (mu * dx - b))
        actual = chi2 - chi2_c
        rho = actual / torch.clamp(predicted, min=1e-12)
        accept = (rho > 0) & torch.isfinite(chi2_c) & ~done

        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        mu_new = torch.where(accept, mu * factor, mu * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        mu = mu_new

        params = type(params)(*[torch.where(accept, c, p) for c, p in zip(cand, params)])
        H = torch.where(accept, H_c, H)
        b = torch.where(accept, b_c, b)
        accepts.append(accept)
        done = done | (accept & (actual < min_chi2_decrease * torch.clamp(chi2, min=1.0)))
        chi2 = torch.where(accept, chi2_c, chi2)
    # One count at the end, not one add per iteration: the pose LM runs
    # ~160 iterations a tracked frame, each a few dozen launches.
    n_acc = (torch.stack(accepts).sum(dtype=torch.int32) if accepts
             else torch.zeros((), dtype=torch.int32, device=H.device))
    return LMResult(params, chi2, mu, n_acc)


def gauss_newton_step(H: torch.Tensor, b: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """Single lightly damped GN step, (H + damping I) dx = -b, for inner
    loops that manage their own re-linearization."""
    return _solve_damped(H, b, torch.tensor(damping, dtype=H.dtype, device=H.device))
