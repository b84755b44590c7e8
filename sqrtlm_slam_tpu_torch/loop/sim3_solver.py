"""Sim(3) RANSAC between two keyframes from 3D-3D landmark matches.

Counterpart of `sqrtlm_slam_tpu/loop/sim3_solver.py`: the whole hypothesis
bank runs as one batched computation (H minimal sets -> batched Umeyama SVD
-> (H, N) two-directional reprojection checks -> the first hypothesis with
the most inliers -> one refit on its inliers), and `optimize_sim3` is the
Gauss-Newton refinement with mutual reprojection residuals through S12 and
S21, Huber-weighted, scale frozen for stereo/RGB-D.

The minimal sets are a masked Gumbel top-k of uniform draws from an
explicit `torch.Generator` (`algorithm/ransac.py`); `jax.random` cannot be
reproduced in torch, so `ransac_sim3` also takes the minimal sets
themselves (`sel`), which lets a parity test feed the JAX package's own
draws.

On the card both programs are captured CUDA graphs (`utils.cache`, the
JAX package's jit). A graph cannot advance a generator: `ransac_sim3` draws
its (H, N) uniforms from the caller's generator, then replays
`_ransac_sim3_jit`, which takes the top-k sets inside the graph, so it
consumes the generator stream that the eager call consumes. `optimize_sim3`
is the graphed function under its own name (`.eager` the body). The SVDs
are `geometry/jacobi.py`'s and the solve `solve_ex`: nothing inside reads
the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..algorithm.ransac import row, top_k_sets
from ..factors.reprojection import Camera
from ..geometry import align, sim3
from ..utils import cache

CHI2_SIM3 = 9.210  # 2-dof chi2 at 0.01 (the Sim3Solver inlier threshold)


class Sim3RansacResult(NamedTuple):
    S12: sim3.Sim3  # best hypothesis: maps KF2-camera-frame points to KF1
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # ()


def _inlier_errors(S: sim3.Sim3, x1, x2, uv1, uv2, is2_1, is2_2, cam: Camera):
    """Squared whitened errors of x2 -> KF1 and x1 -> KF2 under S, with the
    depth of both transferred point sets."""
    x2_in_1 = sim3.act(S, x2)
    x1_in_2 = sim3.act(sim3.inverse(S), x1)
    e1 = torch.sum((cam.project(x2_in_1) - uv1) ** 2, dim=-1) * is2_1
    e2 = torch.sum((cam.project(x1_in_2) - uv2) ** 2, dim=-1) * is2_2
    return e1, e2, x2_in_1[..., 2], x1_in_2[..., 2]


def ransac_sim3(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor, cam: Camera,
                num_hypotheses: int = 128, fix_scale: bool = False,
                generator: Optional[torch.Generator] = None,
                sel: Optional[torch.Tensor] = None) -> Sim3RansacResult:
    """Batched-hypothesis RANSAC for S12 (x1 ~ S12 * x2). x1, x2: (N, 3)
    matched landmarks in each keyframe's camera frame; `sel` (H, 3) replaces
    the random minimal sets when given."""
    if sel is None:
        u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator,
                       device=valid.device)
        return _ransac_sim3_jit(x1, x2, valid, inv_sigma2_1, inv_sigma2_2, u, cam, fix_scale)
    return _ransac_sim3_on_sets(x1, x2, valid, inv_sigma2_1, inv_sigma2_2, sel, cam, fix_scale)


def _ransac_sim3_drawn(x1, x2, valid, inv_sigma2_1, inv_sigma2_2, u, cam: Camera,
                       fix_scale: bool) -> Sim3RansacResult:
    """`ransac_sim3` on the uniforms u (H, N): the minimal sets and the
    bank (the graphed core)."""
    return _ransac_sim3_on_sets(x1, x2, valid, inv_sigma2_1, inv_sigma2_2,
                                top_k_sets(u, valid), cam, fix_scale)


def _ransac_sim3_on_sets(x1, x2, valid, inv_sigma2_1, inv_sigma2_2, sel, cam: Camera,
                         fix_scale: bool) -> Sim3RansacResult:
    H = sel.shape[0]
    sel = sel.long()
    S_h = align.umeyama(x2[sel], x1[sel], with_scale=not fix_scale)

    uv1 = cam.project(x1)
    uv2 = cam.project(x2)
    xb1 = x1[None].expand(H, -1, -1)
    xb2 = x2[None].expand(H, -1, -1)
    e1, e2, z21, z12 = _inlier_errors(S_h, xb1, xb2, uv1[None], uv2[None],
                                      inv_sigma2_1[None], inv_sigma2_2[None], cam)
    ok = (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3) & valid[None] & (z21 > 0) & (z12 > 0)
    counts = torch.sum(ok, dim=-1)
    # Degenerate hypotheses (scale collapse) are invalidated.
    finite = torch.isfinite(S_h.s) & (S_h.s > 1e-3) & (S_h.s < 1e3)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))

    best = torch.argmax(counts)  # first maximum, as jnp.argmax
    S_best = sim3.Sim3(*(row(a, best) for a in S_h))
    inliers = row(ok, best)

    # Final refit on all inliers of the best hypothesis.
    S_refit = align.umeyama(x2, x1, weights=inliers.to(x1.dtype),
                            with_scale=not fix_scale)
    e1r, e2r, z21r, z12r = _inlier_errors(S_refit, x1, x2, uv1, uv2, inv_sigma2_1,
                                          inv_sigma2_2, cam)
    in_r = (e1r < CHI2_SIM3) & (e2r < CHI2_SIM3) & valid & (z21r > 0) & (z12r > 0)
    use_refit = torch.sum(in_r) >= torch.sum(inliers)
    S_out = sim3.Sim3(*[torch.where(use_refit, a, b) for a, b in zip(S_refit, S_best)])
    inl = torch.where(use_refit, in_r, inliers)
    return Sim3RansacResult(S12=S_out, inliers=inl, num_inliers=torch.sum(inl))


def optimize_sim3(S12: sim3.Sim3, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                  inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor, cam: Camera,
                  num_iters: int = 10, fix_scale: bool = False,
                  huber_delta: float = math.sqrt(10.0)):
    """Gauss-Newton refinement of S12 with mutual reprojection residuals
    (forward: S12 x2 vs KF1; backward: S21 x1 vs KF2), Huber kernel, 7-dim
    tangent with the scale row pinned when `fix_scale`. Half the iterations
    use every valid match, the rest the chi2-gated survivors.
    Returns (S12, inliers (N,), num_inliers)."""
    dtype, dev = x1.dtype, x1.device
    uv1 = cam.project(x1)
    uv2 = cam.project(x2)
    zero = torch.zeros(7, dtype=dtype, device=dev)
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def residuals(delta, S):
        # A (1, 7) tangent: forward-mode AD of 0-dim float32 tensors mixed
        # with Python scalars yields float64 tangents.
        Sd = sim3.retract(S, delta[None])
        r1 = cam.project(sim3.act(Sd, x2)) - uv1
        r2 = cam.project(sim3.act(sim3.inverse(Sd), x1)) - uv2
        return r1, r2

    def errors(S):
        r1, r2 = residuals(zero, S)
        return (torch.sum(r1 * r1, dim=-1) * inv_sigma2_1,
                torch.sum(r2 * r2, dim=-1) * inv_sigma2_2)

    def normal_eq(r, J, is2, active):
        e2 = torch.sum(r * r, dim=-1) * is2
        w_rob = torch.where(e2 > huber_delta ** 2,
                            huber_delta / torch.sqrt(torch.clamp(e2, min=1e-12)),
                            torch.ones_like(e2))
        w = is2 * w_rob * active.to(dtype)
        return (torch.einsum("nki,n,nkj->ij", J, w, J),
                torch.einsum("nki,n,nk->i", J, w, r))

    def gn_step(S, active):
        r1, r2 = residuals(zero, S)
        J1, J2 = jacfwd(lambda d: residuals(d, S))(zero)  # (N, 2, 7) each
        H1, b1 = normal_eq(r1, J1, inv_sigma2_1, active)
        H2, b2 = normal_eq(r2, J2, inv_sigma2_2, active)
        H = H1 + H2 + 1e-6 * eye7
        b = b1 + b2
        if fix_scale:
            pin = torch.arange(7, device=dev) == 6
            H = torch.where(pin[:, None] | pin[None, :], torch.zeros_like(H), H)
            H = H + torch.diag(pin.to(dtype))
            b = torch.where(pin, torch.zeros_like(b), b)
        return sim3.retract(S, -torch.linalg.solve_ex(H, b)[0])

    n1 = max(num_iters // 2, 1)
    for _ in range(n1):
        S12 = gn_step(S12, valid)
    for _ in range(max(num_iters - n1, 1)):
        e1, e2 = errors(S12)
        S12 = gn_step(S12, valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3))
    e1, e2 = errors(S12)
    inliers = valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3)
    return S12, inliers, torch.sum(inliers)


# The JAX package's jitted programs as captured CUDA graphs (static `cam`,
# `fix_scale` and the iteration settings): one capture per match buffer
# shape (`LoopClosingConfig.match_cap`) serves every loop candidate.
_ransac_sim3_jit = cache.graphed(_ransac_sim3_drawn, static_argnames=("cam", "fix_scale"))
optimize_sim3 = cache.graphed(optimize_sim3, static_argnames=(
    "cam", "num_iters", "fix_scale", "huber_delta"))
