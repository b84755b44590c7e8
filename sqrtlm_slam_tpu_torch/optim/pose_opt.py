"""Pose-only optimization (tracking): fixed-capacity, masked, no host sync.

Counterpart of the visual protocol of `sqrtlm_slam_tpu/optim/pose_opt.py`:
4 rounds x 10 LM iterations; between rounds edges are re-classified by the
chi-square gate (5.991 mono, 7.815 stereo) and the Huber kernel is dropped
after round 2. The LiDAR tight-coupling stage is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..factors import reprojection as reproj
from ..geometry import se3
from . import loss as losses
from .lm import lm_optimize


class VisualObs(NamedTuple):
    """Padded pose-only visual observations (capacity E)."""

    points_w: torch.Tensor  # (E, 3) landmark world positions (fixed)
    uvr: torch.Tensor  # (E, 3) [u, v, u_right]; u_right < 0 => mono
    inv_sigma2: torch.Tensor  # (E,)
    valid: torch.Tensor  # (E,) bool


class PoseOptResult(NamedTuple):
    pose: se3.SE3
    inlier_mask: torch.Tensor  # (E,)
    num_inliers: torch.Tensor
    chi2: torch.Tensor


def _visual_system(pose, obs: VisualObs, cam, active, robust_delta):
    """Accumulate H (6,6), b (6,), chi2 over masked visual edges."""
    is_stereo = obs.uvr[..., 2] >= 0.0
    r3, J3, _ = reproj.stereo_residual_jac(pose, obs.points_w, obs.uvr, cam)
    r2, J2, _ = reproj.mono_residual_jac(pose, obs.points_w, obs.uvr[..., :2], cam)
    r2f = torch.cat([r2, torch.zeros_like(r2[..., :1])], dim=-1)
    J2f = torch.cat([J2, torch.zeros_like(J2[..., :1, :])], dim=-2)
    r = torch.where(is_stereo[..., None], r3, r2f)
    J = torch.where(is_stereo[..., None, None], J3, J2f)

    w_info = obs.inv_sigma2 * active.to(r.dtype)
    e2 = w_info * torch.sum(r * r, dim=-1)
    if robust_delta is None:
        w_rob = torch.ones_like(e2)
        rho = e2
    else:
        rho, w_rob, _ = losses.huber(robust_delta)(e2)
    w = w_info * w_rob
    H = torch.einsum("eki,e,ekj->ij", J, w, J)
    b = torch.einsum("eki,e,ek->i", J, w, r)
    chi2 = torch.sum(torch.where(active, rho, torch.zeros_like(rho)))
    return H, b, chi2, e2


def optimize_pose(pose0: se3.SE3, obs: VisualObs, cam: reproj.Camera, rounds: int = 4,
                  iters_per_round: int = 10,
                  huber_delta: float = math.sqrt(losses.CHI2_2DOF)) -> PoseOptResult:
    """Tracking pose optimization (visual rounds)."""
    is_stereo = obs.uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    pose = pose0
    active = obs.valid
    for rnd in range(rounds):
        delta = huber_delta if rnd < 2 else None

        def system_fn(p, _active=active, _delta=delta):
            H, b, chi2, _ = _visual_system(p, obs, cam, _active, _delta)
            return H, b, chi2

        pose = lm_optimize(pose, system_fn, num_iters=iters_per_round)
        _, _, _, e2 = _visual_system(pose, obs, cam, obs.valid, None)
        active = obs.valid & (e2 <= gate)

    # Final classification over the full valid mask (see the JAX package).
    _, _, chi2, e2 = _visual_system(pose, obs, cam, obs.valid, None)
    inliers = obs.valid & (e2 <= gate)
    return PoseOptResult(pose=pose, inlier_mask=inliers,
                         num_inliers=torch.sum(inliers.to(torch.int32)), chi2=chi2)
