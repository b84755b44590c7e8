"""Pose-only optimization (tracking): fixed-capacity, masked, no host sync.

Counterpart of `sqrtlm_slam_tpu/optim/pose_opt.py`: 4 rounds x 10 LM
iterations; between rounds edges are re-classified by the chi-square gate
(5.991 mono, 7.815 stereo) and the Huber kernel is dropped after round 2.
With LiDAR observations a tight-coupling stage follows: point-to-plane
(weight 50) and point-to-point (weight 30) unary edges on the same pose,
10 more LM iterations over the fused system. Association (the NN search)
happens outside; this module takes pre-associated targets with masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..factors import lidar as lidar_factors
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


class LidarObs(NamedTuple):
    """Padded pre-associated LiDAR observations for tight coupling."""

    flat_pts: torch.Tensor  # (F, 3) sensor-frame flat points
    plane_n: torch.Tensor  # (F, 3) associated plane normals (world)
    plane_d: torch.Tensor  # (F,) plane offsets
    flat_valid: torch.Tensor  # (F,) bool
    corner_pts: torch.Tensor  # (C, 3) sensor-frame corner points
    corner_target: torch.Tensor  # (C, 3) associated world targets
    corner_valid: torch.Tensor  # (C,) bool
    flat_weight: float = 50.0
    corner_weight: float = 30.0


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


def _lidar_system(pose, lobs: LidarObs, robust_delta: Optional[float] = None):
    """H (6,6), b (6,), chi2 of the masked plane and point edges."""
    rf, Jf = lidar_factors.plane_residual_jac(pose, lobs.flat_pts, lobs.plane_n, lobs.plane_d)
    wf = lobs.flat_weight * lobs.flat_valid.to(rf.dtype)
    e2f = wf * rf * rf
    if robust_delta is not None:
        wf = wf * losses.huber(robust_delta)(e2f)[1]
    Hf = torch.einsum("fi,f,fj->ij", Jf, wf, Jf)
    bf = torch.einsum("fi,f,f->i", Jf, wf, rf)

    rc, Jc = lidar_factors.point_residual_jac(pose, lobs.corner_pts, lobs.corner_target)
    wc = lobs.corner_weight * lobs.corner_valid.to(rc.dtype)
    e2c = wc * torch.sum(rc * rc, dim=-1)
    if robust_delta is not None:
        wc = wc * losses.huber(robust_delta)(e2c)[1]
    Hc = torch.einsum("cki,c,ckj->ij", Jc, wc, Jc)
    bc = torch.einsum("cki,c,ck->i", Jc, wc, rc)
    return Hf + Hc, bf + bc, torch.sum(e2f) + torch.sum(e2c)


def optimize_pose(pose0: se3.SE3, obs: VisualObs, cam: reproj.Camera,
                  lidar_obs: Optional[LidarObs] = None, rounds: int = 4,
                  iters_per_round: int = 10, lidar_iters: int = 10,
                  huber_delta: float = math.sqrt(losses.CHI2_2DOF)) -> PoseOptResult:
    """Tracking pose optimization (visual rounds + the optional LiDAR stage)."""
    is_stereo = obs.uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    pose = pose0
    active = obs.valid
    for rnd in range(rounds):
        delta = huber_delta if rnd < 2 else None

        def system_fn(p, _active=active, _delta=delta):
            H, b, chi2, _ = _visual_system(p, obs, cam, _active, _delta)
            return H, b, chi2

        pose = lm_optimize(pose, system_fn, num_iters=iters_per_round).params
        _, _, _, e2 = _visual_system(pose, obs, cam, obs.valid, None)
        active = obs.valid & (e2 <= gate)

    if lidar_obs is not None:
        def fused_system(p, _active=active):
            Hv, bv, c2v, _ = _visual_system(p, obs, cam, _active, None)
            Hl, bl, c2l = _lidar_system(p, lidar_obs)
            return Hv + Hl, bv + bl, c2v + c2l

        pose = lm_optimize(pose, fused_system, num_iters=lidar_iters).params

    # Final classification over the full valid mask (see the JAX package).
    _, _, chi2, e2 = _visual_system(pose, obs, cam, obs.valid, None)
    inliers = obs.valid & (e2 <= gate)
    return PoseOptResult(pose=pose, inlier_mask=inliers,
                         num_inliers=torch.sum(inliers.to(torch.int32)), chi2=chi2)
