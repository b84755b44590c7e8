"""Frame construction: ORB extraction + depth association (RGB-D path).

Counterpart of the depth-image branch of `sqrtlm_slam_tpu/pipeline/frame.py`:
ORB runs on the image's device; each keypoint takes the nearest valid depth
of an 8x14 patch of the depth image unless the patch spans more than 2 m
(unstable), and depth-carrying keypoints get a stereo-style pseudo
observation ``u_right = u - bf / z``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..factors.reprojection import Camera
from ..frontend import orb


class Frame(NamedTuple):
    """Per-frame feature data (fixed capacity = ORBConfig.max_features)."""

    kp: orb.Keypoints
    uvr: torch.Tensor  # (N, 3) [u, v, u_right]; u_right < 0 -> mono
    depth: torch.Tensor  # (N,) associated depth (<= 0 -> none)
    inv_sigma2: torch.Tensor  # (N,) information by pyramid level


@functools.lru_cache(maxsize=16)
def _level_sigma2_on(orb_cfg: orb.ORBConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(orb.level_sigma2(orb_cfg), device=device)


def associate_depth(depth_img: torch.Tensor, xy: torch.Tensor, patch_h: int = 8,
                    patch_w: int = 14, max_range: float = 2.0):
    """Keypoint depth from a patch around each keypoint + stability test.
    Returns (depth (N,), stable (N,) bool)."""
    H, W = depth_img.shape
    dev = depth_img.device
    ys = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
    xs = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
    dys = torch.arange(patch_h, device=dev) - patch_h // 2
    dxs = torch.arange(patch_w, device=dev) - patch_w // 2
    gy = torch.clamp(ys[:, None, None] + dys[None, :, None], 0, H - 1)
    gx = torch.clamp(xs[:, None, None] + dxs[None, None, :], 0, W - 1)
    patch = depth_img[gy, gx].reshape(xy.shape[0], -1)
    has = patch > 0
    inf = torch.full_like(patch, float("inf"))
    dmin = torch.amin(torch.where(has, patch, inf), dim=-1)
    dmax = torch.amax(torch.where(has, patch, -inf), dim=-1)
    stable = torch.any(has, dim=-1) & ((dmax - dmin) < max_range)
    depth = torch.where(stable, dmin, torch.zeros_like(dmin))
    return depth, stable


def build_frame(image: torch.Tensor, cam: Camera, orb_cfg: orb.ORBConfig,
                depth_img: Optional[torch.Tensor] = None) -> Frame:
    """Extract ORB and associate depth from a depth image (both on the same
    device). Without a depth image every keypoint is monocular."""
    kp = orb.extract(image, orb_cfg)
    dev = kp.xy.device
    if depth_img is not None:
        depth, stable = associate_depth(depth_img.to(torch.float32), kp.xy)
    else:
        depth = torch.zeros(kp.capacity, device=dev)
        stable = torch.zeros(kp.capacity, dtype=torch.bool, device=dev)
    u_right = torch.where(
        stable & (depth > 0),
        kp.xy[:, 0] - cam.bf / torch.clamp(depth, min=1e-6),
        torch.full_like(depth, -1.0),
    )
    uvr = torch.cat([kp.xy, u_right[:, None]], dim=-1)
    sigma2 = _level_sigma2_on(orb_cfg, dev)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(kp.octave.long(), 0, orb_cfg.num_levels - 1)]
    return Frame(kp=kp, uvr=uvr, depth=depth, inv_sigma2=inv_sigma2)
