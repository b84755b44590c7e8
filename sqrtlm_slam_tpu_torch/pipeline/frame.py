"""Frame construction: ORB extraction + depth association.

Counterpart of `sqrtlm_slam_tpu/pipeline/frame.py`: ORB runs on the image's
device; each keypoint takes the nearest valid depth of an 8x14 patch of the
depth image unless the patch spans more than 2 m (unstable), and
depth-carrying keypoints get a stereo-style pseudo observation
``u_right = u - bf / z``. The depth image is given (RGB-D) or projected from
a LiDAR cloud (fusion); with a `LidarConfig` the cloud's corner / flat
features are extracted in the LiDAR frame and carried, in the camera frame,
on `Frame.lidar` for the tight coupling.

A rectified stereo pair (`build_frame_stereo`) runs ORB on both images,
matches left to right inside a row band and a disparity range (one K1
launch), and refines each match to subpixel by a 5x5 SAD search along the
row with a parabola fit. Without any depth source every keypoint is
monocular (`u_right = -1`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..factors.reprojection import Camera
from ..frontend import matching, orb
from ..lidar import features as lidar_features


class Frame(NamedTuple):
    """Per-frame feature data (fixed capacity = ORBConfig.max_features)."""

    kp: orb.Keypoints
    uvr: torch.Tensor  # (N, 3) [u, v, u_right]; u_right < 0 -> mono
    depth: torch.Tensor  # (N,) associated depth (<= 0 -> none)
    inv_sigma2: torch.Tensor  # (N,) information by pyramid level
    # (N,) vocabulary word ids: the JAX package defines the field and never
    # sets or reads it; kept so that code written for its Frame runs here.
    words: Optional[torch.Tensor] = None
    lidar: Optional[lidar_features.LidarFeatures] = None  # fusion coupling


@functools.lru_cache(maxsize=16)
def _level_sigma2_on(orb_cfg: orb.ORBConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(orb.level_sigma2(orb_cfg), device=device)


def project_cloud_to_depth_image(cloud_cam: torch.Tensor, cam: Camera, height: int,
                                 width: int, valid: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Project a camera-frame cloud (N, 3) to a sparse depth image, keeping
    the nearest point per pixel. Returns (H, W) depth, 0 where empty. Rows
    holding NaN are inert (NaN fails z > 0.1)."""
    z = cloud_cam[:, 2]
    ok = z > 0.1
    zs = torch.where(ok, z, torch.ones_like(z))
    u = cam.fx * cloud_cam[:, 0] / zs + cam.cx
    v = cam.fy * cloud_cam[:, 1] / zs + cam.cy
    # Outside the image either way; keeps the int conversion defined.
    u = torch.clamp(torch.nan_to_num(u, nan=-2.0), -2.0, width + 1.0)
    v = torch.clamp(torch.nan_to_num(v, nan=-2.0), -2.0, height + 1.0)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    ok = ok & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    if valid is not None:
        ok = ok & valid
    flat = torch.where(ok, vi * width + ui, torch.full_like(ui, height * width))
    big = 1e9
    depth = torch.full((height * width + 1,), big, dtype=z.dtype, device=z.device)
    depth = depth.scatter_reduce(0, flat, torch.where(ok, z, torch.full_like(z, big)),
                                 reduce="amin", include_self=True)[: height * width]
    return torch.where(depth < big, depth, torch.zeros_like(depth)).reshape(height, width)


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


def stereo_match(kp_l: orb.Keypoints, kp_r: orb.Keypoints, bf: float,
                 min_depth: float = 0.5, max_row_diff: float = 2.0):
    """Rectified left-right ORB matching: a row band (|dv| <= max_row_diff)
    and a disparity range (0.1 < u_l - u_r <= bf / min_depth), mutual best
    with a 0.9 ratio test. Returns (u_right (N,), depth (N,)); u_right = -1
    and depth 0 where unmatched."""
    dv = torch.abs(kp_l.xy[:, None, 1] - kp_r.xy[None, :, 1])
    disp = kp_l.xy[:, None, 0] - kp_r.xy[None, :, 0]
    window = (dv <= max_row_diff) & (disp > 0.1) & (disp <= bf / min_depth)
    res = matching.match_descriptors(kp_l.desc, kp_r.desc, kp_l.valid, kp_r.valid,
                                     window_mask=window, max_dist=matching.TH_HIGH, ratio=0.9,
                                     mutual=True)
    u_r = kp_r.xy[res.idx.long(), 0]
    disparity = kp_l.xy[:, 0] - u_r
    ok = res.valid & (disparity > 0.1)
    u_right = torch.where(ok, u_r, torch.full_like(u_r, -1.0))
    depth = torch.where(ok, bf / torch.clamp(disparity, min=0.1), torch.zeros_like(u_r))
    return u_right, depth


def refine_stereo_subpixel(img_l: torch.Tensor, img_r: torch.Tensor, kp_xy: torch.Tensor,
                           u_right: torch.Tensor, bf: float, patch: int = 5, search: int = 5):
    """Subpixel disparity: the SAD of the keypoint's `patch` x `patch`
    window against the right image at 2 `search` + 1 integer offsets around
    the match, the first minimum (kept off the ends) and a parabola through
    it and its neighbours. Pixel coordinates truncate toward zero; rows
    without a match (u_right < 0) stay without one. Returns (u_right',
    depth')."""
    H, W = img_l.shape
    dev = img_l.device
    half = patch // 2
    ys = torch.clamp(kp_xy[:, 1].to(torch.int64), half, H - half - 1)
    xl = torch.clamp(kp_xy[:, 0].to(torch.int64), half, W - half - 1)
    r = torch.arange(-half, half + 1, device=dev)
    dy, dx = r[:, None], r[None, :]
    patch_l = img_l[ys[:, None, None] + dy, xl[:, None, None] + dx]  # (N, p, p)
    offs = torch.arange(-search, search + 1, device=dev)
    xr0 = torch.clamp(u_right.to(torch.int64), half + search, W - half - search - 1)
    xr = xr0[:, None] + offs[None, :]  # (N, S)
    patch_r = img_r[ys[:, None, None, None] + dy, xr[:, :, None, None] + dx]  # (N, S, p, p)
    sad = torch.sum(torch.abs(patch_r - patch_l[:, None]), dim=(-2, -1))  # (N, S)

    best = torch.clamp(torch.argmin(sad, dim=1), 1, 2 * search - 1)
    c0, c1, c2 = (torch.gather(sad, 1, (best + k)[:, None])[:, 0] for k in (-1, 0, 1))
    denom = c0 + c2 - 2 * c1
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (c0 - c2) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    u_ref = xr0.to(img_l.dtype) + best.to(img_l.dtype) - search + delta
    disparity = kp_xy[:, 0] - u_ref
    ok = (u_right >= 0) & (disparity > 0.1)
    u_out = torch.where(ok, u_ref, torch.full_like(u_ref, -1.0))
    depth = torch.where(ok, bf / torch.clamp(disparity, min=0.1), torch.zeros_like(u_ref))
    return u_out, depth


def _frame_from(kp: orb.Keypoints, u_right, depth, orb_cfg: orb.ORBConfig, lidar=None) -> Frame:
    uvr = torch.cat([kp.xy, u_right[:, None]], dim=-1)
    sigma2 = _level_sigma2_on(orb_cfg, kp.xy.device)
    inv_sigma2 = 1.0 / sigma2[torch.clamp(kp.octave.long(), 0, orb_cfg.num_levels - 1)]
    return Frame(kp=kp, uvr=uvr, depth=depth, inv_sigma2=inv_sigma2, lidar=lidar)


def build_frame_stereo(img_left: torch.Tensor, img_right: torch.Tensor, cam: Camera,
                       orb_cfg: orb.ORBConfig) -> Frame:
    """Stereo frame: ORB on both images, row-band matching for depth, the
    subpixel refinement (all on the images' device)."""
    kp_l = orb.extract(img_left, orb_cfg)
    kp_r = orb.extract(img_right, orb_cfg)
    u_right, _ = stereo_match(kp_l, kp_r, cam.bf)
    u_right, depth = refine_stereo_subpixel(img_left, img_right, kp_l.xy, u_right, cam.bf)
    return _frame_from(kp_l, u_right, depth, orb_cfg)


def build_frame(image: torch.Tensor, cam: Camera, orb_cfg: orb.ORBConfig,
                depth_img: Optional[torch.Tensor] = None,
                cloud_cam: Optional[torch.Tensor] = None,
                cloud_lidar: Optional[torch.Tensor] = None,
                T_cam_lidar: Optional[tuple] = None,
                lidar_cfg: Optional[lidar_features.LidarConfig] = None) -> Frame:
    """Extract ORB and associate depth from a depth image or a LiDAR cloud
    (all on the image's device). `cloud_lidar` (N, 3) is in the LiDAR frame
    (x forward, z up) with `T_cam_lidar` = (R (3, 3), t (3,)) the extrinsics
    (identity when None); `cloud_cam` is a cloud already in the camera frame.
    With `lidar_cfg`, feature extraction runs on `cloud_lidar` and the
    features are brought into the camera frame. Without any depth source
    every keypoint is monocular."""
    kp = orb.extract(image, orb_cfg)
    dev = kp.xy.device
    H, W = image.shape
    lidar = None
    if cloud_lidar is not None:
        if T_cam_lidar is not None:
            R_cl, t_cl = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in T_cam_lidar)
        else:
            R_cl, t_cl = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        if lidar_cfg is not None:
            feat = lidar_features.extract_features(cloud_lidar, lidar_cfg)
            lidar = lidar_features.transform_features(feat, R_cl, t_cl)
        if cloud_cam is None:
            cloud_cam = torch.sum(cloud_lidar[:, None, :3] * R_cl[None], dim=-1) + t_cl
    if depth_img is None and cloud_cam is not None:
        depth_img = project_cloud_to_depth_image(cloud_cam, cam, H, W)
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
    return _frame_from(kp, u_right, depth, orb_cfg, lidar)
