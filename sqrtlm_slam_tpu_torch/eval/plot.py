"""Trajectory / map visualization (headless artifacts in place of rviz).

Counterpart of `sqrtlm_slam_tpu/eval/plot.py`: a top-down trajectory figure
with optional ground truth, comparison overlays and the landmark cloud, and
a multi-panel snapshot of `SlamSystem.get_slam_result()`. Takes numpy
arrays; matplotlib is imported inside each function, not with the module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(
    out_path: str,
    est: np.ndarray,
    gt: Optional[np.ndarray] = None,
    comparisons: Optional[dict] = None,
    landmarks: Optional[np.ndarray] = None,
    title: str = "trajectory",
):
    """est/gt: (F, 4, 4) cam-to-world pose arrays; comparisons: name -> (F,4,4).

    Writes a top-down (x-z) PNG. Matches the reference's overlay protocol
    (fusionsystem.cc:114-190 loads prior ORB-SLAM2 runs for comparison)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if landmarks is not None and len(landmarks):
        ax.scatter(
            landmarks[:, 0], landmarks[:, 2], s=0.5, c="#cccccc", label="landmarks"
        )
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k--", lw=1.2, label="ground truth")
    ax.plot(est[:, 0, 3], est[:, 2, 3], "-", lw=1.5, label="estimate")
    for name, traj in (comparisons or {}).items():
        ax.plot(traj[:, 0, 3], traj[:, 2, 3], lw=1.0, alpha=0.7, label=name)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def render_slam_result(
    result: dict,
    out_path: str,
    gt: Optional[np.ndarray] = None,
    depth_image: Optional[np.ndarray] = None,
    range_image: Optional[np.ndarray] = None,
):
    """Render a `SlamSystem.get_slam_result()` snapshot to one multi-panel
    PNG — the headless equivalent of the reference's `Visualization()`
    thread (fusionsystem.cc:224-586: KF markers, global/local map clouds,
    LiDAR feature clouds, depth/range images, GT overlay).

    Panels: (1) top-down map with keyframe markers, global + local map
    clouds and the trajectory; (2) the current KF's LiDAR corner/flat
    feature clouds (if present); (3/4) depth / range images (if given).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    have_lidar = "lidar_corner" in result
    n_img = int(depth_image is not None) + int(range_image is not None)
    ncols = 1 + int(have_lidar) + n_img
    fig, axes = plt.subplots(1, ncols, figsize=(7 * ncols, 7))
    if ncols == 1:
        axes = [axes]
    axes = list(np.atleast_1d(axes))

    ax = axes[0]
    mp = result.get("map_points")
    if mp is not None and len(mp):
        ax.scatter(mp[:, 0], mp[:, 2], s=0.4, c="#cccccc", label="map")
    lmp = result.get("local_map_points")
    if lmp is not None and len(lmp):
        ax.scatter(lmp[:, 0], lmp[:, 2], s=0.8, c="#e07030", label="local map")
    traj = result.get("trajectory")
    if traj is not None and len(traj):
        ax.plot(traj[:, 0, 3], traj[:, 2, 3], "-", lw=1.4, label="trajectory")
    if gt is not None and len(gt):
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k--", lw=1.0, label="ground truth")
    kf_R, kf_t = result.get("kf_R"), result.get("kf_t")
    if kf_R is not None and len(kf_R):
        # Camera centers C = -R^T t (poses are world->camera), as the
        # keyframe marker cloud (fusionsystem.cc keyframe markers).
        C = -np.einsum("kji,kj->ki", kf_R, kf_t)
        ax.scatter(C[:, 0], C[:, 2], s=14, marker="^", c="#3060c0", label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(
        f"state={result.get('state')} kfs={len(result.get('kf_ids', []))} "
        f"inliers={result.get('num_inliers')}"
    )

    i = 1
    if have_lidar:
        ax = axes[i]
        i += 1
        fc = result["lidar_corner"]
        ff = result["lidar_flat"]
        if len(ff):
            ax.scatter(ff[:, 0], ff[:, 2], s=0.6, c="#70b070", label="flat")
        if len(fc):
            ax.scatter(fc[:, 0], fc[:, 2], s=2.0, c="#c04040", label="corner")
        ax.set_aspect("equal")
        ax.legend(loc="best", fontsize=8)
        ax.set_title("LiDAR features (ref KF, camera frame)")
    for img, name in ((depth_image, "depth image"), (range_image, "range image")):
        if img is None:
            continue
        ax = axes[i]
        i += 1
        masked = np.ma.masked_less_equal(np.asarray(img, np.float32), 0.0)
        im = ax.imshow(masked, cmap="viridis", aspect="auto")
        fig.colorbar(im, ax=ax, shrink=0.7)
        ax.set_title(name)

    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
