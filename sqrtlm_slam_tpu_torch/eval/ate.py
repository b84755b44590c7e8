"""Trajectory error (evo `-as` protocol) in numpy.

Counterpart of `sqrtlm_slam_tpu/eval/ate.py`: Umeyama alignment (with or
without scale) of the estimated camera centres onto ground truth, then the
RMSE of the translation residuals (ATE); and the relative pose error over
fixed frame steps (RPE), a drift measure beside it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) minimizing ||s R src + t - dst||^2 over (N, 3) point sets."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.ones(3)
    S[2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ (S[:, None] * Vt)
    s = (D * S).sum() / max((sc * sc).sum() / len(src), 1e-12) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align_scale: bool = True) -> Tuple[float, np.ndarray]:
    """ATE RMSE between (F, 4, 4) camera-to-world pose arrays."""
    est = np.asarray(est_poses)[:, :3, 3]
    gt = np.asarray(gt_poses)[:, :3, 3]
    s, R, t = umeyama(est, gt, with_scale=align_scale)
    aligned = s * est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1)))), aligned


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame steps of (F, 4, 4)
    camera-to-world poses: (translation RMSE, rotation RMSE in degrees)."""
    def rel(poses):
        return np.linalg.inv(poses[:-delta]) @ poses[delta:]

    E = np.linalg.inv(rel(gt_poses)) @ rel(est_poses)
    t_err = np.linalg.norm(E[:, :3, 3], axis=-1)
    cos_r = np.clip((np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    r_err = np.degrees(np.arccos(cos_r))
    return float(np.sqrt((t_err**2).mean())), float(np.sqrt((r_err**2).mean()))
