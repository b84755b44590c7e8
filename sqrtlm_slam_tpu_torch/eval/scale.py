"""KITTI-00-class synthetic map for the global-BA-at-scale measurement.

Counterpart of `sqrtlm_slam_tpu/eval/scale.py` (numpy in both packages):
a `MapStore` the size of a long sequence (600 keyframes, 1.2e5 landmarks
by default) built without the frontend: ground-truth ring geometry,
odometry drift integrated along the trajectory, landmarks placed through
the drifted pose of their home keyframe, and every observation table filled
by vectorized array writes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..factors.reprojection import Camera
from ..mapstore import MapStore
from .ate import ate_rmse


def make_scale_store(n_kf: int = 600, n_lm: int = 120_000, obs_per_lm: int = 5,
                     drift: float = 3e-4, radius: float = 80.0, seed: int = 0,
                     cam: Camera = Camera(fx=220.0, fy=220.0, cx=160.0, cy=120.0, bf=44.0)
                     ) -> Tuple[MapStore, np.ndarray, np.ndarray]:
    """Returns (store, true_R (K,3,3), true_t (K,3)), T_cw convention.

    Landmark l has a home keyframe h and is observed by keyframes
    h..h+obs_per_lm-1. Pixel measurements come from the true geometry; the
    stored poses and landmarks carry the integrated drift, so global BA has
    a real, loop-consistent error field to work against."""
    rng = np.random.RandomState(seed)

    # True ring trajectory (camera +z forward, XZ plane).
    a = 2 * np.pi * np.arange(n_kf) / n_kf
    centers = np.stack([np.cos(a) * radius, np.zeros(n_kf), np.sin(a) * radius], -1)
    fwd = np.stack([-np.sin(a), np.zeros(n_kf), np.cos(a)], -1)
    up = np.tile(np.array([0.0, -1.0, 0.0]), (n_kf, 1))
    R_wc = np.stack([np.cross(up, fwd), -up, fwd], axis=-1)
    true_R = np.ascontiguousarray(R_wc.transpose(0, 2, 1)).astype(np.float32)
    true_t = -np.einsum("kij,kj->ki", true_R, centers).astype(np.float32)

    # Drifted estimates: integrate the true relatives plus noise.
    est_R = np.zeros_like(true_R)
    est_t = np.zeros_like(true_t)
    est_R[0], est_t[0] = true_R[0], true_t[0]
    for k in range(1, n_kf):
        R_rel = true_R[k] @ true_R[k - 1].T
        t_rel = true_t[k] - R_rel @ true_t[k - 1]
        w = rng.normal(0, drift, 3)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        u, _, vt = np.linalg.svd(R_rel @ (np.eye(3) + Wx))
        R_n = u @ vt
        t_n = t_rel + rng.normal(0, drift * 40, 3)
        est_R[k] = (R_n @ est_R[k - 1]).astype(np.float32)
        est_t[k] = (R_n @ est_t[k - 1] + t_n).astype(np.float32)

    # Landmarks: home KF h, true position sampled in h's frustum.
    home = rng.randint(0, n_kf - obs_per_lm, size=n_lm)
    z = rng.uniform(6.0, 30.0, n_lm)
    u_px = rng.uniform(8, 2 * cam.cx - 8, n_lm)
    v_px = rng.uniform(8, 2 * cam.cy - 8, n_lm)
    x_c = np.stack([(u_px - cam.cx) * z / cam.fx, (v_px - cam.cy) * z / cam.fy, z],
                   -1).astype(np.float32)
    p_true = np.einsum("lji,lj->li", true_R[home], x_c - true_t[home])
    p_est = np.einsum("lji,lj->li", est_R[home], x_c - est_t[home])

    feats_per_kf = int(np.ceil(n_lm * obs_per_lm / n_kf * 1.25)) + 8
    store = MapStore(max_keyframes=n_kf, max_landmarks=n_lm, feats_per_kf=feats_per_kf,
                     obs_per_landmark=obs_per_lm + 2, num_words=16)

    # Observations at the true projection (+ pixel noise); keypoint slots
    # per keyframe from running counters.
    li = np.repeat(np.arange(n_lm), obs_per_lm)
    kfs = (home[:, None] + np.arange(obs_per_lm)[None, :]).reshape(-1)
    xc_obs = np.einsum("eij,ej->ei", true_R[kfs], p_true[li]) + true_t[kfs]
    zs = np.maximum(xc_obs[:, 2], 1e-3)
    u_obs = cam.fx * xc_obs[:, 0] / zs + cam.cx + rng.normal(0, 0.4, len(zs))
    v_obs = cam.fy * xc_obs[:, 1] / zs + cam.cy + rng.normal(0, 0.4, len(zs))
    order = np.argsort(kfs, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    sorted_kfs = kfs[order]
    starts = np.searchsorted(sorted_kfs, np.arange(n_kf))
    slots = (np.arange(len(kfs)) - starts[sorted_kfs])[inv]
    keep = slots < feats_per_kf
    li, kfs, slots = li[keep], kfs[keep], slots[keep]
    u_obs, v_obs = u_obs[keep], v_obs[keep]

    store.num_kf = n_kf
    store.kf_valid[:] = True
    store.kf_R[:] = est_R
    store.kf_t[:] = est_t
    store.kf_frame_id[:] = np.arange(n_kf)
    store.kf_xy[kfs, slots] = np.stack([u_obs, v_obs], -1)
    store.kf_uvr[kfs, slots] = np.stack([u_obs, v_obs, np.full_like(u_obs, -1.0)], -1)
    store.kf_kp_valid[kfs, slots] = True
    store.kf_obs_lm[kfs, slots] = li
    store.parent[0] = -1
    store.parent[1:n_kf] = np.arange(n_kf - 1)

    store.num_lm = n_lm
    store.lm_valid[:] = True
    store.lm_pos[:] = p_est
    store.lm_first_kf[:] = home
    store.lm_n_obs[:] = np.bincount(li, minlength=n_lm)
    ord_lm = np.argsort(li, kind="stable")
    lstarts = np.searchsorted(li[ord_lm], np.arange(n_lm))
    col = np.arange(len(li)) - lstarts[li[ord_lm]]
    store.lm_obs_kf[li[ord_lm], col] = kfs[ord_lm]
    store.lm_obs_idx[li[ord_lm], col] = slots[ord_lm]

    # Covisibility: consecutive keyframes share ~obs_per_lm windows.
    offs = np.arange(1, obs_per_lm)
    ii = np.repeat(np.arange(n_kf), len(offs))
    jj = (ii.reshape(n_kf, -1) + offs[None, :]).reshape(-1)
    ok = jj < n_kf
    w = int(n_lm * obs_per_lm / n_kf / 2)
    store.covis[ii[ok], jj[ok]] = w
    store.covis[jj[ok], ii[ok]] = w
    return store, true_R, true_t


def store_ate(store: MapStore, true_R: np.ndarray, true_t: np.ndarray) -> float:
    """Umeyama-aligned (with scale) ATE RMSE of the store's keyframe
    trajectory."""
    K = store.num_kf
    est = np.tile(np.eye(4), (K, 1, 1))
    gt = np.tile(np.eye(4), (K, 1, 1))
    est[:, :3, :3] = store.kf_R[:K].transpose(0, 2, 1)
    est[:, :3, 3] = -np.einsum("kji,kj->ki", store.kf_R[:K], store.kf_t[:K])
    gt[:, :3, :3] = true_R.transpose(0, 2, 1)
    gt[:, :3, 3] = -np.einsum("kji,kj->ki", true_R, true_t)
    return ate_rmse(est, gt)[0]
