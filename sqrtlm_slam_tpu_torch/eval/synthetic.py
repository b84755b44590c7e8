"""Synthetic textured-point world and BA problems, in numpy.

Counterpart of `sqrtlm_slam_tpu/eval/synthetic.py` without JAX, so the
port's checks and benchmarks can make their inputs where JAX is absent:
  * `SyntheticWorld.render` is the same numpy renderer (identical images
    for identical poses);
  * `forward_trajectory` builds the same poses with numpy float32 SE(3) math;
  * `ring_world` and `ring_trajectory` are the loop-closure ring scene;
  * `make_ba_problem` draws the same kind of problem from
    `np.random.RandomState` (different numbers than the JAX generator, which
    uses `jax.random`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from ..factors.reprojection import Camera


class Pose(NamedTuple):
    """World->camera transform ``x_c = R x_w + t`` (numpy float32)."""

    R: np.ndarray  # (3, 3)
    t: np.ndarray  # (3,)


class SyntheticWorld:
    def __init__(self, seed: int = 0, n_points: int = 800,
                 extent=((-10.0, 10.0), (-5.0, 5.0), (2.0, 80.0)), pattern_size: int = 7):
        rng = np.random.RandomState(seed)
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.points = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float32)
        self.patterns = (
            rng.rand(n_points, pattern_size, pattern_size) > 0.45
        ).astype(np.float32) * rng.uniform(120, 230, size=(n_points, 1, 1)).astype(np.float32)
        self.pattern_size = pattern_size

    # Physical pattern scale: patches project to `pattern_size` px here.
    ref_depth: float = 18.0

    def render(self, T_cw, cam: Camera, H: int = 240, W: int = 320):
        """Render (image, depth) float32 arrays from pose T_cw (any object with
        `.R`, `.t` convertible to numpy). Far points first (painter)."""
        R = np.asarray(T_cw.R)
        t = np.asarray(T_cw.t)
        x_c = self.points @ R.T + t
        z = x_c[:, 2]
        u = cam.fx * x_c[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * x_c[:, 1] / np.maximum(z, 1e-6) + cam.cy
        ps = self.pattern_size
        size = np.clip(
            np.round(ps * self.ref_depth / np.maximum(z, 1e-6)).astype(np.int32), 3, 3 * ps,
        )
        size = size + (1 - size % 2)
        half_all = size // 2
        ok = (
            (z > self.ref_depth / 3.0)
            & (u >= half_all + 1) & (u < W - half_all - 1)
            & (v >= half_all + 1) & (v < H - half_all - 1)
        )
        img = np.full((H, W), 25.0, np.float32)
        depth = np.zeros((H, W), np.float32)
        order = np.argsort(-z)
        interp = {}
        for s in np.unique(size[ok]):
            s = int(s)
            if s >= ps:  # upsampling: bilinear
                g = np.linspace(0, ps - 1, s)
                i0 = np.floor(g).astype(np.int32)
                i1 = np.minimum(i0 + 1, ps - 1)
                interp[s] = (i0, i1, (g - i0).astype(np.float32))
            else:  # downsampling: nearest
                interp[s] = ((np.arange(s) * ps // s).astype(np.int32),) * 2 + (
                    np.zeros(s, np.float32),
                )
        for i in order:
            if not ok[i]:
                continue
            s = int(size[i])
            half = s // 2
            i0, i1, w = interp[s]
            P = self.patterns[i]
            rows = P[i0] * (1 - w)[:, None] + P[i1] * w[:, None]
            pat = rows[:, i0] * (1 - w)[None, :] + rows[:, i1] * w[None, :]
            ui, vi = int(round(u[i])), int(round(v[i]))
            sl = (slice(vi - half, vi + half + 1), slice(ui - half, ui + half + 1))
            img[sl] = np.maximum(img[sl], pat)
            depth[sl] = z[i]
        return img, depth


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], np.float32)


def se3_exp(xi: np.ndarray) -> Pose:
    """SE(3) exponential of ``[rho, phi]`` in float32 (as the JAX package)."""
    xi = np.asarray(xi, np.float32)
    rho, phi = xi[:3], xi[3:]
    theta2 = np.float32(np.sum(phi * phi))
    theta = np.sqrt(theta2 + np.float32(1e-16))
    W = _hat(phi)
    W2 = W @ W
    if theta2 < 1e-8:
        a = np.float32(1.0) - theta2 / np.float32(6.0)
        b = np.float32(0.5) - theta2 / np.float32(24.0)
        c = np.float32(1.0 / 6.0) - theta2 / np.float32(120.0)
    else:
        a = np.sin(theta) / theta
        b = (np.float32(1.0) - np.cos(theta)) / theta2
        c = (theta - np.sin(theta)) / (theta2 * theta)
    eye = np.eye(3, dtype=np.float32)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return Pose(R.astype(np.float32), (V @ rho).astype(np.float32))


def forward_trajectory(n_frames: int, step: float = 0.4, yaw_rate: float = 0.004) -> List[Pose]:
    """Ground-truth T_cw poses for a gently curving forward path."""
    poses = []
    T = Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    delta = se3_exp(np.array([0.0, 0.0, -step, 0.0, yaw_rate, 0.0], np.float32))
    for _ in range(n_frames):
        poses.append(T)
        T = Pose((delta.R @ T.R).astype(np.float32),
                 (delta.R @ T.t + delta.t).astype(np.float32))
    return poses


def ring_world(seed: int = 0, n_points: int = 2000, radius: float = 12.0, band: float = 6.0,
               pattern_size: int = 7) -> SyntheticWorld:
    """World with points scattered in an annulus around a circular path,
    re-observable from every point of the ring (loop-closure scenes)."""
    w = SyntheticWorld(seed=seed, n_points=n_points, pattern_size=pattern_size)
    rng = np.random.RandomState(seed + 1)
    a = rng.uniform(0, 2 * np.pi, n_points)
    r = radius + rng.uniform(-band, band, n_points)
    w.points = np.stack([np.cos(a) * r, rng.uniform(-2.0, 2.0, n_points), np.sin(a) * r],
                        axis=-1).astype(np.float32)
    # Looking tangent, the circle leaves the band after an arc of
    # ~sqrt(2 * radius * band): the typical sight distance sets the
    # physical pattern scale.
    w.ref_depth = float(max(band + 2.0, np.sqrt(2.0 * radius * band)))
    return w


def ring_trajectory(n_frames: int, radius: float = 12.0, frac: float = 1.0) -> List[Pose]:
    """T_cw poses driving around a circle in the XZ plane, heading tangent;
    `frac` > 1 re-traverses the start (loop closure)."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c_w = np.array([np.cos(a) * radius, 0.0, np.sin(a) * radius])
        fwd = np.array([-np.sin(a), 0.0, np.cos(a)])  # camera +z
        up = np.array([0.0, -1.0, 0.0])  # camera +y points down
        R_wc = np.stack([np.cross(up, fwd), -up, fwd], axis=-1)
        R_cw = R_wc.T
        poses.append(Pose(R_cw.astype(np.float32), (-R_cw @ c_w).astype(np.float32)))
    return poses


DEFAULT_CAM = Camera(fx=220.0, fy=220.0, cx=160.0, cy=120.0, bf=44.0)


def make_ba_problem(seed: int = 0, P: int = 8, L: int = 256, cam: Camera = DEFAULT_CAM,
                    noise: float = 0.3, pose_noise: float = 0.05, point_noise: float = 0.05,
                    stereo_frac: float = 0.6, n_fixed: int = 2, spacing: float = 0.15,
                    obs_per_landmark: int = 0, min_depth: float = 0.0):
    """Synthetic flat BA problem (numpy), the layout of the JAX generator:
    poses on a rough line looking down +z, landmarks ahead, a perturbed
    initial estimate. `obs_per_landmark > 0` gives sparse covisibility (each
    landmark seen by that many consecutive poses around its home pose).
    `min_depth > 0` marks observations whose true depth is below it invalid
    (at tens of thousands of landmarks a few fall next to a camera's
    z = 0 plane, where no float32 evaluation is accurate). Returns
    (schur_bucketed.BAProblem, (R_true (P,3,3), t_true (P,3)))."""
    from ..optim.schur_bucketed import BAProblem

    rng = np.random.RandomState(seed)
    f32 = np.float32
    c_true = np.stack([np.arange(P) * spacing, np.zeros(P), np.zeros(P)], -1) \
        + rng.randn(P, 3) * 0.1
    w_true = rng.randn(P, 3) * 0.02
    R_true = np.stack([se3_exp(np.concatenate([np.zeros(3), w])).R for w in w_true])
    t_true = -np.einsum("pij,pj->pi", R_true, c_true).astype(f32)
    points_true = (rng.randn(L, 3) * np.array([6.0, 3.0, 4.0])
                   + np.array([P * spacing / 2.0, 0.0, 18.0])).astype(f32)
    if obs_per_landmark > 0:
        home = (np.arange(L) * P) // L
        obs_cam = np.clip(home[:, None] + np.arange(obs_per_landmark)[None, :], 0, P - 1)
        obs_cam = obs_cam.reshape(-1).astype(np.int32)
        obs_pt = np.repeat(np.arange(L, dtype=np.int32), obs_per_landmark)
    else:
        obs_cam = np.repeat(np.arange(P, dtype=np.int32), L)
        obs_pt = np.tile(np.arange(L, dtype=np.int32), P)
    E = obs_cam.shape[0]
    x_c = np.einsum("eij,ej->ei", R_true[obs_cam], points_true[obs_pt]) + t_true[obs_cam]
    z = x_c[:, 2]
    uv = np.stack([cam.fx * x_c[:, 0] / z + cam.cx, cam.fy * x_c[:, 1] / z + cam.cy], -1)
    uv = uv + rng.randn(E, 2) * noise
    ur = uv[:, 0] - cam.bf / z + rng.randn(E) * noise
    is_stereo = rng.rand(E) < stereo_frac
    uvr = np.concatenate([uv, np.where(is_stereo, ur, -1.0)[:, None]], -1).astype(f32)

    dpose = rng.randn(P, 6) * np.array([1, 1, 1, 0.3, 0.3, 0.3]) * pose_noise
    dpose[:n_fixed] = 0.0
    R_init = np.empty_like(R_true)
    t_init = np.empty_like(t_true)
    for p in range(P):
        d = se3_exp(dpose[p])
        R_init[p] = d.R @ R_true[p]
        t_init[p] = d.R @ t_true[p] + d.t
    points_init = (points_true + rng.randn(L, 3) * point_noise).astype(f32)
    problem = BAProblem(
        pose_R=R_init.astype(f32), pose_t=t_init.astype(f32),
        pose_fixed=np.arange(P) < n_fixed, pose_valid=np.ones(P, bool),
        points=points_init, point_valid=np.ones(L, bool),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uvr=uvr,
        obs_inv_sigma2=np.ones(E, f32),
        obs_valid=z >= min_depth if min_depth > 0 else np.ones(E, bool),
    )
    return problem, (R_true.astype(f32), t_true)
