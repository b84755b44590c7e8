"""Synthetic inputs of the monocular initializer's, the flat and cg local
BA's, the flat engine's global BA's, the extrinsic calibration's and
distributed BA's graphs, for holding each graph against its eager run
(`chip_smoke.py` phase 18 and the graph tests). Each function returns
graphed name -> (graphed function, args, kwargs); the arguments lie on the
inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..factors import calibration
from ..factors.reprojection import Camera
from ..geometry import se3
from ..optim import facade, schur, schur_bucketed
from ..optim import loss as losses
from ..parallel import dist_ba
from ..pipeline import initializer

_DELTA = math.sqrt(losses.CHI2_2DOF)  # the robust phases' Huber threshold


def two_view_matches(n: int, cam: Camera, device, seed: int = 0, planar: bool = False):
    """Matched pixels (xy1, xy2, valid) of two views 1.2 m apart with 0.3 px
    of noise and 10 % outliers (40 px), a general scene or a plane, every
    row valid."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-5, 5, (n, 3)) + [0, 0, 14.0]
    if planar:
        X[:, 2] = 14.0 + 0.3 * X[:, 0]
    a = np.array([0.02, -0.1, 0.01])
    th = np.linalg.norm(a)
    k = a / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    X2 = X @ R.T + [-1.2, 0.05, 0.1]

    def project(P):
        return np.stack([cam.fx * P[:, 0] / P[:, 2] + cam.cx,
                         cam.fy * P[:, 1] / P[:, 2] + cam.cy], -1)

    uv2 = project(X2) + rng.normal(size=(n, 2)) * 0.3
    n_out = n // 10
    uv2[:n_out] += rng.normal(size=(n_out, 2)) * 40.0

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    return t(project(X)), t(uv2), torch.ones(n, dtype=torch.bool, device=device)


def init_calls(xy1, xy2, valid, cam: Camera, generator: torch.Generator,
               num_hypotheses: int = 200) -> dict:
    """`_initialize_jit` on matched pixels, the uniforms drawn from
    `generator` in the eager order (F's, then H's)."""
    shape = (num_hypotheses, valid.shape[0])
    u_F = torch.rand(shape, generator=generator, device=valid.device)
    u_H = torch.rand(shape, generator=generator, device=valid.device)
    return {"_initialize_jit": (initializer._initialize_jit,
                                (xy1, xy2, valid, u_F, u_H, None, None), dict(cam=cam))}


def ba_calls(problem: schur_bucketed.BucketedBAProblem, cam: Camera,
             num_iters: int = 5) -> dict:
    """The flat engine's and the cg backend's local-BA graphs at the first
    LM iteration of `problem` (robust, every valid slot active):

      * `flat_local_loop` / `flat_global_loop`: `schur.ba_iterate`'s loop of
        `num_iters` iterations through local BA's and global BA's captures;
      * `flat_cg_head`, `flat_pcg_chunk`, `flat_lm_tail`: `schur.ba_iterate_cg`'s
        three graphs (tolerance 1e-6);
      * `local_cg_head`, `local_pcg_chunk`, `local_lm_tail`: the cg backend's
        local-BA graphs on a padded camera plan (forcing term 1e-2)."""
    flat = facade.bucketed_to_flat(problem)
    act = flat.obs_valid
    lm = dict(cam=cam, robust_delta=_DELTA)
    loop = dict(lm, num_iters=num_iters)
    plans = schur.edge_plans(flat, act)
    calls = {
        "flat_local_loop": (schur._local_loop_jit, (flat, act, plans), loop),
        "flat_global_loop": (schur._global_loop_jit, (flat, act, plans), loop),
    }
    chi2 = schur.chi2_only(flat, cam, act, _DELTA)
    mu, nu = torch.full_like(chi2, 1e-3), torch.full_like(chi2, 2.0)
    cplans = schur._plans(flat, act, pair=False)
    head = schur._cg_head(flat, act, mu, cplans, cam, _DELTA, 1e-6)
    calls.update(
        flat_cg_head=(schur._cg_head_jit, (flat, act, mu, cplans), dict(lm, tol=1e-6)),
        flat_pcg_chunk=(schur._pcg_chunk_jit, (head.ctx, head.Mp, flat.obs_cam, flat.obs_pt,
                                               flat.pose_fixed, cplans, head.pcg),
                        dict(steps=schur_bucketed.PCG_CHECK_EVERY)),
        flat_lm_tail=(schur._lm_tail_jit, (flat, head.ctx, head.pcg.x, chi2, mu, nu, act,
                                           cplans), lm))
    sb, act = schur_bucketed, problem.obs_valid
    plan = sb.pose_plan(problem, act)
    head = sb._cg_head(problem, act, mu, plan, cam, _DELTA, 1e-2)
    calls.update(
        local_cg_head=(sb._local_cg_head_jit, (problem, act, mu, plan), dict(lm, tol=1e-2)),
        local_pcg_chunk=(sb._local_pcg_chunk_jit, (head.ctx, head.Mp, problem.obs_cam,
                                                   problem.pose_fixed, plan, head.pcg),
                         dict(steps=sb.PCG_CHECK_EVERY)),
        local_lm_tail=(sb._local_lm_tail_jit, (problem, head.ctx, head.pcg.x, chi2, mu, nu,
                                               act), lm))
    return calls


def calibration_calls(p_lidar: torch.Tensor, T_true: se3.SE3, seed: int = 0) -> dict:
    """`calibrate_extrinsics` from `T_true` perturbed by ~0.05 rad and 5 cm:
    point pairs (the LiDAR points, their camera-frame images with 1 mm of
    noise, 5 % invalid), with plane terms (the first half of the points,
    each on the camera-frame plane of one fixed normal through its true
    image) and without (`calibrate_extrinsics_pairs`)."""
    rng = np.random.RandomState(seed)
    dev = p_lidar.device

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    n = p_lidar.shape[0]
    q_c = se3.act(T_true, p_lidar) + t(rng.normal(size=(n, 3)) * 1e-3)
    valid = t(rng.rand(n) > 0.05, torch.bool)
    T0 = se3.compose(se3.exp(t(rng.normal(size=6) * 0.03)), T_true)
    m = n // 2
    normal = torch.nn.functional.normalize(t([0.2, -1.0, 0.1]), dim=0).expand(m, 3)
    d = -torch.sum(normal * se3.act(T_true, p_lidar[:m]), dim=-1)
    planes = dict(plane_p=p_lidar[:m], plane_n=normal.contiguous(), plane_d=d,
                  plane_valid=valid[:m])
    fn = calibration.calibrate_extrinsics
    return {"calibrate_extrinsics": (fn, (T0, p_lidar, q_c, valid), planes),
            "calibrate_extrinsics_pairs": (fn, (T0, p_lidar, q_c, valid), {})}


def dist_calls(problem: schur_bucketed.BucketedBAProblem, cam: Camera, n_shards: int = 4,
               num_iters: int = 3, mu: float = 1e-3) -> dict:
    """Distributed BA's graphs on `problem` split into `n_shards` shards on
    its device (robust):

      * `dist_lm_loop`, `dist_bucketed_step`, `dist_flat_step`: the whole
        Nielsen loop of `num_iters` iterations, a bucketed and a flat step
        (`mu`), each one graph (one process, one device);
      * `dist_start`, `dist_head`, `dist_solve`, `dist_tail`,
        `dist_step_head`, `dist_step_solve`, `dist_flat_head`,
        `dist_flat_solve`: the device's segment graphs (across processes or
        devices), at the loop's first iteration and the steps' state."""
    dev = problem.points.device
    mesh = dist_ba.make_mesh(n_shards, dev)
    sp = dist_ba.to_shards(dist_ba.partition_bucketed(problem, n_shards)[0], mesh)
    fp = dist_ba.to_shards(dist_ba.partition_problem(facade.bucketed_to_flat(problem),
                                                     n_shards)[0], mesh)
    plans = dist_ba.shard_edge_plans(fp)
    P = problem.num_poses
    lm = dict(cam=cam, robust_delta=_DELTA)
    groups, part = dist_ba._lm_start(sp, **lm)
    st = dist_ba._lm_begin(sp, part, mu)
    kept, part = dist_ba._lm_head(sp, groups, st.pose_R, st.pose_t, st.points, st.mu, **lm)
    system = dist_ba._unfold(part, dist_ba._system_shapes(P))
    cand, part = dist_ba._lm_solve(sp, st.pose_R, st.pose_t, st.points, kept, *system, st.mu,
                                   **lm)
    step_kept, step_part = dist_ba._step_head(sp, mu, **lm)
    step_system = dist_ba._unfold(step_part, dist_ba._system_shapes(P) + [()])[:3]
    flat_kept, flat_part = dist_ba._flat_head(fp, plans, mu, **lm)
    flat_system = dist_ba._unfold(flat_part, dist_ba._flat_shapes(P))[:4]
    segs = dist_ba._segments(dev)
    state = (st.pose_R, st.pose_t, st.points)
    return {
        "dist_lm_loop": (dist_ba._lm_loop_jit, (sp,), dict(lm, num_iters=num_iters, mu0=mu)),
        "dist_bucketed_step": (dist_ba._bucketed_step_jit, (sp,), dict(lm, mu=mu)),
        "dist_flat_step": (dist_ba._flat_step_jit, (fp, plans), dict(lm, mu=mu)),
        "dist_start": (segs.start, (sp,), lm),
        "dist_head": (segs.head, (sp, groups, *state, st.mu), lm),
        "dist_solve": (segs.solve, (sp, *state, kept, *system, st.mu), lm),
        "dist_tail": (segs.tail, (st, cand, part), {}),
        "dist_step_head": (segs.step_head, (sp, mu), lm),
        "dist_step_solve": (segs.step_solve, (sp, sp.pose_R, sp.pose_t, sp.points, step_kept,
                                              *step_system, mu), dict(lm, test=False)),
        "dist_flat_head": (segs.flat_head, (fp, plans, mu), lm),
        "dist_flat_solve": (segs.flat_solve, (fp, flat_kept, *flat_system, mu), {}),
    }
