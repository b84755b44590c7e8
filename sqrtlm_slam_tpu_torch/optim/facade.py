"""Optimizer facade — counterpart of `sqrtlm_slam_tpu/optim/facade.py`.

Three backends, selected per instance:
  * ``"bucketed"`` (default): the landmark-bucketed sqrt-Schur engine with
    kernel K2 (`optim/schur_bucketed.py`);
  * ``"flat"``: the flat-edge dense-W Schur engine (`optim/schur.py`, plain
    PyTorch), the independently written engine the bucketed one is held
    against; it takes the bucketed problem flattened (`bucketed_to_flat`)
    and returns the bucketed layout;
  * ``"cg"``: matrix-free Schur + block-Jacobi PCG (kernels K2 and K3).
Global BA runs on the matrix-free engine for "bucketed" and "cg" and on the
flat engine for "flat", as in the JAX package; the essential graph and the
Sim3 refinement are backend-independent.
"""

from __future__ import annotations

import math

import torch

from . import loss as losses
from . import pose_opt, schur, schur_bucketed

BACKENDS = ("bucketed", "flat", "cg")


def bucketed_to_flat(problem: schur_bucketed.BucketedBAProblem) -> schur.BAProblem:
    """Flatten a (L, K)-bucketed problem to the flat (E,) edge layout: edge
    l * K + k is slot (l, k)."""
    L, K = problem.obs_cam.shape
    obs_pt = torch.arange(L, dtype=torch.int32, device=problem.obs_cam.device)
    return schur.BAProblem(
        pose_R=problem.pose_R, pose_t=problem.pose_t, pose_fixed=problem.pose_fixed,
        pose_valid=problem.pose_valid, points=problem.points,
        point_valid=problem.point_valid, obs_cam=problem.obs_cam.reshape(-1),
        obs_pt=obs_pt.repeat_interleave(K), obs_uvr=problem.obs_uvr.reshape(L * K, 3),
        obs_inv_sigma2=problem.obs_inv_sigma2.reshape(-1),
        obs_valid=problem.obs_valid.reshape(-1),
    )


def _writeback_bucketed(problem: schur_bucketed.BucketedBAProblem, flat: schur.BAProblem,
                        survivors):
    """Fold flat-engine results back into the bucketed layout."""
    out = problem._replace(pose_R=flat.pose_R, pose_t=flat.pose_t, points=flat.points)
    return out, survivors.reshape(problem.obs_cam.shape)


class Optimizer:
    """Runtime-selectable optimization backend."""

    def __init__(self, backend: str = "bucketed"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
        self.backend = backend

    def pose_optimization(self, pose0, obs: pose_opt.VisualObs, cam, **kwargs):
        return pose_opt.optimize_pose(pose0, obs, cam, **kwargs)

    def local_bundle_adjustment(self, problem: schur_bucketed.BucketedBAProblem, cam,
                                first_iters: int = 5, second_iters: int = 10):
        """Two-phase local BA. Returns (problem, survivors (L, K) bool, chi2)."""
        if self.backend == "flat":
            out, survivors, stats = schur.local_ba(bucketed_to_flat(problem), cam,
                                                   first_iters=first_iters,
                                                   second_iters=second_iters)
            return (*_writeback_bucketed(problem, out, survivors), stats.chi2)
        if self.backend == "cg":
            return _local_ba_cg(problem, cam, first_iters, second_iters)
        return schur_bucketed.local_ba(problem, cam, first_iters=first_iters,
                                       second_iters=second_iters)

    def global_bundle_adjustment(self, problem: schur_bucketed.BucketedBAProblem, cam,
                                 num_iters: int = 20):
        """Whole-map BA, `num_iters` robust iterations (the flat engine for
        "flat", the matrix-free one otherwise). Returns (problem, survivors,
        chi2)."""
        if self.backend == "flat":
            out, survivors, stats = schur.global_ba(bucketed_to_flat(problem), cam,
                                                    num_iters=num_iters)
            return (*_writeback_bucketed(problem, out, survivors), stats.chi2)
        return schur_bucketed.global_ba_cg(problem, cam, num_iters=num_iters)

    def optimize_essential_graph(self, problem, num_iters: int = 20, **kwargs):
        from ..loop import essential_graph

        return essential_graph.optimize_pose_graph(problem, num_iters=num_iters, **kwargs)

    def optimize_sim3(self, *args, **kwargs):
        from ..loop import sim3_solver

        return sim3_solver.optimize_sim3(*args, **kwargs)


def _local_ba_cg(problem: schur_bucketed.BucketedBAProblem, cam, first_iters: int,
                 second_iters: int):
    """Local-BA protocol on the matrix-free CG step (backend="cg")."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, _, _ = schur_bucketed.ba_iterate_cg(problem, cam, problem.obs_valid, first_iters,
                                                 robust_delta=delta2)
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = torch.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = schur_bucketed.edge_chi2_and_depth(problem, cam)
    active = problem.obs_valid & (e2 <= gate) & (z > 0)
    problem, chi2, _ = schur_bucketed.ba_iterate_cg(problem, cam, active, second_iters,
                                                    robust_delta=None)
    e2, z = schur_bucketed.edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    return problem, survivors, chi2
