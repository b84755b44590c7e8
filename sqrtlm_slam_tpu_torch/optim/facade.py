"""Optimizer facade — counterpart of `sqrtlm_slam_tpu/optim/facade.py`.

Only the ``"bucketed"`` backend (the sqrt-Schur engine with kernel K2) is
ported. ``"flat"`` and ``"cg"`` raise `NotImplementedError`: the flat
engine's role as an independent cross-check is taken by the JAX reference,
and the matrix-free CG engine comes with global BA (ROADMAP queue 1,
item 10, "Loop closing and global BA").
"""

from __future__ import annotations

from . import pose_opt, schur_bucketed

BACKENDS = ("bucketed", "flat", "cg")


class Optimizer:
    """Runtime-selectable optimization backend."""

    def __init__(self, backend: str = "bucketed"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
        if backend != "bucketed":
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP queue 1, item 10: "
                "loop closing and global BA, the CG half of schur_bucketed)"
            )
        self.backend = backend

    def pose_optimization(self, pose0, obs: pose_opt.VisualObs, cam, **kwargs):
        return pose_opt.optimize_pose(pose0, obs, cam, **kwargs)

    def local_bundle_adjustment(self, problem: schur_bucketed.BucketedBAProblem, cam,
                                first_iters: int = 5, second_iters: int = 10):
        """Two-phase local BA. Returns (problem, survivors (L, K) bool, chi2)."""
        return schur_bucketed.local_ba(problem, cam, first_iters=first_iters,
                                       second_iters=second_iters)
