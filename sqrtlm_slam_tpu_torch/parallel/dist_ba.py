"""Distributed bundle adjustment over landmark shards.

Counterpart of `sqrtlm_slam_tpu/parallel/dist_ba.py` (shard_map + psum over
a device mesh):

  * landmarks, and the observations that touch them, are split round-robin
    into shards: Hll, bl and the landmark back-substitution are local to a
    shard;
  * poses are replicated: one copy on the mesh's first device;
  * each shard computes its part of the reduced camera system, the parts
    are summed, every process solves the small dense system and each shard
    back-substitutes its own landmarks.

The JAX `Mesh` becomes `Mesh`, a list of one `torch.device` per shard of
this process (repeats allowed: four shards may share one card). A `psum`
becomes `_sum_shards`: each shard's tensors flattened into one buffer,
summed in shard order on the first device, then, across processes, one
`torch.distributed.all_reduce` of that buffer. In one process the shard
order fixes every sum, so reruns are bitwise equal; different shard counts
sum in different orders and agree to float32 rounding.

Per LM iteration the Nielsen loop (`make_bucketed_lm_iterate`) makes two
such sums: (S_half, bp, rhs_corr) after K2's assembly on every shard, and
(chi2 of the candidate by K3, landmark gain term) after the solve. Every LM
scalar stays on the device: the loop makes no host read. The partitioners
are host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..geometry import se3
from ..optim import schur, schur_bucketed
from ..utils import to_host


class Mesh:
    """The landmark shards of one process. `devices[i]` holds local shard i,
    which is global shard `process_index * len(devices) + i` of
    `num_shards`; with `num_processes > 1` every sum over shards is
    all-reduced over the default process group."""

    def __init__(self, devices: Sequence, process_index: int = 0, num_processes: int = 1):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = tuple(torch.device(d) for d in devices)
        self.process_index = process_index
        self.num_processes = num_processes

    @property
    def num_shards(self) -> int:
        return len(self.devices) * self.num_processes

    @property
    def first_shard(self) -> int:
        return self.process_index * len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where the poses, the summed system and the LM scalars live."""
        return self.devices[0]


def make_mesh(n_shards: int, device="cuda") -> Mesh:
    """`n_shards` shards in this process. A bare "cuda" deals them
    round-robin over the visible cards (all on cuda:0 with one card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device")
        return Mesh([torch.device("cuda", i % n) for i in range(n_shards)])
    return Mesh([device] * n_shards)


def _sum_shards(mesh: Mesh, parts: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Sum over shards of each shard's tensors (same shapes on every shard):
    one flattened buffer per shard, added in shard order on the home device,
    then all-reduced across processes. Returns the sums on the home device."""
    shapes = [t.shape for t in parts[0]]
    bufs = [torch.cat([t.reshape(-1) for t in shard]) for shard in parts]
    total = bufs[0].to(mesh.home)
    for b in bufs[1:]:
        total = total + b.to(mesh.home)
    if mesh.num_processes > 1:
        torch.distributed.all_reduce(total)
    sizes = [int(np.prod(s)) for s in shapes]
    return [t.reshape(s) for t, s in zip(torch.split(total, sizes), shapes)]


def _lm_ids(L: int, n_shards: int) -> np.ndarray:
    """Global landmark id of each (shard, slot); -1 pads. Round-robin."""
    Ls = -(-L // n_shards)
    lm_ids = np.full((n_shards, Ls), -1, np.int64)
    for d in range(n_shards):
        ids = np.arange(d, L, n_shards)
        lm_ids[d, : len(ids)] = ids
    return lm_ids


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


# ----------------------------------------------------------------------
# Flat-edge distributed BA (the flat engine per shard).
# ----------------------------------------------------------------------


class ShardedBAProblem(NamedTuple):
    """`schur.BAProblem` laid out over shards: poses replicated, landmark
    and edge fields with a leading shard axis. The partitioner gives numpy
    (D, ...) arrays; `to_shards` gives a tuple of one tensor per local shard
    on the mesh's devices, and the poses as tensors on its home device."""

    pose_R: object  # (P, 3, 3)
    pose_t: object  # (P, 3)
    pose_fixed: object  # (P,)
    points: object  # (D, Ls, 3)
    point_valid: object  # (D, Ls)
    obs_cam: object  # (D, Es)
    obs_pt: object  # (D, Es) local landmark slot in [0, Ls)
    obs_uvr: object  # (D, Es, 3)
    obs_inv_sigma2: object  # (D, Es)
    obs_valid: object  # (D, Es)


def partition_problem(problem: schur.BAProblem, n_shards: int
                      ) -> Tuple[ShardedBAProblem, np.ndarray]:
    """Host partitioner: landmarks round-robin to shards, edges follow their
    landmark. Returns (sharded problem, landmark global ids per (shard,
    slot) for the write-back)."""
    (pose_R, pose_t, pose_fixed, pts, pv, obs_cam, obs_pt, obs_uvr, obs_is2,
     obs_valid) = to_host(problem.pose_R, problem.pose_t, problem.pose_fixed,
                          problem.points, problem.point_valid, problem.obs_cam,
                          problem.obs_pt, problem.obs_uvr, problem.obs_inv_sigma2,
                          problem.obs_valid)
    L = pts.shape[0]
    obs_valid = obs_valid.astype(bool)
    shard_of = obs_pt % n_shards
    slot_of = obs_pt // n_shards
    lm_ids = _lm_ids(L, n_shards)
    Ls = lm_ids.shape[1]

    points = np.zeros((n_shards, Ls, 3), np.float32)
    point_valid = np.zeros((n_shards, Ls), bool)
    for d in range(n_shards):
        sel = lm_ids[d] >= 0
        points[d, sel] = pts[lm_ids[d][sel]]
        point_valid[d, sel] = pv[lm_ids[d][sel]]

    # Edge capacity per shard: the largest count. Valid edges stable-sorted
    # by shard; an edge's place is its rank inside its shard's run.
    counts = np.bincount(shard_of[obs_valid], minlength=n_shards)
    Es = max(int(counts.max()), 1)
    o_cam = np.zeros((n_shards, Es), np.int32)
    o_pt = np.zeros((n_shards, Es), np.int32)
    o_uvr = np.full((n_shards, Es, 3), -1.0, np.float32)
    o_is2 = np.ones((n_shards, Es), np.float32)
    o_val = np.zeros((n_shards, Es), bool)
    ev = np.nonzero(obs_valid)[0]
    dv = shard_of[ev]
    order = np.argsort(dv, kind="stable")
    ev, dv = ev[order], dv[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.arange(len(ev)) - starts[dv]
    o_cam[dv, j] = obs_cam[ev]
    o_pt[dv, j] = slot_of[ev]
    o_uvr[dv, j] = obs_uvr[ev]
    o_is2[dv, j] = obs_is2[ev]
    o_val[dv, j] = True
    return ShardedBAProblem(pose_R=pose_R, pose_t=pose_t, pose_fixed=pose_fixed,
                            points=points, point_valid=point_valid, obs_cam=o_cam,
                            obs_pt=o_pt, obs_uvr=o_uvr, obs_inv_sigma2=o_is2,
                            obs_valid=o_val), lm_ids


_DTYPES = dict(pose_fixed=torch.bool, point_valid=torch.bool, obs_cam=torch.int32,
               obs_pt=torch.int32, obs_valid=torch.bool)


def to_shards(sharded, mesh: Mesh):
    """A partitioned problem (numpy, leading shard axis) on the mesh: each
    local shard's rows on its device, the poses on the home device. In a
    process group each process materializes only its own shards."""
    out = {}
    first, n = mesh.first_shard, len(mesh.devices)
    for name, value in sharded._asdict().items():
        dtype = _DTYPES.get(name, torch.float32)
        if name.startswith("pose_"):
            out[name] = _tensor(value, mesh.home, dtype)
        else:
            out[name] = tuple(_tensor(value[first + i], dev, dtype)
                              for i, dev in enumerate(mesh.devices))
    return type(sharded)(**out)


def _local_points(mesh: Mesh, points) -> np.ndarray:
    """(local shards, Ls, 3) landmarks of this process, on the host."""
    return to_host(torch.stack([p.to(mesh.home) for p in points]))


def make_distributed_ba_step(mesh: Mesh, cam: Camera, mu: float = 1e-4,
                             robust_delta: Optional[float] = None):
    """One damped Gauss-Newton step of the flat engine over the mesh:
    step(sharded) -> (sharded', chi2 before the step). Each shard assembles
    its normal equations; (Hpp, bp, S_corr, rhs_corr, chi2) are summed in
    one buffer; every landmark is back-substituted on its shard."""

    def step(sp: ShardedBAProblem):
        parts, local = [], []
        for d, dev in enumerate(mesh.devices):
            prob = schur.BAProblem(
                pose_R=sp.pose_R.to(dev), pose_t=sp.pose_t.to(dev),
                pose_fixed=sp.pose_fixed.to(dev),
                pose_valid=torch.ones_like(sp.pose_fixed, device=dev),
                points=sp.points[d], point_valid=sp.point_valid[d], obs_cam=sp.obs_cam[d],
                obs_pt=sp.obs_pt[d], obs_uvr=sp.obs_uvr[d],
                obs_inv_sigma2=sp.obs_inv_sigma2[d], obs_valid=sp.obs_valid[d])
            Hpp, Hll, W, bp, bl, chi2 = schur.build_normal_equations(
                prob, cam, prob.obs_valid, robust_delta)
            P6, Ls = W.shape[0], W.shape[1]
            eye3 = torch.eye(3, dtype=Hll.dtype, device=dev)
            Hll_d = torch.where(prob.point_valid[:, None, None], schur._damp(Hll, mu), eye3)
            Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
            W2 = W.reshape(P6, Ls * 3)
            WHinv = torch.einsum("alk,lkm->alm", W, Hll_inv).reshape(P6, Ls * 3)
            parts.append([Hpp, bp, WHinv @ W2.T, WHinv @ bl.reshape(-1), chi2])
            local.append((prob, W2, Hll_inv, bl))
        Hpp, bp, S_corr, rhs_corr, chi2 = _sum_shards(mesh, parts)
        S = schur._blockdiag(schur._damp(Hpp, mu)) - S_corr
        dxp = schur_bucketed.solve_pose_system(S, -(bp.reshape(-1) - rhs_corr), sp.pose_fixed)

        points = []
        for d, (prob, W2, Hll_inv, bl) in enumerate(local):
            dxp_d = dxp.to(mesh.devices[d])
            Wt_dxp = (dxp_d.reshape(1, -1) @ W2).reshape(-1, 3)
            dxl = torch.einsum("lkm,lm->lk", Hll_inv, -bl - Wt_dxp)
            points.append(prob.points + torch.where(prob.point_valid[:, None], dxl,
                                                    torch.zeros_like(dxl)))
        pose_R, pose_t = _retract_free(sp.pose_R, sp.pose_t, sp.pose_fixed, dxp)
        return sp._replace(pose_R=pose_R, pose_t=pose_t, points=tuple(points)), chi2

    return step


def _retract_free(pose_R, pose_t, pose_fixed, dxp):
    """Left-retract the free poses by dxp; fixed poses stay."""
    new = se3.retract(se3.SE3(pose_R, pose_t), dxp)
    free = (~pose_fixed)[:, None]
    return torch.where(free[..., None], new.R, pose_R), torch.where(free, new.t, pose_t)


def distributed_ba(problem: schur.BAProblem, cam: Camera, mesh: Mesh, num_iters: int = 10,
                   mu: float = 1e-4) -> Tuple[schur.BAProblem, torch.Tensor]:
    """Partition, take `num_iters` flat steps, write back. Returns (problem,
    chi2 before the last step)."""
    sharded, lm_ids = partition_problem(problem, mesh.num_shards)
    sp = to_shards(sharded, mesh)
    step = make_distributed_ba_step(mesh, cam, mu=mu)
    chi2 = None
    for _ in range(num_iters):
        sp, chi2 = step(sp)
    return unshard(problem, sp, _local_points(mesh, sp.points), lm_ids), chi2


# ----------------------------------------------------------------------
# Bucketed distributed BA: K2 and K3 on every shard.
# ----------------------------------------------------------------------


class ShardedBucketedBA(NamedTuple):
    """`BucketedBAProblem` laid out over shards (landmark rows round-robin);
    the layouts of `ShardedBAProblem`."""

    pose_R: object  # (P, 3, 3)
    pose_t: object  # (P, 3)
    pose_fixed: object  # (P,)
    points: object  # (D, Ls, 3)
    point_valid: object  # (D, Ls)
    obs_cam: object  # (D, Ls, K)
    obs_uvr: object  # (D, Ls, K, 3)
    obs_inv_sigma2: object  # (D, Ls, K)
    obs_valid: object  # (D, Ls, K)


def partition_bucketed(b: schur_bucketed.BucketedBAProblem, n_shards: int
                       ) -> Tuple[ShardedBucketedBA, np.ndarray]:
    """Round-robin landmark rows -> shards (a pure gather). Padding rows are
    invalid (no landmark, no observation: zero weight in K2 and K3)."""
    lm_ids = _lm_ids(b.points.shape[0], n_shards)

    def shard_rows(x, fill):
        x = to_host(x)
        out = np.full(lm_ids.shape + x.shape[1:], fill, x.dtype)
        for d in range(n_shards):
            sel = lm_ids[d] >= 0
            out[d, sel] = x[lm_ids[d][sel]]
        return out

    pose_R, pose_t, pose_fixed = to_host(b.pose_R, b.pose_t, b.pose_fixed)
    return ShardedBucketedBA(
        pose_R=pose_R, pose_t=pose_t, pose_fixed=pose_fixed,
        points=shard_rows(b.points, 0.0), point_valid=shard_rows(b.point_valid, False),
        obs_cam=shard_rows(b.obs_cam, 0), obs_uvr=shard_rows(b.obs_uvr, -1.0),
        obs_inv_sigma2=shard_rows(b.obs_inv_sigma2, 1.0),
        obs_valid=shard_rows(b.obs_valid, False),
    ), lm_ids


class _Shard(NamedTuple):
    """One shard's constant part: its observations and the camera grouping
    of its active slots (K2's camera pass)."""

    device: torch.device
    pose_fixed: torch.Tensor
    pose_valid: torch.Tensor
    point_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_uvr: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor
    groups: object

    def problem(self, pose_R, pose_t, points) -> schur_bucketed.BucketedBAProblem:
        return schur_bucketed.BucketedBAProblem(
            pose_R=pose_R.to(self.device), pose_t=pose_t.to(self.device),
            pose_fixed=self.pose_fixed, pose_valid=self.pose_valid, points=points,
            point_valid=self.point_valid, obs_cam=self.obs_cam, obs_uvr=self.obs_uvr,
            obs_inv_sigma2=self.obs_inv_sigma2, obs_valid=self.obs_valid)


def _shards(mesh: Mesh, sp: ShardedBucketedBA) -> List[_Shard]:
    shards = []
    for d, dev in enumerate(mesh.devices):
        s = _Shard(device=dev, pose_fixed=sp.pose_fixed.to(dev),
                   pose_valid=torch.ones_like(sp.pose_fixed, device=dev),
                   point_valid=sp.point_valid[d], obs_cam=sp.obs_cam[d],
                   obs_uvr=sp.obs_uvr[d], obs_inv_sigma2=sp.obs_inv_sigma2[d],
                   obs_valid=sp.obs_valid[d], groups=None)
        prob = s.problem(sp.pose_R, sp.pose_t, sp.points[d])
        shards.append(s._replace(groups=schur_bucketed.camera_groups(prob, s.obs_valid)))
    return shards


def _bucketed_solve(sp: ShardedBucketedBA, S, bp, rhs_corr, shards, pieces, problems):
    """Pose solve of the summed system, then each shard's landmark update:
    (dxp on the home device, [dxl per shard])."""
    dxp = schur_bucketed.solve_pose_system(S, -(bp.reshape(-1) - rhs_corr), sp.pose_fixed)
    dxp = torch.where(sp.pose_fixed[:, None], torch.zeros_like(dxp), dxp)
    dxl = [schur_bucketed.back_substitute(pc, prob, dxp.to(s.device))
           for s, pc, prob in zip(shards, pieces, problems)]
    return dxp, dxl


def make_bucketed_ba_step(mesh: Mesh, cam: Camera, mu: float = 1e-4,
                          robust_delta: Optional[float] = None):
    """One damped Gauss-Newton step of the bucketed engine over the mesh:
    step(sharded) -> (sharded', chi2 before the step). One K2 launch per
    shard; (S_half, bp, rhs_corr, chi2) summed in one buffer."""

    def step(sp: ShardedBucketedBA):
        shards = _shards(mesh, sp)
        problems = [s.problem(sp.pose_R, sp.pose_t, p) for s, p in zip(shards, sp.points)]
        pieces = [schur_bucketed.build_local_pieces(prob, cam, s.obs_valid, robust_delta, mu,
                                                    s.groups)
                  for s, prob in zip(shards, problems)]
        S, bp, rhs_corr, chi2 = _sum_shards(
            mesh, [[p.S_half, p.bp, p.rhs_corr, p.chi2] for p in pieces])
        dxp, dxl = _bucketed_solve(sp, S, bp, rhs_corr, shards, pieces, problems)
        pose_R, pose_t = _retract_free(sp.pose_R, sp.pose_t, sp.pose_fixed, dxp)
        points = tuple(p + x for p, x in zip(sp.points, dxl))
        return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), chi2

    return step


def make_bucketed_lm_iterate(mesh: Mesh, cam: Camera, num_iters: int = 15,
                             robust_delta: Optional[float] = None, mu0: float = 1e-3):
    """The distributed Nielsen LM loop: iterate(sharded) -> (sharded', chi2,
    accepted count), the protocol of `schur_bucketed.ba_iterate` (gain
    ratio, mu / nu adaptation, rollback on reject). Per iteration: K2 on
    every shard, one sum of (S_half, bp, rhs_corr), the pose solve, the
    landmark updates, K3 on every shard at the candidate, one sum of
    (chi2_c, landmark gain term). Every scalar is computed from summed
    quantities, so every process takes the same decisions; no host read."""

    def global_chi2(shards, pose_R, pose_t, points):
        return _sum_shards(mesh, [
            [schur_bucketed.chi2_only(s.problem(pose_R, pose_t, p), cam, s.obs_valid,
                                      robust_delta)]
            for s, p in zip(shards, points)])[0]

    def iterate(sp: ShardedBucketedBA):
        shards = _shards(mesh, sp)
        fixed = sp.pose_fixed
        pR, pt, pts = sp.pose_R, sp.pose_t, list(sp.points)
        chi2 = global_chi2(shards, pR, pt, pts)
        mu = torch.full_like(chi2, mu0)
        nu = torch.full_like(chi2, 2.0)
        n_acc = torch.zeros((), dtype=torch.int32, device=mesh.home)
        for _ in range(num_iters):
            problems = [s.problem(pR, pt, p) for s, p in zip(shards, pts)]
            pieces = [schur_bucketed.build_local_pieces(prob, cam, s.obs_valid, robust_delta,
                                                        mu.to(s.device), s.groups)
                      for s, prob in zip(shards, problems)]
            S, bp, rhs_corr = _sum_shards(
                mesh, [[p.S_half, p.bp, p.rhs_corr] for p in pieces])
            dxp, dxl = _bucketed_solve(sp, S, bp, rhs_corr, shards, pieces, problems)
            cand_R, cand_t = _retract_free(pR, pt, fixed, dxp)
            cand_pts = [p + x for p, x in zip(pts, dxl)]
            parts = []
            for s, p, x, pc in zip(shards, cand_pts, dxl, pieces):
                chi2_d = schur_bucketed.chi2_only(s.problem(cand_R, cand_t, p), cam,
                                                  s.obs_valid, robust_delta)
                mu_d = mu.to(s.device)
                parts.append([chi2_d, torch.sum(x * (mu_d * x - pc.bl))])
            chi2_c, t_lm = _sum_shards(mesh, parts)

            # Nielsen gain ratio: the pose term from the summed bp, the
            # landmark term summed over shards.
            t_pose = torch.sum(dxp * (mu * dxp - bp))
            rho = (chi2 - chi2_c) / torch.clamp(0.5 * (t_pose + t_lm), min=1e-12)
            accept = (rho > 0) & torch.isfinite(chi2_c)
            pR = torch.where(accept, cand_R, pR)
            pt = torch.where(accept, cand_t, pt)
            pts = [torch.where(accept.to(p.device), c, p) for c, p in zip(cand_pts, pts)]
            chi2 = torch.where(accept, chi2_c, chi2)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            mu = torch.where(accept, mu * factor, mu * nu)
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
            n_acc = n_acc + accept.to(torch.int32)
        return sp._replace(pose_R=pR, pose_t=pt, points=tuple(pts)), chi2, n_acc

    return iterate


def unshard(b, sp, shard_pts: np.ndarray, lm_ids: np.ndarray):
    """`b` (flat or bucketed) with the sharded result's poses and the (D,
    Ls, 3) shard landmarks `shard_pts`, on b's device."""
    pts = np.array(to_host(b.points), copy=True)
    for d in range(lm_ids.shape[0]):
        sel = lm_ids[d] >= 0
        pts[lm_ids[d][sel]] = shard_pts[d, sel]
    dev = b.points.device
    return b._replace(pose_R=sp.pose_R.to(dev), pose_t=sp.pose_t.to(dev),
                      points=torch.as_tensor(pts, device=dev))


def distributed_ba_lm(b: schur_bucketed.BucketedBAProblem, cam: Camera, mesh: Mesh,
                      num_iters: int = 15, robust_delta: Optional[float] = None
                      ) -> Tuple[schur_bucketed.BucketedBAProblem, torch.Tensor, torch.Tensor]:
    """Production distributed BA: partition, the whole Nielsen LM loop,
    write back. One process (see `multiprocess.distributed_ba_lm` for a
    process group). Returns (problem, chi2, accepted count)."""
    sharded, lm_ids = partition_bucketed(b, mesh.num_shards)
    iterate = make_bucketed_lm_iterate(mesh, cam, num_iters=num_iters,
                                       robust_delta=robust_delta)
    sp, chi2, n_acc = iterate(to_shards(sharded, mesh))
    return unshard(b, sp, _local_points(mesh, sp.points), lm_ids), chi2, n_acc


def distributed_ba_bucketed(b: schur_bucketed.BucketedBAProblem, cam: Camera, mesh: Mesh,
                            num_iters: int = 10, mu: float = 1e-4,
                            robust_delta: Optional[float] = None
                            ) -> Tuple[schur_bucketed.BucketedBAProblem, torch.Tensor]:
    """Partition, `num_iters` fixed-mu bucketed steps, write back. Returns
    (problem, chi2 before the last step)."""
    sharded, lm_ids = partition_bucketed(b, mesh.num_shards)
    sp = to_shards(sharded, mesh)
    step = make_bucketed_ba_step(mesh, cam, mu=mu, robust_delta=robust_delta)
    chi2 = None
    for _ in range(num_iters):
        sp, chi2 = step(sp)
    return unshard(b, sp, _local_points(mesh, sp.points), lm_ids), chi2
