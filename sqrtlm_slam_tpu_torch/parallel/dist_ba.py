"""Distributed bundle adjustment over landmark shards.

Counterpart of `sqrtlm_slam_tpu/parallel/dist_ba.py` (shard_map + psum over
a device mesh):

  * landmarks, and the observations that touch them, are split round-robin
    into shards: Hll, bl and the landmark back-substitution are local to a
    shard;
  * poses are replicated: one copy on the mesh's first device;
  * each shard computes its part of the reduced camera system, the parts
    are summed, every device solves the small dense system and each shard
    back-substitutes its own landmarks.

The JAX `Mesh` becomes `Mesh`, a list of one `torch.device` per shard of
this process (repeats allowed: four shards may share one card). A `psum`
is two halves: the in-process add (`_fold`: each shard's tensors flattened
into one buffer, the buffers added in shard order; with shards on several
devices, each device's in shard order, then the devices' sums in device
order on the home device) and, across processes, one
`torch.distributed.all_reduce` of that buffer (`_sum_devices`). In one
process the shard order fixes every sum, so reruns are bitwise equal;
different shard counts sum in different orders and agree to float32
rounding.

Per LM iteration the Nielsen loop (`make_bucketed_lm_iterate`) makes two
such sums: (S_half, bp, rhs_corr) after K2's assembly on every shard, and
(chi2 of the candidate by K3, landmark gain term) after the solve. Every LM
scalar stays on the device: the loop makes no host read. The partitioners
are host numpy, as in the JAX package.

Execution, chosen by the mesh alone (`_one_graph`), as the JAX package
jit-compiles each program:

  * one process with every shard on one device: the program is one
    captured CUDA graph (`utils.cache.graphed`): the whole LM loop
    (`_lm_loop_jit`), a bucketed step (`_bucketed_step_jit`) or a flat
    step (`_flat_step_jit`), K2 and K3 of every shard inside;
  * across processes, or over several devices in one process: gloo's
    `all_reduce` runs on the host and one graph holds one device's work,
    so the program is cut at its sums into segments, each a graph per
    device (`_segments`): start (K3 and the camera groups), head (K2 and
    the local sum), solve (the pose solve, the landmark updates, K3 at the
    candidate and the local sum) and tail (the gain ratio and the accept
    test). The devices' sums are added on the home device and all-reduced
    between the replays, on the caller's stream. Every device holds the
    poses and the LM scalars and updates them from the same sums, as every
    device of the JAX mesh does.

Both forms call the same segment functions in the same order, so in one
process on one device the whole graph, the segments' graphs and the eager
run (`cache.disable_graphs()`) give the same bits.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..factors.reprojection import Camera
from ..geometry import se3
from ..optim import schur, schur_bucketed
from ..utils import cache, to_host


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


def _fold(parts: List[List[torch.Tensor]]) -> torch.Tensor:
    """The in-process half of a psum: each shard's tensors (same shapes on
    every shard) flattened into one buffer, the buffers added in shard
    order."""
    bufs = [torch.cat([t.reshape(-1) for t in shard]) for shard in parts]
    total = bufs[0]
    for b in bufs[1:]:
        total = total + b
    return total


def _unfold(total: torch.Tensor, shapes) -> List[torch.Tensor]:
    """`_fold`'s buffer back into tensors of `shapes` (views, no copy)."""
    sizes = [int(np.prod(s)) for s in shapes]
    return [t.reshape(s) for t, s in zip(torch.split(total, sizes), shapes)]


def _sum_devices(mesh: Mesh, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The devices' sums (one buffer per device of `_views`, home first)
    added in that order on the home device, then all-reduced across
    processes; the total on each of those devices. With one device in the
    process this adds nothing and copies nothing."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(mesh.home)
    if mesh.num_processes > 1:
        torch.distributed.all_reduce(total)
    return [total.to(p.device) for p in parts]


def _one_graph(mesh: Mesh) -> bool:
    """One process, every shard on the home device: a program is one graph."""
    return mesh.num_processes == 1 and all(d == mesh.home for d in mesh.devices)


def _views(mesh: Mesh, sp):
    """Per device of the mesh (home first): (device, its local shards'
    indices, `sp` cut to those shards with the poses on that device)."""
    views = []
    for dev in dict.fromkeys(mesh.devices):
        idx = [i for i, d in enumerate(mesh.devices) if d == dev]
        views.append((dev, idx, type(sp)(**{
            name: v.to(dev) if name.startswith("pose_") else tuple(v[i] for i in idx)
            for name, v in sp._asdict().items()})))
    return views


def _gather_points(mesh: Mesh, views, per_device) -> tuple:
    """The local shards' landmarks in mesh order from each view's tuple."""
    points = [None] * len(mesh.devices)
    for (_, idx, _), pts in zip(views, per_device):
        for i, p in zip(idx, pts):
            points[i] = p
    return tuple(points)


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


def _system_shapes(P: int) -> list:
    """Shapes of the summed reduced camera system (S, bp, rhs_corr)."""
    return [(6 * P, 6 * P), (P, 6), (6 * P,)]


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


def _flat_problem(sp: ShardedBAProblem, i: int) -> schur.BAProblem:
    """Shard i of `sp` (every tensor on one device) as a `schur.BAProblem`."""
    return schur.BAProblem(
        pose_R=sp.pose_R, pose_t=sp.pose_t, pose_fixed=sp.pose_fixed,
        pose_valid=torch.ones_like(sp.pose_fixed), points=sp.points[i],
        point_valid=sp.point_valid[i], obs_cam=sp.obs_cam[i], obs_pt=sp.obs_pt[i],
        obs_uvr=sp.obs_uvr[i], obs_inv_sigma2=sp.obs_inv_sigma2[i],
        obs_valid=sp.obs_valid[i])


def shard_edge_plans(sp: ShardedBAProblem) -> tuple:
    """`schur.edge_plans` of each local shard (its valid edges; three host
    reads a shard). The observation graph does not change between steps:
    build them once per problem and pass them to every step."""
    return tuple(schur.edge_plans(_flat_problem(sp, i), sp.obs_valid[i])
                 for i in range(len(sp.points)))


class _FlatKept(NamedTuple):
    """What a shard's back-substitution needs of its flat assembly."""

    W2: torch.Tensor  # (P*6, Ls*3)
    Hll_inv: torch.Tensor  # (Ls, 3, 3)
    bl: torch.Tensor  # (Ls, 3)


def _flat_head(sp: ShardedBAProblem, plans, mu: float, cam: Camera, robust_delta):
    """Each shard's normal equations on its plans, and the local sum of
    (Hpp, bp, S_corr, rhs_corr, chi2): (kept per shard, the sum's buffer)."""
    parts, kept = [], []
    for i, plan in enumerate(plans):
        prob = _flat_problem(sp, i)
        Hpp, Hll, W, bp, bl, chi2 = schur.build_normal_equations(
            prob, cam, prob.obs_valid, robust_delta, plan)
        P6, Ls = W.shape[0], W.shape[1]
        eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
        Hll_d = torch.where(prob.point_valid[:, None, None], schur._damp(Hll, mu), eye3)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
        W2 = W.reshape(P6, Ls * 3)
        WHinv = torch.einsum("alk,lkm->alm", W, Hll_inv).reshape(P6, Ls * 3)
        parts.append([Hpp, bp, WHinv @ W2.T, WHinv @ bl.reshape(-1), chi2])
        kept.append(_FlatKept(W2, Hll_inv, bl))
    return kept, _fold(parts)


def _flat_shapes(P: int) -> list:
    """Shapes of the flat engine's summed (Hpp, bp, S_corr, rhs_corr, chi2)."""
    return [(P, 6, 6), (P, 6), (6 * P, 6 * P), (6 * P,), ()]


def _flat_solve(sp: ShardedBAProblem, kept, Hpp, bp, S_corr, rhs_corr, mu: float):
    """The pose solve of the summed system, each shard's landmark update and
    the retraction: (pose_R, pose_t, points)."""
    S = schur._blockdiag(schur._damp(Hpp, mu)) - S_corr
    dxp = schur_bucketed.solve_pose_system(S, -(bp.reshape(-1) - rhs_corr), sp.pose_fixed)
    points = []
    for p, valid, k in zip(sp.points, sp.point_valid, kept):
        Wt_dxp = (dxp.reshape(1, -1) @ k.W2).reshape(-1, 3)
        dxl = torch.einsum("lkm,lm->lk", k.Hll_inv, -k.bl - Wt_dxp)
        points.append(p + torch.where(valid[:, None], dxl, torch.zeros_like(dxl)))
    pose_R, pose_t = _retract_free(sp.pose_R, sp.pose_t, sp.pose_fixed, dxp)
    return pose_R, pose_t, tuple(points)


def _flat_step(sp: ShardedBAProblem, plans, cam: Camera, mu: float, robust_delta):
    """One flat step on one device: head, solve. (pose_R, pose_t, points,
    chi2 before the step)."""
    kept, total = _flat_head(sp, plans, mu, cam, robust_delta)
    Hpp, bp, S_corr, rhs_corr, chi2 = _unfold(total, _flat_shapes(sp.pose_R.shape[0]))
    return (*_flat_solve(sp, kept, Hpp, bp, S_corr, rhs_corr, mu), chi2)


def make_distributed_ba_step(mesh: Mesh, cam: Camera, mu: float = 1e-4,
                             robust_delta: Optional[float] = None):
    """One damped Gauss-Newton step of the flat engine over the mesh:
    step(sharded, plans=None) -> (sharded', chi2 before the step). Each
    shard assembles its normal equations on its edge plans
    (`shard_edge_plans`, built here when not given); (Hpp, bp, S_corr,
    rhs_corr, chi2) are summed in one buffer; every landmark is
    back-substituted on its shard. One graph a step on one device, the
    head and solve segments per device otherwise."""

    def step(sp: ShardedBAProblem, plans=None):
        if plans is None:
            plans = shard_edge_plans(sp)
        if _one_graph(mesh):
            pose_R, pose_t, points, chi2 = _flat_step_jit(sp, plans, cam=cam, mu=mu,
                                                          robust_delta=robust_delta)
            return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), chi2
        return _flat_step_segmented(mesh, sp, plans, cam, mu, robust_delta)

    return step


def _flat_step_segmented(mesh: Mesh, sp: ShardedBAProblem, plans, cam: Camera, mu: float,
                         robust_delta):
    """`make_distributed_ba_step`'s step as per-device head and solve graphs
    with the sum between them."""
    views = _views(mesh, sp)
    segs = [_segments(dev) for dev, _, _ in views]
    heads = [g.flat_head(v, tuple(plans[i] for i in idx), mu, cam=cam,
                         robust_delta=robust_delta)
             for g, (_, idx, v) in zip(segs, views)]
    totals = _sum_devices(mesh, [part for _, part in heads])
    shapes = _flat_shapes(sp.pose_R.shape[0])
    outs = []
    for g, (_, _, v), (kept, _), total in zip(segs, views, heads, totals):
        *system, chi2 = _unfold(total, shapes)
        outs.append(g.flat_solve(v, kept, *system, mu))
    pose_R, pose_t, _ = outs[0]
    points = _gather_points(mesh, views, [o[2] for o in outs])
    return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), _unfold(
        totals[0], shapes)[-1]


def _retract_free(pose_R, pose_t, pose_fixed, dxp):
    """Left-retract the free poses by dxp; fixed poses stay."""
    new = se3.retract(se3.SE3(pose_R, pose_t), dxp)
    free = (~pose_fixed)[:, None]
    return torch.where(free[..., None], new.R, pose_R), torch.where(free, new.t, pose_t)


def distributed_ba(problem: schur.BAProblem, cam: Camera, mesh: Mesh, num_iters: int = 10,
                   mu: float = 1e-4) -> Tuple[schur.BAProblem, torch.Tensor]:
    """Partition, take `num_iters` flat steps, write back. Returns (problem,
    chi2 before the last step). The edge plans are built once."""
    sharded, lm_ids = partition_problem(problem, mesh.num_shards)
    sp = to_shards(sharded, mesh)
    step = make_distributed_ba_step(mesh, cam, mu=mu)
    plans = shard_edge_plans(sp)
    chi2 = None
    for _ in range(num_iters):
        sp, chi2 = step(sp, plans)
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


def _problem(sp: ShardedBucketedBA, i: int, pose_R, pose_t, points
             ) -> schur_bucketed.BucketedBAProblem:
    """Shard i of `sp` (every tensor on one device) at the given state."""
    return schur_bucketed.BucketedBAProblem(
        pose_R=pose_R, pose_t=pose_t, pose_fixed=sp.pose_fixed,
        pose_valid=torch.ones_like(sp.pose_fixed), points=points,
        point_valid=sp.point_valid[i], obs_cam=sp.obs_cam[i], obs_uvr=sp.obs_uvr[i],
        obs_inv_sigma2=sp.obs_inv_sigma2[i], obs_valid=sp.obs_valid[i])


def _camera_groups(sp: ShardedBucketedBA) -> tuple:
    """Each shard's active slots by camera (K2's camera pass); no host read."""
    return tuple(schur_bucketed.camera_groups(_problem(sp, i, sp.pose_R, sp.pose_t, p),
                                              sp.obs_valid[i])
                 for i, p in enumerate(sp.points))


class _Kept(NamedTuple):
    """What a shard's back-substitution needs of its pieces
    (`schur_bucketed.back_substitute` reads these three)."""

    U: torch.Tensor  # (Ls, K, 6, 3)
    Minv: torch.Tensor  # (Ls, 3, 3)
    bl: torch.Tensor  # (Ls, 3)


class _Candidate(NamedTuple):
    pose_R: torch.Tensor
    pose_t: torch.Tensor
    points: tuple
    t_pose: torch.Tensor  # the pose term of the predicted gain


class _LMState(NamedTuple):
    """The Nielsen loop's carry on one device: poses, the device's shards'
    landmarks, and the LM scalars."""

    pose_R: torch.Tensor
    pose_t: torch.Tensor
    points: tuple
    chi2: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    n_acc: torch.Tensor


def _lm_start(sp: ShardedBucketedBA, cam: Camera, robust_delta):
    """Start segment: the camera groups of every shard, and K3 on every
    shard at `sp`'s state summed in shard order (a (1,) buffer)."""
    part = _fold([[schur_bucketed.chi2_only(_problem(sp, i, sp.pose_R, sp.pose_t, p), cam,
                                            sp.obs_valid[i], robust_delta)]
                  for i, p in enumerate(sp.points)])
    return _camera_groups(sp), part


def _lm_begin(sp: ShardedBucketedBA, chi2_total, mu0: float) -> _LMState:
    chi2 = chi2_total.reshape(())
    return _LMState(sp.pose_R, sp.pose_t, tuple(sp.points), chi2, torch.full_like(chi2, mu0),
                    torch.full_like(chi2, 2.0),
                    torch.zeros((), dtype=torch.int32, device=chi2.device))


def _lm_head(sp: ShardedBucketedBA, groups, pose_R, pose_t, points, mu, cam: Camera,
             robust_delta, with_chi2: bool = False):
    """Head segment: K2's pieces on every shard at the given state, and
    the local sum of (S_half, bp, rhs_corr[, chi2]): (kept per shard, the
    sum's buffer)."""
    pieces = [schur_bucketed.build_local_pieces(_problem(sp, i, pose_R, pose_t, p), cam,
                                                sp.obs_valid[i], robust_delta, mu, g)
              for i, (p, g) in enumerate(zip(points, groups))]
    part = _fold([[p.S_half, p.bp, p.rhs_corr] + ([p.chi2] if with_chi2 else [])
                   for p in pieces])
    return [_Kept(p.U, p.Minv, p.bl) for p in pieces], part


def _lm_solve(sp: ShardedBucketedBA, pose_R, pose_t, points, kept, S, bp, rhs_corr, mu,
              cam: Camera, robust_delta, test: bool = True):
    """Solve segment: the pose solve of the summed system (every device
    solves it), each shard's landmark update and the candidate. With
    `test`, K3 on every shard at the candidate and the landmark gain term,
    summed in shard order: (candidate, (2 * shards,) buffer); without, the
    candidate's (pose_R, pose_t, points)."""
    dxp = schur_bucketed.solve_pose_system(S, -(bp.reshape(-1) - rhs_corr), sp.pose_fixed)
    dxp = torch.where(sp.pose_fixed[:, None], torch.zeros_like(dxp), dxp)
    dxl = [schur_bucketed.back_substitute(k, _problem(sp, i, pose_R, pose_t, p), dxp)
           for i, (p, k) in enumerate(zip(points, kept))]
    cand_R, cand_t = _retract_free(pose_R, pose_t, sp.pose_fixed, dxp)
    cand_pts = tuple(p + x for p, x in zip(points, dxl))
    if not test:
        return cand_R, cand_t, cand_pts
    part = _fold([[schur_bucketed.chi2_only(_problem(sp, i, cand_R, cand_t, c), cam,
                                            sp.obs_valid[i], robust_delta),
                   torch.sum(x * (mu * x - k.bl))]
                  for i, (c, x, k) in enumerate(zip(cand_pts, dxl, kept))])
    t_pose = torch.sum(dxp * (mu * dxp - bp))
    return _Candidate(cand_R, cand_t, cand_pts, t_pose), part


def _lm_tail(state: _LMState, cand: _Candidate, total) -> _LMState:
    """Tail segment: the Nielsen gain ratio from the summed (chi2_c, t_lm),
    accept or reject, mu / nu and the accepted count."""
    chi2_c, t_lm = total[0], total[1]
    rho = (state.chi2 - chi2_c) / torch.clamp(0.5 * (cand.t_pose + t_lm), min=1e-12)
    accept = (rho > 0) & torch.isfinite(chi2_c)
    factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    return _LMState(
        pose_R=torch.where(accept, cand.pose_R, state.pose_R),
        pose_t=torch.where(accept, cand.pose_t, state.pose_t),
        points=tuple(torch.where(accept, c, p) for c, p in zip(cand.points, state.points)),
        chi2=torch.where(accept, chi2_c, state.chi2),
        mu=torch.where(accept, state.mu * factor, state.mu * state.nu),
        nu=torch.where(accept, torch.full_like(state.nu, 2.0), state.nu * 2.0),
        n_acc=state.n_acc + accept.to(torch.int32))


def _lm_loop(sp: ShardedBucketedBA, cam: Camera, num_iters: int, robust_delta,
             mu0: float) -> _LMState:
    """The whole Nielsen loop on one device: start, then head, solve, tail
    per iteration (the segments, with nothing to add between them)."""
    groups, part = _lm_start(sp, cam, robust_delta)
    state = _lm_begin(sp, part, mu0)
    shapes = _system_shapes(sp.pose_R.shape[0])
    for _ in range(num_iters):
        kept, part = _lm_head(sp, groups, state.pose_R, state.pose_t, state.points, state.mu,
                              cam, robust_delta)
        cand, part = _lm_solve(sp, state.pose_R, state.pose_t, state.points, kept,
                               *_unfold(part, shapes), state.mu, cam, robust_delta)
        state = _lm_tail(state, cand, part)
    return state


def _lm_segmented(mesh: Mesh, sp: ShardedBucketedBA, cam: Camera, num_iters: int,
                  robust_delta, mu0: float) -> _LMState:
    """The Nielsen loop as per-device segment graphs, the sums between them:
    the state of the home device, with every local shard's landmarks."""
    views = _views(mesh, sp)
    segs = [_segments(dev) for dev, _, _ in views]
    starts = [g.start(v, cam=cam, robust_delta=robust_delta)
              for g, (_, _, v) in zip(segs, views)]
    totals = _sum_devices(mesh, [part for _, part in starts])
    states = [_lm_begin(v, t, mu0) for (_, _, v), t in zip(views, totals)]
    shapes = _system_shapes(sp.pose_R.shape[0])
    for _ in range(num_iters):
        heads = [g.head(v, groups, st.pose_R, st.pose_t, st.points, st.mu, cam=cam,
                        robust_delta=robust_delta)
                 for g, (_, _, v), (groups, _), st in zip(segs, views, starts, states)]
        totals = _sum_devices(mesh, [part for _, part in heads])
        solves = [g.solve(v, st.pose_R, st.pose_t, st.points, kept, *_unfold(t, shapes),
                          st.mu, cam=cam, robust_delta=robust_delta)
                  for g, (_, _, v), (kept, _), st, t in zip(segs, views, heads, states, totals)]
        totals = _sum_devices(mesh, [part for _, part in solves])
        states = [g.tail(st, cand, t)
                  for g, st, (cand, _), t in zip(segs, states, solves, totals)]
    return states[0]._replace(points=_gather_points(mesh, views, [s.points for s in states]))


def _step_head(sp: ShardedBucketedBA, mu: float, cam: Camera, robust_delta):
    """A bucketed step's head: the camera groups, then `_lm_head` with chi2."""
    return _lm_head(sp, _camera_groups(sp), sp.pose_R, sp.pose_t, sp.points, mu, cam,
                    robust_delta, with_chi2=True)


def _bucketed_step(sp: ShardedBucketedBA, cam: Camera, mu: float, robust_delta):
    """One fixed-mu bucketed step on one device: (pose_R, pose_t, points,
    chi2 before the step)."""
    kept, part = _step_head(sp, mu, cam, robust_delta)
    *system, chi2 = _unfold(part, _system_shapes(sp.pose_R.shape[0]) + [()])
    return (*_lm_solve(sp, sp.pose_R, sp.pose_t, sp.points, kept, *system, mu, cam,
                       robust_delta, test=False), chi2)


def _bucketed_step_segmented(mesh: Mesh, sp: ShardedBucketedBA, cam: Camera, mu: float,
                             robust_delta):
    """`make_bucketed_ba_step`'s step as per-device head and solve graphs."""
    views = _views(mesh, sp)
    segs = [_segments(dev) for dev, _, _ in views]
    heads = [g.step_head(v, mu, cam=cam, robust_delta=robust_delta)
             for g, (_, _, v) in zip(segs, views)]
    totals = _sum_devices(mesh, [part for _, part in heads])
    shapes = _system_shapes(sp.pose_R.shape[0]) + [()]
    outs = []
    for g, (_, _, v), (kept, _), total in zip(segs, views, heads, totals):
        *system, _ = _unfold(total, shapes)
        outs.append(g.step_solve(v, v.pose_R, v.pose_t, v.points, kept, *system, mu,
                                 cam=cam, robust_delta=robust_delta, test=False))
    pose_R, pose_t, _ = outs[0]
    points = _gather_points(mesh, views, [o[2] for o in outs])
    return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), _unfold(
        totals[0], shapes)[-1]


def make_bucketed_ba_step(mesh: Mesh, cam: Camera, mu: float = 1e-4,
                          robust_delta: Optional[float] = None):
    """One damped Gauss-Newton step of the bucketed engine over the mesh:
    step(sharded) -> (sharded', chi2 before the step). One K2 launch per
    shard; (S_half, bp, rhs_corr, chi2) summed in one buffer. One graph a
    step on one device, the head and solve segments per device otherwise."""

    def step(sp: ShardedBucketedBA):
        if _one_graph(mesh):
            pose_R, pose_t, points, chi2 = _bucketed_step_jit(sp, cam=cam, mu=mu,
                                                              robust_delta=robust_delta)
            return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), chi2
        return _bucketed_step_segmented(mesh, sp, cam, mu, robust_delta)

    return step


def make_bucketed_lm_iterate(mesh: Mesh, cam: Camera, num_iters: int = 15,
                             robust_delta: Optional[float] = None, mu0: float = 1e-3):
    """The distributed Nielsen LM loop: iterate(sharded) -> (sharded', chi2,
    accepted count), the protocol of `schur_bucketed.ba_iterate` (gain
    ratio, mu / nu adaptation, rollback on reject). Per iteration: K2 on
    every shard, one sum of (S_half, bp, rhs_corr), the pose solve, the
    landmark updates, K3 on every shard at the candidate, one sum of
    (chi2_c, landmark gain term). Every scalar is computed from summed
    quantities, so every device and process takes the same decisions; no
    host read. The whole loop is one graph on one device (the JAX package's
    one dispatch), the start, head, solve and tail segments per device
    otherwise."""

    def iterate(sp: ShardedBucketedBA):
        if _one_graph(mesh):
            st = _lm_loop_jit(sp, cam=cam, num_iters=num_iters, robust_delta=robust_delta,
                              mu0=mu0)
        else:
            st = _lm_segmented(mesh, sp, cam, num_iters, robust_delta, mu0)
        return sp._replace(pose_R=st.pose_R, pose_t=st.pose_t, points=st.points), st.chi2, \
            st.n_acc

    return iterate


# ----------------------------------------------------------------------
# The graphs. Every problem has its own shapes: each program keeps its
# newest capture only.
# ----------------------------------------------------------------------

_lm_loop_jit = cache.graphed(_lm_loop, static_argnames=("cam", "num_iters", "robust_delta",
                                                        "mu0"), max_entries=1)
_bucketed_step_jit = cache.graphed(_bucketed_step, static_argnames=("cam", "robust_delta"),
                                   max_entries=1)
_flat_step_jit = cache.graphed(_flat_step, static_argnames=("cam", "robust_delta"),
                               max_entries=1)


class _Segments(NamedTuple):
    """One device's segment graphs."""

    start: cache.Graphed
    head: cache.Graphed
    solve: cache.Graphed
    tail: cache.Graphed
    step_head: cache.Graphed
    step_solve: cache.Graphed
    flat_head: cache.Graphed
    flat_solve: cache.Graphed


_SEGMENTS: dict = {}


def _segments(device: torch.device) -> _Segments:
    """The segment graphs of `device`, made at its first use: one instance
    per device, so that each keeps its device's newest capture."""
    segs = _SEGMENTS.get(device)
    if segs is None:
        cam_delta = ("cam", "robust_delta")

        def g(fn, *statics):
            return cache.graphed(fn, static_argnames=statics, max_entries=1)

        segs = _SEGMENTS.setdefault(device, _Segments(
            start=g(_lm_start, *cam_delta), head=g(_lm_head, *cam_delta, "with_chi2"),
            solve=g(_lm_solve, *cam_delta, "test"), tail=g(_lm_tail),
            step_head=g(_step_head, *cam_delta), step_solve=g(_lm_solve, *cam_delta, "test"),
            flat_head=g(_flat_head, *cam_delta), flat_solve=g(_flat_solve)))
    return segs


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
